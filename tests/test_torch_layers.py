"""The port's layer primitives against ``repro.models.layers`` on the same
numpy inputs. Both sides compute in float32 on the CPU; 1e-5 covers the
summation-order and transcendental differences between XLA and PyTorch."""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL

ATOL = 1e-5


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    ref = JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    out = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    cr, sr = JL.rope_tables(jnp.asarray(pos), 16, theta)
    ct, st = TL.rope_tables(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cr), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=ATOL)
    ref = JL.apply_rope(jnp.asarray(x), cr, sr)
    out = TL.apply_rope(torch.from_numpy(x), ct, st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gated_mlp_matches_reference(activation):
    """gelu is the tanh form in both (jax.nn.gelu's default)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    ref = JL.gated_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), activation)
    out = TL.gated_mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                       activation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("pattern", ["global", "alt_local_global"])
def test_layer_flags_match_reference(pattern):
    jcfg = dataclasses.replace(jreduced(JARCHS["llada-8b"]),
                               layer_pattern=pattern)
    tcfg = dataclasses.replace(reduced(get_config("llada-8b")),
                               layer_pattern=pattern)
    assert TL.layer_flags(tcfg) == np.asarray(JL.layer_flags(jcfg)).tolist()


def test_configs_match_reference():
    """Same fields and defaults: a config means the same in both packages,
    for every arch the port registers (full and reduced)."""
    from repro.configs.base import ServeConfig as JServe
    from repro_torch.configs import list_archs
    from repro_torch.configs.base import ServeConfig as TServe
    assert {"llada-8b", "qwen2.5-14b", "gemma2-27b", "gemma-2b",
            "qwen2-72b"} <= set(list_archs())
    for arch in list_archs():
        assert dataclasses.asdict(reduced(get_config(arch))) == \
            dataclasses.asdict(jreduced(JARCHS[arch])), arch
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(JARCHS[arch]), arch
        assert get_config(arch).n_params() == JARCHS[arch].n_params(), arch
    assert dataclasses.asdict(TServe()) == dataclasses.asdict(JServe())
