"""The port's training substrate against ``repro.train``: the chunked loss,
three steps of ``make_train_step`` under each gradient compression, the
optimizer's pieces, the reference's trainer contract (``tests/test_train.py``:
loss descent, crash and resume, checkpoints, compression, the data
pipeline, stragglers), a checkpoint the reference's ``Trainer`` wrote,
and the CLI. Shared weights come from ``repro.models.backbone.init_params``
through numpy; the reference's corruption is handed to the port (its
``jax.random`` draws cannot be repeated by a ``torch.Generator``).

Tolerances (float32 on both sides, sums in another order):

* the loss: 1e-5 relative (it agrees to ~1e-7); its gradients: 1e-5 of
  each leaf's largest magnitude (they agree to ~1e-6);
* a train step's loss, ``grad_norm`` and ``lr``: 1e-5 relative;
* ``m`` and ``v`` after three steps: 1e-5 of each leaf's largest
  magnitude without compression; one quantization step of it under
  compression (2^-8 under ``bf16``, 1/127 under ``int8``), since a
  gradient element at a rounding boundary takes the neighbouring code on
  one side (observed: 8.4e-4 and 5.4e-3);
* the parameters after three steps: 0.01·lr absolute without compression
  (observed 0.0022·lr), 0.1·lr under compression (observed 0.025·lr).
  Adam turns a relative difference of a small gradient into one of its
  update, whose scale is lr, so the bound is a fraction of lr.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import synthetic_batch as jsynthetic_batch
from repro.models import backbone as JBB
from repro.models import lm_head as JLM
from repro.train import loss as JL
from repro.train import optimizer as JO
from repro.train import train_loop as JTL
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import Prefetcher, synthetic_batch
from repro_torch.models import layers as TLAYERS
from repro_torch.models import lm_head as TLM
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax, init_params, named_leaves, trainable
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loss as TL
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import Trainer, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
CFG = treduced(get_config("llada-8b"))
TC = TrainConfig(microbatches=2, loss_chunk=64, warmup_steps=3)
DATA = lambda s: synthetic_batch(CFG, 4, 48, s, seed=11)


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _max_rel(a, b):
    """max |a - b| / max |b|."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _shared(arch, **overrides):
    jcfg = reduced(ARCHS[arch], **overrides)
    tcfg = treduced(get_config(arch), **overrides)
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, trainable(from_jax(jax.tree.map(np.asarray, jp),
                                              tcfg, "cpu"))


# (a) the chunked loss --------------------------------------------------------

@pytest.mark.parametrize("arch,chunk", [
    ("llada-8b", 64),         # one chunk (min(chunk, N) = 48 rows)
    ("llada-8b", 16),         # three stride chunks
    ("llada-8b", 20),         # a padded tail: 48 rows -> 60
    ("gemma2-27b", 20),       # tied, softcapped head, padded tail
    ("gemma2-27b", 8)])       # tied, softcapped head, six chunks
def test_diffusion_loss_matches_the_reference(arch, chunk):
    jcfg, tcfg, jp, tp = _shared(arch)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size - 1, (2, 24)).astype(np.int32)
    u = rng.uniform(0.1, 1.0, (2, 1)).astype(np.float32)
    weights = ((rng.random((2, 24)) < u) / u).astype(np.float32)
    f = lambda e, hh: JLM.diffusion_loss(e, jcfg, hh, labels, weights,
                                         chunk=chunk)
    jloss, (jge, jgh) = jax.value_and_grad(f, argnums=(0, 1))(jp["embed"], h)
    ht = torch.tensor(h, requires_grad=True)
    loss = TLM.diffusion_loss(tp["embed"], tcfg, ht, torch.from_numpy(labels),
                              torch.from_numpy(weights), chunk=chunk)
    leaves = [("h", ht)] + [(f"embed.{n}", t)
                            for n, t in tp["embed"].items()]
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True, materialize_grads=True)
    assert abs(loss.item() - float(jloss)) <= RTOL * abs(float(jloss))
    ref = {"h": np.asarray(jgh)}
    ref.update({f"embed.{n}": v for n, v in _flat(jge).items()})
    assert set(ref) == {n for n, _ in leaves}
    for (n, _), g in zip(leaves, grads):
        assert _max_rel(g, ref[n]) <= RTOL, n


# (c) three steps of make_train_step ------------------------------------------

STEP_RTOL = {"none": 1e-5, "bf16": 2.0 ** -8, "int8": 1 / 127}
PARAM_ATOL_LR = {"none": 0.01, "bf16": 0.1, "int8": 0.1}


def _three_steps(monkeypatch, mode, metric_rtol, **overrides):
    """Three steps of the reference's and the port's ``make_train_step``
    on shared weights under the reference's corruption; each step's
    metrics held within ``metric_rtol``. Returns the final (tp, topt, jp,
    jopt, tc)."""
    G, S, M = 4, 16, 2
    kw = dict(microbatches=M, loss_chunk=16, warmup_steps=2,
              grad_compression=mode)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jcfg, tcfg, jp, tp = _shared("llada-8b", **overrides)
    jopt, topt = JO.init_opt_state(jp), TO.init_opt_state(tp)
    jstep = jax.jit(JTL.make_train_step(jcfg, jtc, 20))
    tstep = make_train_step(tcfg, tc, 20)
    # the reference's corruption, microbatch by microbatch, as its step
    # draws it: split the step's key into M, corrupt each microbatch
    given = []
    monkeypatch.setattr(TL, "corrupt", lambda *a: given.pop(0))
    key = jax.random.PRNGKey(5)
    for s in range(3):
        key, sub = jax.random.split(key)
        tokens = jsynthetic_batch(jcfg, G, S, s, seed=2)
        for mb, r in zip(tokens.reshape(M, G // M, S),
                         jax.random.split(sub, M)):
            c, w = JL.corrupt(jnp.asarray(mb), r, jcfg, jtc)
            given.append((torch.from_numpy(np.array(c)),
                           torch.from_numpy(np.array(w))))
        jp, jopt, jm = jstep(jp, jopt, tokens, sub)
        tp, topt, tm = tstep(tp, topt, torch.from_numpy(tokens), None)
        assert not given
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        for k in jm:
            assert abs(tm[k].item() - float(jm[k])) <= \
                metric_rtol * abs(float(jm[k])), (s, k)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    return tp, topt, jp, jopt, tc


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_train_step_matches_the_reference(mode, monkeypatch):
    tp, topt, jp, jopt, tc = _three_steps(monkeypatch, mode, RTOL)
    jf, jmf, jvf = _flat(jp), _flat(jopt["m"]), _flat(jopt["v"])
    lr = tc.learning_rate
    for n, t in named_leaves(tp):
        assert _max_rel(topt["m"][n], jmf[n]) <= STEP_RTOL[mode], n
        assert _max_rel(topt["v"][n], jvf[n]) <= STEP_RTOL[mode], n
        assert np.abs(t.detach().numpy() - jf[n]).max() <= \
            PARAM_ATOL_LR[mode] * lr, n


def test_bfloat16_train_step_tracks_the_reference(monkeypatch):
    """bfloat16 weights, as the card trains at full width. Both sides round
    every op to bfloat16 in their own order, so: the step's loss,
    grad_norm and lr within 2^-8 relative (bfloat16's unit roundoff; 8.4e-4
    seen); m and v within 2^-6 of each leaf's largest magnitude (four
    roundoffs through the layers; 7.4e-3 seen); parameters within 6·lr (a
    gradient near zero whose sign the roundings flip moves its weight by
    up to 2·lr a step the other way; 3.4·lr seen)."""
    tp, topt, jp, jopt, tc = _three_steps(monkeypatch, "none", 2.0 ** -8,
                                          dtype="bfloat16")
    jf, jmf, jvf = _flat(jp), _flat(jopt["m"]), _flat(jopt["v"])
    for n, t in named_leaves(tp):
        assert t.dtype == torch.bfloat16 and jf[n].dtype == jnp.bfloat16, n
        assert _max_rel(topt["m"][n], jmf[n]) <= 2.0 ** -6, n
        assert _max_rel(topt["v"][n], jvf[n]) <= 2.0 ** -6, n
        assert np.abs(t.detach().float().numpy()
                      - jf[n].astype(np.float32)).max() <= \
            6 * tc.learning_rate, n


# (d) the optimizer's pieces --------------------------------------------------

def test_lr_schedule_matches_the_reference():
    for tc_kw in (dict(warmup_steps=3), dict(warmup_steps=0)):
        jtc, tc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
        for s in range(0, 45, 3):
            want = float(JO.lr_schedule(jnp.int32(s), jtc, 40))
            got = TO.lr_schedule(torch.tensor(s, dtype=torch.int32), tc, 40)
            assert abs(got.item() - want) <= 1e-6 * max(want, 1e-12), s


def _grads(seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc
            for s, sc in (((8, 8), 0.3), ((5,), 2.0), ((3, 4, 2), 1e-4))]


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _grads()
    jg, jn = JO.clip_by_global_norm(g, max_norm)
    tg, tn = TO.clip_by_global_norm([torch.from_numpy(x) for x in g],
                                    max_norm)
    assert abs(tn.item() - float(jn)) <= RTOL * float(jn)
    for a, b in zip(tg, jg):
        assert _max_rel(a, np.asarray(b)) <= RTOL


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_grads_matches_the_reference(mode):
    """Equal to the reference's codec, and (its own test) within 5% of the
    uncompressed norm."""
    g = _grads()
    jc = JO.compress_grads([jnp.asarray(x) for x in g], mode)
    tc = TO.compress_grads([torch.from_numpy(x) for x in g], mode)
    for a, b in zip(tc, jc):
        assert a.dtype == (torch.bfloat16 if mode == "bf16"
                           else torch.float32)
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b).astype(np.float32))
    err = TO.global_norm([torch.from_numpy(x) - y.float()
                          for x, y in zip(g, tc)]).item()
    base = TO.global_norm([torch.from_numpy(x) for x in g]).item()
    assert err <= (0.05 * base if mode != "none" else 1e-9)


def test_corrupt_law():
    """Per-sequence ratio u ~ U(lo, hi), tokens masked i.i.d. with
    probability u, weights mask / u (statistically, on 64 sequences of
    4096 tokens)."""
    tc = TrainConfig(mask_ratio_min=0.2, mask_ratio_max=0.6)
    tokens = torch.zeros((64, 4096), dtype=torch.int32)
    corrupted, w = TL.corrupt(tokens, torch.Generator().manual_seed(0),
                              CFG, tc)
    mask = corrupted == CFG.vocab_size - 1
    assert torch.equal(corrupted[~mask], tokens[~mask])
    rate = mask.float().mean(dim=1)
    assert rate.min() > 0.2 - 0.03 and rate.max() < 0.6 + 0.03
    assert 0.4 - 0.05 < rate.mean() < 0.4 + 0.05
    assert rate.std() > 0.08          # U(0.2, 0.6) has sd 0.115
    u = (mask.float() / w.clamp_min(1e-30)).amax(dim=1)   # u where masked
    assert torch.all((w == 0) == ~mask)
    assert torch.allclose(u, rate, atol=0.04)
    assert w[mask].min() > 1 / 0.6 - 1e-5 and w[mask].max() < 1 / 0.2 + 1e-5


def test_serving_forward_records_nothing_for_backward(monkeypatch):
    """The serving entries run frozen parameters with autograd on: the
    attention and the layers take no checkpoint there, so they trace the
    ops they traced before training was ported."""
    def refuse(*a, **k):
        raise AssertionError("checkpoint on a serving path")
    monkeypatch.setattr(TLAYERS, "checkpoint", refuse)
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 12, CFG.d_model)
    pos = torch.arange(12).expand(2, 12)
    h, _, _ = TT.forward_full(params["stack"], CFG, x, pos)
    assert h.shape == x.shape and not h.requires_grad


# (e) the reference's trainer contract ----------------------------------------

def test_loss_decreases():
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, TC, d, 4, 48, total_steps=40, ckpt_every=50,
                     device="cpu")
        logs = tr.run(10, DATA)
        assert logs[-1]["loss"] < logs[0]["loss"]
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                   for m in logs)


def test_crash_resume_continuity():
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, TC, d, 4, 48, total_steps=40, ckpt_every=4,
                     device="cpu")
        tr.run(8, DATA)
        with pytest.raises(RuntimeError, match="simulated node failure"):
            tr.run(8, DATA, crash_at=tr.start_step + 2)
        tr2 = Trainer(CFG, TC, d, 4, 48, total_steps=40, ckpt_every=4,
                      device="cpu")
        assert tr2.start_step == 8   # resumed at the last checkpoint
        assert tr2.events.restarts == 1
        logs = tr2.run(4, DATA)
        assert np.isfinite(logs[-1]["loss"])


def test_checkpoint_roundtrip_exact():
    with tempfile.TemporaryDirectory() as d:
        state = {"params.w": torch.arange(12.0).reshape(3, 4),
                 "params.h": torch.randn(5, 3).to(torch.bfloat16),
                 "opt.m.w": torch.ones(3, 4) * 0.5,
                 "opt.step": torch.tensor(7, dtype=torch.int32)}
        t = ckpt.save(d, 3, state, async_io=False)
        assert t is None
        step, restored = ckpt.restore(d)
        assert step == 3 and set(restored) == set(state)
        for n, v in state.items():
            assert restored[n].dtype == v.dtype and torch.equal(restored[n], v)
        with open(os.path.join(d, "ckpt_00000003", "manifest.json")) as f:
            names = json.load(f)["names"]
        assert names == ["opt.m.w", "opt.step", "params.h", "params.w"]


def test_async_checkpoint_holds_the_step_it_saved(monkeypatch):
    """The writer thread is held until the next step has updated the
    parameters and moments in place: the checkpoint still holds the state
    of the step it was taken at."""
    gate = threading.Event()
    np_save = np.save

    def held(*args, **kwargs):
        assert gate.wait(60)
        np_save(*args, **kwargs)

    monkeypatch.setattr(ckpt.np, "save", held)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, TC, d, 4, 48, total_steps=40, ckpt_every=2,
                     device="cpu")
        at_save = {}

        def data(s):
            if s == 2:      # step 2's checkpoint is being written
                at_save.update({n: t.detach().clone()
                                for n, t in tr.state().items()})
            if s == 3:      # step 3 has run: release the writer
                gate.set()
            return DATA(s)

        tr.run(4, data)
        step, restored = ckpt.restore(d, step=2, like=tr.state())
        assert step == 2 and set(restored) == set(at_save)
        moved = [n for n, t in tr.state().items()
                 if not torch.equal(t.detach(), at_save[n])]
        assert "opt.step" in moved and len(moved) > 1
        for n, t in at_save.items():
            assert torch.equal(restored[n], t), n


def test_checkpoint_gc_and_atomicity():
    with tempfile.TemporaryDirectory() as d:
        for s in range(6):
            ckpt.save(d, s, {"x": torch.zeros(2)}, keep=2, async_io=False)
        names = sorted(os.listdir(d))
        assert names == ["ckpt_00000004", "ckpt_00000005"]
        assert not any(n.endswith(".tmp") for n in names)
        assert ckpt.latest_step(d) == 5
        # a save cut before its rename leaves a .tmp, which is no checkpoint
        os.makedirs(os.path.join(d, "ckpt_00000009.tmp"))
        assert ckpt.latest_step(d) == 5
        assert ckpt.restore(d)[0] == 5


def test_compressed_training_descends():
    tc = TrainConfig(microbatches=2, loss_chunk=64, warmup_steps=3,
                     grad_compression="bf16")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, tc, d, 4, 48, total_steps=40, ckpt_every=50,
                     device="cpu")
        logs = tr.run(8, DATA)
        assert logs[-1]["loss"] < logs[0]["loss"]


def test_pipeline_determinism_and_prefetch():
    a = synthetic_batch(CFG, 4, 32, step=5, seed=3)
    b = synthetic_batch(CFG, 4, 32, step=5, seed=3)
    c = synthetic_batch(CFG, 4, 32, step=6, seed=3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.max() < CFG.vocab_size - 1   # mask id never in data
    ref = jsynthetic_batch(reduced(ARCHS["llada-8b"]), 4, 32, step=5, seed=3)
    assert a.dtype == ref.dtype and a.tobytes() == ref.tobytes()
    pf = Prefetcher(lambda s: synthetic_batch(CFG, 2, 16, s, seed=1),
                    start_step=0, depth=2)
    try:
        x0 = next(pf)
        assert np.array_equal(x0, synthetic_batch(CFG, 2, 16, 0, seed=1))
    finally:
        pf.close()


def test_straggler_detection():
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(CFG, TC, d, 4, 48, total_steps=40, ckpt_every=50,
                     straggler_factor=2.5, device="cpu")
        slow = {"hit": False}

        def data(s):
            if s == 8 and not slow["hit"]:
                slow["hit"] = True
                time.sleep(1.0)      # simulated slow node
            return DATA(s)

        tr.run(10, data)
        assert any(e["step"] == 8 for e in tr.events.stragglers)


# (f) a checkpoint of the reference's Trainer ---------------------------------

def test_reference_checkpoint_restores_into_the_port():
    jcfg = reduced(ARCHS["llada-8b"])
    jtc = JTrainConfig(microbatches=2, loss_chunk=64, warmup_steps=3)
    with tempfile.TemporaryDirectory() as d:
        jtr = JTL.Trainer(jcfg, jtc, d, 4, 48, total_steps=40, ckpt_every=2)
        jtr.run(2, lambda s: jsynthetic_batch(jcfg, 4, 48, s, seed=11))
        tr = Trainer(CFG, TC, d, 4, 48, total_steps=40, ckpt_every=50,
                     device="cpu")
        assert tr.start_step == 2 and tr.events.restarts == 1
        want = {f"params.{n}": v for n, v in _flat(jtr.params).items()}
        for k in ("m", "v"):
            want.update({f"opt.{k}.{n}": v
                         for n, v in _flat(jtr.opt[k]).items()})
        want["opt.step"] = np.asarray(jtr.opt["step"])
        got = tr.state()
        assert set(got) == set(want)
        for n, v in want.items():
            assert np.array_equal(got[n].detach().numpy(), v), n
        logs = tr.run(1, DATA)
        assert np.isfinite(logs[0]["loss"])


# (g) the CLI -----------------------------------------------------------------

def test_cli_prints_the_reference_keys():
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--steps", "3", "--ckpt-every", "2", "--seq-len", "32",
             "--ckpt-dir", d], env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert set(res) == {"final_loss", "steps", "stragglers",
                            "checkpoints"}
        assert res["steps"] == 3 and res["checkpoints"] == 1
        assert np.isfinite(res["final_loss"])
        assert ckpt.latest_step(d) == 2
