"""The benchmark's traffic: the frozen generator draws what the program's
does, and a mix gives every seed the same work."""
import numpy as np
import pytest

from repro_torch.data import workloads as W
from sbench import traffic

GEOM = dict(vocab_size=126464, block_size=32, max_seq_len=2048)


@pytest.mark.parametrize("name", ["livebench", "burst", "osc"])
@pytest.mark.parametrize("seed", [0, 29001, 2 ** 31 + 3])
def test_frozen_copy_draws_what_the_program_draws(name, seed):
    ours = traffic.make_trace(name, 40, 0.7, seed=seed, scale=0.5)
    theirs = W.make_trace(name, 40, 0.7, seed=seed, scale=0.5)
    assert [(t.arrival, t.prompt_len, t.gen_len) for t in ours] == \
        [(t.arrival, t.prompt_len, t.gen_len) for t in theirs]


MIX = {"generator": "livebench", "mix_seed": 5, "scale": 1.0,
       "arrivals": "rate", "rps": 0.6, "fresh": 30, "residents": 24}


def test_residents_fit_and_spread_over_every_block():
    reqs = traffic.build(MIX, 2 ** 31 + 17, slots=36, **GEOM)
    res = [r for r in reqs if r.resident]
    assert len(res) == 24 and all(r.due == 0.0 for r in res)
    for r in reqs:
        assert len(r.prompt) + r.gen_len <= GEOM["max_seq_len"]
        assert r.gen_len % GEOM["block_size"] == 0
        assert r.prompt.max() < GEOM["vocab_size"] - 1
    for r in res:
        assert r.gen_len == 256 - 32 * r.k
    assert sorted({r.k for r in res}) == list(range(8))
    assert max(np.bincount([r.k for r in res])) == 3


def test_every_seed_gets_the_same_work_in_the_same_order():
    a = traffic.build(MIX, 1, slots=36, **GEOM)
    b = traffic.build(MIX, 2 ** 31 + 99, slots=36, **GEOM)
    key = lambda rs: [(len(r.prompt), r.gen_len, r.resident, r.k, r.due)  # noqa: E731
                      for r in rs]
    assert key(a) == key(b)
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = traffic.build(MIX, 1, slots=36, **GEOM)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    assert [r.k for r in a if r.resident] != sorted(
        r.k for r in a if r.resident)


def test_slots_residents_and_backlog():
    mix = dict(MIX, residents="slots", arrivals="backlog")
    reqs = traffic.build(mix, 3, slots=36, **GEOM)
    assert sum(r.resident for r in reqs) == 36
    assert all(r.due == 0.0 for r in reqs)
    assert [r.rid for r in reqs] == list(range(len(reqs)))
