"""The check behind ``correct`` on a tiny cell served on the CPU: the
reference agrees with the port, and the control and each fault a serving
cell can have come out not correct: a Reuse that returns its state, half
a batch lost, a token altered, positions committed by the lowest
confidence, and twice the schedule's tokens a step."""
import numpy as np
import pytest
import torch

import sb_testing as T
from sbench import check, execute, session, spec


@pytest.fixture
def root(tmp_path):
    return T.make_root(tmp_path)


def test_reference_agrees_with_the_port_in_float32(tmp_path):
    """The float32 port against the float32 reference: every served token
    is the reference's argmax but for rounding."""
    root = T.make_root(tmp_path, T.tiny_config("float32", limit=1e-4))
    out = T.run_tiny(root)
    gap, limit = out["checks"]["logit_gap"]
    assert out["correct"], out["checks"]
    assert gap <= 1e-4
    assert out["checks"]["judged_tokens"][0] >= 32


def test_bf16_program_correct_and_its_control_not(root):
    """The bf16 port passes every limit; the reference at float8 in its
    place comes out not correct by the same decision, on three seeds."""
    cell = spec.load_cell("tiny.cell", root)
    sess = session.Session(cell, 1, torch.device("cpu"))
    wins = [sess.window(s, 30.0) for s in (11, 12, 13)]
    sess.close()
    for w in wins:
        sess.draw(w.seed)
        v = execute.verify(cell, w.run, sess.params, w.seed,
                           lambda *a: None, control=True)
        assert v["correct"], v["checks"]
        assert v["checks"]["schedule_misses"][0] == 0
        assert not v["control_correct"], v["control_checks"]
        ctl = v["control_checks"]
        assert ctl["logit_gap"][0] > ctl["logit_gap"][1]


def _reuse_unchanged(monkeypatch):
    """A Reuse step that returns its state unchanged: the layer stack
    skipped."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "forward_block_packed",
                        lambda stack, cfg, xb, pos, cache, serve: xb)


def _half_the_batch(monkeypatch):
    """Half of each Reuse batch left out, the mean of the rest in its
    place."""
    from repro_torch.models import backbone
    real = backbone.serve_reuse_packed

    def half(params, cfg, flat_tokens, flat_positions, cache, serve):
        h = real(params, cfg, flat_tokens, flat_positions, cache, serve)
        Sb = serve.block_size
        R = h.shape[0] // Sb
        if R < 2:
            return h
        keep = (R // 2) * Sb
        out = h.clone()
        out[keep:] = h[:keep].reshape(-1, Sb, h.shape[1]).mean(0).repeat(
            R - R // 2, 1)
        return out
    monkeypatch.setattr(backbone, "serve_reuse_packed", half)


def _token_altered(monkeypatch):
    """The logit stage's ids altered where they are produced."""
    from repro_torch.models import lm_head
    real = lm_head.decode_tokens_packed

    def altered(params, cfg, h, valid, **kw):
        ids, conf = real(params, cfg, h, valid, **kw)
        return (ids + 1) % (cfg.vocab_size - 1), conf
    monkeypatch.setattr(lm_head, "decode_tokens_packed", altered)


def _least_confident_first(monkeypatch):
    """The logit stage's confidences reversed: each step commits the
    positions it is least confident of."""
    from repro_torch.models import lm_head
    real = lm_head.decode_tokens_packed

    def reversed_conf(params, cfg, h, valid, **kw):
        ids, conf = real(params, cfg, h, valid, **kw)
        return ids, -conf
    monkeypatch.setattr(lm_head, "decode_tokens_packed", reversed_conf)


def _twice_the_schedule(monkeypatch):
    """Twice the schedule's tokens committed a step."""
    from repro_torch.core import diffusion
    real = diffusion.commit_count
    monkeypatch.setattr(diffusion, "commit_count",
                        lambda n, left: min(n, 2 * real(n, left)))


@pytest.mark.parametrize("fault, number", [
    (_reuse_unchanged, "logit_gap"), (_half_the_batch, "logit_gap"),
    (_token_altered, "logit_gap"), (_least_confident_first, "order_regret"),
    (_twice_the_schedule, "schedule_misses")])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault,
                                            number):
    fault(monkeypatch)
    out = T.run_tiny(root)
    assert not out["correct"], out["checks"]
    value, limit = out["checks"][number]
    assert value > limit, out["checks"]


def test_sample_takes_the_longest_and_reaches_the_token_target():
    class R:
        def __init__(self, rid, g):
            self.rid, self.gen_len = rid, g
    done = [R(i, g) for i, g in enumerate([32, 64, 256, 96, 256, 32])]
    picked = check.sample(done, 2 ** 31 + 9, tokens=300, requests=8)
    assert picked[0].gen_len == 256
    assert sum(r.gen_len for r in picked) >= 300
    assert len({r.rid for r in picked}) == len(picked)
    assert check.sample([], 1, 100, 4) == []


def test_check_lines_put_each_number_beside_its_limit():
    checks = {"logit_gap": [0.1, 1.0], "schedule_misses": [0, 0],
              "judged_tokens": [300, 96]}
    assert execute.check_lines(checks) == [
        "check logit_gap 0.1 <= 1.0", "check schedule_misses 0 <= 0",
        "check judged_tokens 300 >= 96"]
    assert check.decide(checks)
    assert not check.decide(dict(checks, schedule_misses=[1, 0]))
    assert not check.decide(dict(checks, judged_tokens=[95, 96]))


def test_order_reads_each_step_against_its_masked_rows():
    # step 0: rows 0-2, row 1 committed but row 0 higher by 0.5; step 1:
    # row 3 committed, the highest; step 2: its one row committed
    lc = np.array([-1.0, -1.5, -3.0, -2.0, -2.5, -4.0])
    step = np.array([0, 0, 0, 1, 1, 2])
    com = np.array([False, True, False, True, False, True])
    got = check.order(lc, step, com, 3)
    assert got == {"regret": pytest.approx(0.25), "widest": 0.5,
                   "share": 0.5}
    pick = check.top_by_step(lc, step, np.array([1, 1, 1]))
    assert pick.tolist() == [True, False, False, True, False, True]
    assert check.order(lc, step, pick, 3)["regret"] == 0.0
