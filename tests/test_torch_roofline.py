"""The port's roofline against the reference's.

* ``analytic_cost`` and ``components`` equal ``repro.roofline.flops``'s
  exactly (float equality: the same arithmetic) for every assigned arch ×
  shape × ``(dp, tp)`` in {(16, 16), (32, 16)} × ``flash_refresh``.
* ``SHAPES``, ``SHAPES_BY_NAME`` and ``ASSIGNED`` equal the reference's.
* ``Roofline``'s derived terms on a hand-computed record (relative
  tolerance 1e-12), with the H100's peaks; ``save_records`` round-trips.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import json

import pytest

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.roofline import flops as JF
from repro_torch.configs import (ASSIGNED, SHAPES, SHAPES_BY_NAME,
                                 get_config)
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import flops as TF

GRID = [(dp, tp, fr) for dp, tp in ((16, 16), (32, 16))
        for fr in (False, True)]


def test_shapes_and_assigned_match_reference():
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(s) for s in JSHAPES]
    assert [s.tokens for s in SHAPES] == [s.tokens for s in JSHAPES]
    assert list(SHAPES_BY_NAME) == [s.name for s in JSHAPES]
    assert ASSIGNED == JASSIGNED


@pytest.mark.parametrize("shape", [s.name for s in JSHAPES])
@pytest.mark.parametrize("arch", JASSIGNED)
def test_analytic_cost_equals_reference(arch, shape):
    jshape = next(s for s in JSHAPES if s.name == shape)
    for dp, tp, fr in GRID:
        kw = dict(dp=dp, tp=tp, retention=0.5, microbatches=8, remat=True,
                  q_chunk=1024, flash_refresh=fr)
        want = JF.analytic_cost(jget_config(arch), jshape, **kw)
        got = TF.analytic_cost(get_config(arch), SHAPES_BY_NAME[shape], **kw)
        assert got == want, (dp, tp, fr)
        wc = JF.components(jget_config(arch), jshape, **kw)
        gc = TF.components(get_config(arch), SHAPES_BY_NAME[shape], **kw)
        assert [dataclasses.asdict(c) for c in gc] == \
            [dataclasses.asdict(c) for c in wc]


def _record():
    return RA.Roofline(
        name="hand", chips=4, flops_per_device=989e12 * 2e-3,
        bytes_per_device=3.35e12 * 5e-3, coll_bytes_per_device=450e9 * 1e-3,
        coll_breakdown={"all-reduce": int(450e9 * 1e-3)},
        model_flops=4 * 989e12 * 1e-3, counted_flops_per_device=989e12 * 1e-3)


def test_h100_peaks():
    assert (RA.PEAK_FLOPS, RA.PEAK_FLOPS_F32, RA.HBM_BW, RA.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


def test_roofline_terms_by_hand():
    r = _record()
    assert r.t_compute == pytest.approx(2e-3, rel=1e-12)
    assert r.t_memory == pytest.approx(5e-3, rel=1e-12)
    assert r.t_collective == pytest.approx(1e-3, rel=1e-12)
    assert r.bottleneck == "memory"
    assert r.step_time == pytest.approx(5e-3, rel=1e-12)
    # model FLOPs 4 chips x 1 ms of peak; the record's FLOPs are 2 ms each
    assert r.useful_flops_ratio == pytest.approx(0.5, rel=1e-12)
    # at the 5 ms roofline step: 1 ms of peak work each
    assert r.mfu == pytest.approx(0.2, rel=1e-12)
    assert r.counted_to_analytic == pytest.approx(0.5, rel=1e-12)
    d = r.to_dict()
    for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
              "step_time", "mfu", "useful_flops_ratio",
              "counted_flops_per_device", "coll_breakdown",
              "temp_bytes_per_device", "arg_bytes_per_device"):
        assert k in d, k
    assert "hlo_flops_raw" not in d
    assert "[memory    ]" in r.row()


def test_analyze_meta_takes_the_analytic_terms():
    analytic = {"flops_per_device": 10.0, "bytes_per_device": 20.0,
                "top_components": [{"name": "ffn"}]}
    r = RA.analyze_meta("c", 2, 5.0, analytic, {"all-gather": 3,
                                                "all-reduce": 4}, 7, 9, 12.0)
    assert (r.flops_per_device, r.bytes_per_device,
            r.coll_bytes_per_device) == (10.0, 20.0, 7.0)
    assert (r.arg_bytes_per_device, r.temp_bytes_per_device,
            r.counted_flops_per_device) == (7, 9, 12.0)
    assert r.top_components == [{"name": "ffn"}]


def test_save_records_round_trips(tmp_path):
    path = tmp_path / "r.json"
    recs = [_record(), {"arch": "x", "ok": False}]
    RA.save_records(str(path), recs)
    back = json.loads(path.read_text())
    assert back[0] == json.loads(json.dumps(recs[0].to_dict()))
    assert back[1] == recs[1]
