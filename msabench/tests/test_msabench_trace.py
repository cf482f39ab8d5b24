"""Idle share, roofline and idle-gap arithmetic on a synthetic trace."""
import json

import pytest

from msabench import roofline, spec
from msabench.trace import reduce


def _trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_idle_share_and_gaps(tmp_path):
    # two timed runs, 0-1000 us and 2000-3000 us; device work overlapping
    # itself and the gap between the runs
    ev = [{"cat": "user_annotation", "name": "msabench.cli_run#0",
           "ts": 0.0, "dur": 1000.0},
          {"cat": "user_annotation", "name": "msabench.cli_run#1",
           "ts": 2000.0, "dur": 1000.0},
          {"cat": "kernel", "name": "talco_xdrop<6, false>", "ts": 100.0,
           "dur": 200.0},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 250.0,
           "dur": 100.0},
          {"cat": "kernel", "name": "talco_xdrop<6, true>", "ts": 1900.0,
           "dur": 200.0},
          {"cat": "cpu_op", "name": "aten::empty", "ts": 0.0, "dur": 5.0}]
    path = str(tmp_path / "t.json")
    _trace(path, ev)
    # batcher spans on the host clock, 10 s behind the trace's
    out = reduce(path, [10.0, 10.002], [(10.0005, 10.0009)])
    assert out["window_s"] == pytest.approx(2000e-6)
    assert out["busy_s"] == pytest.approx(350e-6)      # 100-350, 2000-2100
    assert out["kernel_s"] == pytest.approx(300e-6)
    rec = {"trace": out}
    idle = spec.reader("device_idle_share")(rec)
    assert idle == pytest.approx(100 * (1 - 350 / 2000))
    gaps = dict((round(s * 1e6), name) for name, s in out["idle_gaps"])
    assert gaps[900] == "host: cli.run outside the batcher"   # 2100-3000
    assert gaps[650] == "host: batcher call"                  # 350-1000
    names = [n for n, _ in out["device_ops"]]
    assert names[0] == "talco_xdrop<6, false>"


def test_roofline_share():
    # 10^9 cells of nt freq pairs: operations bound the time
    ops = roofline.pair_ops(10 ** 9, 6, False)
    nbytes = roofline.pair_bytes(1000, 1000, 1500, 6, False)
    assert nbytes == 2000 * 4 * 8 + 1500 + 16
    rec = {"trace": {"kernel_s": 0.01}, "ops": ops, "bytes": nbytes}
    share = spec.reader("talco_roofline")(rec)
    assert share == pytest.approx(100 * 122e9 / 67e12 / 0.01)
    assert spec.reader("talco_roofline")(
        {"trace": None, "ops": ops, "bytes": nbytes}) is None
    assert spec.reader("talco_roofline")(
        {"trace": {"kernel_s": 0.0}, "ops": ops, "bytes": nbytes}) is None


def test_span_metrics():
    rec = {"align_s": [2.0, 3.0],
           "batcher_spans": [(0, 0.0, 0.5), (0, 0.25, 1.0), (1, 5.0, 5.5)],
           "stats": {"pairs": 110, "zero_length": 10, "pairs_on_device": 75}}
    assert spec.reader("batcher_s")(rec) == pytest.approx(0.75)
    assert spec.reader("pipeline_host_s")(rec) == pytest.approx(1.75)
    assert spec.reader("device_pair_share")(rec) == pytest.approx(75.0)
    assert spec.reader("msa_s")(rec) == pytest.approx(2.5)
