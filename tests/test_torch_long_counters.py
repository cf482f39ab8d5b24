"""The batcher's counters of the long route (twilight_tpu_torch/ops/
device_kernel.py, `trace.COUNTS`): long launches and the pairs in them,
and who gave each long pair its final result, the card or the host that
stole it (whose DP is the span `batcher.steal_long`). Everything runs on
CPU tensors (the kernel's plain version) under the run's tracer; with the
tracer off nothing is recorded."""
import time

import numpy as np
import pytest
import torch

from twilight_tpu_torch import trace
from twilight_tpu_torch.config import Options, Params
from twilight_tpu_torch.ops import device_kernel as dk

from conftest import random_profile_pair

torch.set_num_threads(1)

LONG = ("launches_long", "pairs_long_launched", "pairs_long_card",
        "pairs_long_host")
PARAM = Params.make("n")


class _DB:
    current_task = 1


def _level(lens, seed):
    """Prepared tuples and metas of related two-sequence profile pairs
    with scalar gap scores, shaped like aligner._prepare_pair's."""
    rng = np.random.default_rng(seed)
    prepared, metas = [], []
    for rl, ql in lens:
        fr, fq = random_profile_pair(rng, rl, ql, p=6)
        go = (np.full(rl, PARAM.gap_open, np.float32),
              np.full(ql, PARAM.gap_open, np.float32))
        ge = (np.full(rl, PARAM.gap_extend, np.float32),
              np.full(ql, PARAM.gap_extend, np.float32))
        cons = (np.zeros(rl, np.uint8), np.zeros(ql, np.uint8))
        prepared.append((fr * 2, fq * 2, cons, ([], []), (rl, ql), go, ge))
        metas.append((rl, ql, 2, 2))
    return prepared, metas


def _run(lens, seed, on=True):
    """(results, batcher, tracer) of one call of a batcher that launches
    one pair at a time and steals on the calling thread alone."""
    prepared, metas = _level(lens, seed)
    opt = Options(device_backend="cpu", type="n", pair_batch=1, cpu_num=1)
    batcher = dk.DeviceTalco(opt, PARAM, "cpu")
    tr = trace.start(on, time.perf_counter_ns())
    try:
        res = batcher(prepared, metas, _DB(), opt, PARAM)
    finally:
        trace.finish(tr, batcher)
    return res, batcher, tr


def _hold_back(monkeypatch, held):
    """The launch of pair `held` never reports ready, so the calling
    thread steals that pair while the others are collected."""
    monkeypatch.setattr(dk._Launch, "ready",
                        lambda self: held not in self.chunk)


@pytest.mark.parametrize("steal", [False, True])
def test_long_pairs_counted_card_or_host(steal, monkeypatch):
    lens = [(2300, 2260), (2049, 2080)]
    if steal:
        monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
        _hold_back(monkeypatch, 1)
    else:
        monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    res, batcher, tr = _run(lens, 5)
    st = batcher.stats
    assert all(r is not None for r in res)
    assert st["count.launches_long"] == st["long_launches"] == 2
    assert st["count.pairs_long_launched"] == 2
    assert st["count.pairs_long_card"] + st["count.pairs_long_host"] \
        == len(lens)
    assert st["count.pairs_long_card"] == st["pairs_on_device"]
    assert st["count.pairs_long_host"] == st["host_stolen"] == int(steal)
    steals = [s.name for s in tr.records if "steal" in s.name]
    assert steals == ["batcher.steal_long"] * int(steal)
    assert (st["span_ns.batcher.steal_long"] > 0) == steal
    assert st["span_ns.batcher.steal"] == 0
    if steal:
        # the host's result is the card's, bit for bit
        monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
        card, _, _ = _run(lens, 5)
        for a, b in zip(res, card):
            np.testing.assert_array_equal(a, b)


def test_short_pairs_leave_long_counters_at_zero(monkeypatch):
    monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
    _hold_back(monkeypatch, 1)
    res, batcher, tr = _run([(300, 280), (200, 190), (150, 160)], 6)
    st = batcher.stats
    assert all(r is not None for r in res)
    assert st["long_launches"] == 0 and st["host_stolen"] == 1
    assert all(st[f"count.{k}"] == 0 for k in LONG)
    assert st["span_ns.batcher.steal_long"] == 0
    assert st["span_ns.batcher.steal"] > 0
    assert "batcher.steal_long" not in {s.name for s in tr.records}


def test_tracer_off_records_nothing(monkeypatch):
    """The held-back pair is in the second launch: the host may steal it
    (the first launch is the first wave)."""
    monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
    _hold_back(monkeypatch, 1)
    res, batcher, tr = _run([(2100, 2090), (2060, 2049)], 7, on=False)
    st = batcher.stats
    assert all(r is not None for r in res) and st["host_stolen"] == 1
    assert st["long_launches"] == 2
    assert not tr.on and tr.records == [] and tr.counts == {}
    assert not [k for k in st if k.startswith(("span_ns.", "count."))]
