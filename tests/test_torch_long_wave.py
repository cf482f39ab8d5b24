"""The batcher's first wave on the long route (twilight_tpu_torch/ops/
device_kernel.py, `wave_plan`, `DeviceTalco._plan`): a round's long
launches that fit the device's resident capacity together go out side by
side, each on a stream of the device's pool, and the host steals none of
their pairs; it steals from the tail of the later long launches, and from
every short launch, as before. Everything runs on CPU tensors. A CPU
device runs one launch at a time; where a test wants the capacity of a
card, it gives the batcher one (`DeviceTalco.capacity`)."""
import time

import numpy as np
import pytest
import torch

from twilight_tpu_torch import trace
from twilight_tpu_torch.config import Options
from twilight_tpu_torch.ops import device_kernel as dk

from test_torch_long_counters import PARAM, _DB, _level

torch.set_num_threads(1)

LONG = [(2100, 2080), (2049, 2060)]


def _run(lens, seed, batch, monkeypatch, capacity="cpu", task=1):
    """(results, batcher) of one traced call of a batcher on a CPU device
    with three host threads; `capacity` stands in for a card's."""
    if capacity != "cpu":
        monkeypatch.setattr(dk.DeviceTalco, "capacity",
                            lambda self, q, leaf: capacity)
    prepared, metas = _level(lens, seed)
    opt = Options(device_backend="cpu", type="n", pair_batch=batch,
                  cpu_num=4)
    batcher = dk.DeviceTalco(opt, PARAM, "cpu")
    db = _DB()
    db.current_task = task
    tr = trace.start(True, time.perf_counter_ns())
    try:
        res = batcher(prepared, metas, db, opt, PARAM)
    finally:
        trace.finish(tr, batcher)
    return res, batcher


def _never_ready(monkeypatch):
    """No launch ever reports ready: the host steals all it may."""
    monkeypatch.setattr(dk._Launch, "ready", lambda self: False)


@pytest.fixture(scope="module")
def pinned():
    """LONG through the batcher with TWILIGHT_NO_STEAL: the card's paths."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TWILIGHT_NO_STEAL", "1")
        res, batcher = _run(LONG, 3, 1, mp)
    assert batcher.stats["host_stolen"] == 0
    return res


@pytest.mark.parametrize("batch,capacity", [(2, "cpu"), (1, 2)],
                         ids=["one-launch-cpu", "two-launches-capacity-2"])
def test_first_wave_gives_the_host_no_pair(batch, capacity, monkeypatch,
                                           pinned):
    """Every long launch of the round lies in the first wave: the host
    steals none of its pairs however long the card takes, and the paths
    are those of a batcher that never steals."""
    monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
    _never_ready(monkeypatch)
    res, batcher = _run(LONG, 3, batch, monkeypatch, capacity)
    st = batcher.stats
    assert st["long_launches"] == 2 // batch
    # one stream a launch of the wave: the second made at its first use
    assert len(batcher.pools[0]) == 2 // batch
    assert st["host_stolen"] == 0 and st["count.pairs_long_host"] == 0
    assert st["count.pairs_long_card"] == st["pairs_on_device"] == 2
    assert st["span_ns.batcher.steal_long"] == 0
    for got, want in zip(res, pinned):
        np.testing.assert_array_equal(got, want)


class _Event:
    """A CUDA event stand-in that is, or is not, ready."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        pass


def _fake_card(monkeypatch, done, seen):
    """Launches that align nothing: every pair comes back with error 3 (the
    host ladder decides), behind an event that is or is not ready; `seen`
    gets (chunk, stream) of each."""
    def launch(self, chunk, padlen, prepared, metas, task, leaf, flen,
               xdrop, s=0, q=0):
        b = len(chunk)
        host = torch.zeros(b * 2 * padlen + b * dk.TAIL * 4,
                           dtype=torch.uint8)
        dk.out_views(host, b, padlen)[1][:, 1] = 3
        seen.append((list(chunk), s))
        return dk._Launch(chunk, None, host, _Event(done), padlen, s)

    monkeypatch.setattr(dk.DeviceTalco, "_launch", launch)


def test_later_long_launches_stolen_from_the_tail(monkeypatch):
    """Three one-pair launches on a device that holds two blocks: the
    first two are the first wave, and the host steals the third's pair,
    with the host kernel's path."""
    monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
    seen = []
    _fake_card(monkeypatch, False, seen)
    lens = [(2300, 2290), (2200, 2190), (2100, 2090)]
    res, batcher = _run(lens, 4, 1, monkeypatch, capacity=2)
    st = batcher.stats
    assert seen == [([0], 0), ([1], 1), ([2], 0)]
    assert st["host_stolen"] == st["count.pairs_long_host"] == 1
    assert st["err3_fallbacks"] == 2 and res[:2] == [None, None]
    prepared, metas = _level(lens, 4)
    np.testing.assert_array_equal(
        res[2], batcher._host_align(prepared[2], metas[2], 1))


def test_short_round_steals_as_before(monkeypatch):
    """Short launches are in no wave: under the same hold-back, and a
    capacity that would hold every launch, the host steals every pair."""
    monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
    _never_ready(monkeypatch)
    lens = [(300, 280), (200, 190), (150, 160)]
    res, batcher = _run(lens, 6, 1, monkeypatch, capacity=132)
    st = batcher.stats
    assert all(r is not None for r in res)
    assert st["launches"] == 0 and st["long_launches"] == 0
    assert st["host_stolen"] == 3 and st["pairs_on_device"] == 0
    assert st["count.pairs_long_host"] == 0
    assert st["span_ns.batcher.steal"] > 0


@pytest.mark.parametrize("blocks,capacity,first,streams", [
    # the H100 (132 SMs, one block each) and the freq launches of a
    # 168-pair level: three fit, the pool is ceil(132 / 34) = 4
    ([34, 34, 34, 34, 32], [132] * 5, [True] * 3 + [False] * 2,
     [0, 1, 2, 3, 0]),
    # one launch that nearly fills the card: one stream
    ([128], [132], [True], [0]),
    # 128 then 33 leaf pairs: ceil(132 / 128) = 2 streams
    ([128, 128, 33], [132] * 3, [True, False, False], [0, 1, 0]),
    # launches that fill the card exactly are all in the first wave
    ([66, 66, 1], [132] * 3, [True, True, False], [0, 1, 0]),
    # a launch larger than the card runs in two waves of its own
    ([200, 10], [132] * 2, [False, False], [0, 0]),
    # instances of different capacities share the device
    ([64, 40, 1], [132, 66, 132], [True, False, False], [0, 1, 0]),
    # a CPU device runs one launch at a time
    ([3], [None], [True], [0]),
    ([3, 2, 1], [None] * 3, [True, False, False], [0, 0, 0]),
    ([], [], [], []),
])
def test_wave_plan(blocks, capacity, first, streams):
    assert dk.wave_plan(blocks, capacity) == (first, streams)


@pytest.mark.parametrize("done,capacity,beside,streams", [
    (False, 4, 2, [0, 1, 2]),
    (True, 4, 0, [0, 1, 2]),
    (False, "cpu", 0, [0, 0, 0]),
], ids=["running", "finished", "cpu"])
def test_launches_long_beside(done, capacity, beside, streams, monkeypatch):
    """A long launch issued while an earlier one of the round, on another
    stream, has not finished is counted beside it."""
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    seen = []
    _fake_card(monkeypatch, done, seen)
    res, batcher = _run([(2300, 2290), (2200, 2190), (2100, 2090)], 4, 1,
                        monkeypatch, capacity=capacity, task=0)
    st = batcher.stats
    assert [s for _, s in seen] == streams
    assert st["count.launches_long"] == 3
    assert st["count.launches_long_beside"] == beside
