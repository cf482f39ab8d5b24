"""The port's graft entry (twilight_tpu_torch/graft_entry.py) on the CPU:
the one-launch TALCO step equals the JAX package's jitted
`__graft_entry__.entry()` bit for bit, and the multi-device dry run of the
production batcher (DeviceTalco on CPU devices, the kernel's plain
version) takes every route on every device and equals the NumPy oracle on
every pair. The starting ladder width is lowered to 1024 so that the
plain version runs the ladder pair in seconds (tests/test_torch_long.py
lowers it likewise); the long pairs' bands need about 750 columns."""
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from twilight_tpu_torch import graft_entry
from twilight_tpu_torch.ops import talco_cuda

torch.set_num_threads(1)

BASE_FLEN = 1024


def test_entry_cpu_equals_jax_entry(monkeypatch):
    import jax
    launches = []
    real = talco_cuda.talco_align

    def spy(*args, **kw):
        launches.append(args[3].shape)
        return real(*args, **kw)

    monkeypatch.setattr(talco_cuda, "talco_align", spy)
    step, args = graft_entry.entry("cpu")
    assert dict(step.named_buffers())["matrix"].shape == (6, 6)
    paths, tail = step(*args)
    assert launches == [(4, 8, 256)]
    fn, jargs = jax_entry.entry()
    jout, jlens, jerrs = (np.asarray(o) for o in jax.jit(fn)(*jargs))
    tail = tail.numpy()
    assert tail[:, 0].tolist() == jlens.tolist() == [192] * 4
    assert tail[:, 1].tolist() == jerrs.tolist() == [0] * 4
    for i in range(4):
        np.testing.assert_array_equal(paths[i, :192].numpy(),
                                      jout[i, :192])


def test_example_batch_is_the_jax_example():
    """The same draws as __graft_entry__._example_batch, packed by the
    port's packer: the ref reversed and right-aligned at padlen 256, the
    query left-aligned, no FLEN padding."""
    rr, qq, gor, goq, ger, geq = jax_entry._example_batch(4, 256, 256)[:6]
    ints, floats, offs, ref, qry = (t.numpy() for t in
                                    graft_entry._example_batch())
    # the JAX packer's ref is reversed already, right-aligned at FLEN +
    # padlen; its query starts at FLEN
    r, q = slice(256 + 64, 512), slice(256, 256 + 192)
    for i in range(4):
        np.testing.assert_array_equal(ref[i, :6, 64:], rr[i, r].T)
        np.testing.assert_array_equal(qry[i, :6, :192], qq[i, q].T)
        np.testing.assert_array_equal(ref[i, 6:, 64:], [gor[i, r],
                                                        ger[i, r]])
        np.testing.assert_array_equal(qry[i, 6:, :192], [goq[i, q],
                                                         geq[i, q]])
        assert not ref[i, :, :64].any() and not qry[i, :, 192:].any()
    assert ints.tolist() == [[192] * 4, [192] * 4, [256] * 4, [5000] * 4]
    assert floats.tolist() == [[1.0] * 4, [1.0] * 4, [-5.0] * 4,
                               [-50.0] * 4, [-5.0] * 4]
    assert int(offs[0]) == 0 and offs.shape == (5,)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_dryrun_without_enough_cards_raises_naming_the_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 2 distinct CUDA devices, "
                                           "have 0"):
        graft_entry.dryrun_multichip(2)


def check_dryrun(n, monkeypatch):
    """dryrun_multichip over n CPU devices, the oracle on two worker
    processes: every route, every device, nothing stolen, the environment
    untouched."""
    monkeypatch.delenv("TWILIGHT_NO_STEAL", raising=False)
    with ProcessPoolExecutor(2, mp_context=get_context("spawn")) as pool:
        res = graft_entry.dryrun_multichip(n, ["cpu"] * n,
                                           base_flen=BASE_FLEN, pool=pool)
    assert "TWILIGHT_NO_STEAL" not in os.environ
    st = res["stats"]
    assert res["pairs"] == {"freq": 2 * n, "leaf": n, "long": n,
                            "ladder": 1}
    assert st["pairs_on_device"] == st["pairs"] == 4 * n + 1
    assert st["host_stolen"] == 0 and st["launches"] == 0
    assert len(st["launches_by_device"]) == n
    assert all(st["launches_by_device"])
    assert st["leaf_launches"] == n    # one leaf pair a device
    assert st["long_launches"] >= 1 and st["wide_launches"] == 1
    assert st["ladder_relaunches"] == 1
    assert res["base_flen"] == BASE_FLEN


def test_dryrun_multichip_on_two_cpu_devices(monkeypatch):
    check_dryrun(2, monkeypatch)


def test_dryrun_raises_on_a_flipped_byte(monkeypatch):
    """The plain version's first path with one byte flipped: the dry run
    names the pair that differs from the oracle. (The dry run's short
    freq pairs only, so that it stops in seconds.)"""
    real_pairs = graft_entry._dryrun_pairs
    monkeypatch.setattr(
        graft_entry, "_dryrun_pairs",
        lambda n, base_flen: [real_pairs(n, base_flen)[0][:2 * n], []])
    real = talco_cuda.talco_align_reference
    flipped = []

    def flip(*args, **kw):
        paths, tail = real(*args, **kw)
        if not flipped:
            flipped.append(int(tail[0, 0]))
            paths[0, 0] = 1 - paths[0, 0]
        return paths, tail

    monkeypatch.setattr(talco_cuda, "talco_align_reference", flip)
    with pytest.raises(AssertionError, match=r"pair \d+ \(freq, .*differs "
                                             "from the oracle"):
        graft_entry.dryrun_multichip(1, ["cpu"], base_flen=BASE_FLEN)
    assert flipped and flipped[0] > 0
    assert "TWILIGHT_NO_STEAL" not in os.environ
