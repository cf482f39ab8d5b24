"""The port's long-sequence route (twilight_tpu_torch/ops/device_kernel.py):
pairs longer than the 2048-column bucket in launches of their own (the
TPU's K4 route), pairs whose retry-ladder width grows past the starting
width in wide launches (K5's work), the MAX_WINDOW cap, the launch byte
budgets, and the packers at long padlens against the JAX package's.
Everything runs on CPU tensors (the kernel's plain version); results are
held to the native host kernel, bit for bit."""
import numpy as np
import pytest
import torch

from twilight_tpu.config import Options, Params
from twilight_tpu.constants import letter_lut
from twilight_tpu.ops import talco_host, talco_np
from twilight_tpu.ops.device_kernel import DeviceTalco as JaxDeviceTalco
from twilight_tpu_torch.ops import device_kernel as dk
from twilight_tpu_torch.ops import talco_cuda

from conftest import random_profile_pair

torch.set_num_threads(1)


def _inverse_lut(type_):
    lut = letter_lut(type_)
    inv = {}
    for ch in range(65, 91):
        inv.setdefault(int(lut[ch]), ch)
    return inv


def _pair(rng, p, rl, ql, param, leaf=False, related=True, num=1):
    """A prepared tuple shaped like aligner._prepare_pair's and its meta.
    Leaf pairs carry unit weights and the scalar gap scores (a raw
    sequence has no gaps to make them position-specific)."""
    if related:
        fr, fq = random_profile_pair(rng, rl, ql, p=p)
    else:
        fr, fq = (np.zeros((n, p), np.float32) for n in (rl, ql))
        fr[np.arange(rl), rng.integers(0, p - 2, rl)] = 1.0
        fq[np.arange(ql), rng.integers(0, p - 2, ql)] = 1.0
    fr, fq = fr * num, fq * num
    if leaf or num == 1:
        go = (np.full(rl, param.gap_open, np.float32),
              np.full(ql, param.gap_open, np.float32))
        ge = (np.full(rl, param.gap_extend, np.float32),
              np.full(ql, param.gap_extend, np.float32))
    else:
        go = (rng.uniform(-60, -40, rl).astype(np.float32),
              rng.uniform(-60, -40, ql).astype(np.float32))
        ge = (rng.uniform(-6, -4, rl).astype(np.float32),
              rng.uniform(-6, -4, ql).astype(np.float32))
    inv = _inverse_lut("n" if p == 6 else "p")
    cons = (np.array([inv[c] for c in fr.argmax(1)], np.uint8),
            np.array([inv[c] for c in fq.argmax(1)], np.uint8))
    return (fr, fq, cons, ([], []), (rl, ql), go, ge), (rl, ql, num, num)


def _host_ladder(prep, meta, task, param, flen0):
    """The reference retry ladder (aligner._run_talco_with_retries) on the
    native host kernel, from a starting width flen0."""
    fr, fq, _, _, lens, go, ge = prep
    zero_gc = task in (1, 2) or meta[2] > 10000 or meta[3] > 10000
    tp = talco_np.TalcoRunParams(
        param.scoring_matrix, param.gap_open, param.gap_extend,
        0.0 if zero_gc else param.gap_extend,
        int(1000 * -1 * param.gap_extend), flen=flen0)
    while True:
        aln, err = talco_host.align_freq(tp, fr[:lens[0]], fq[:lens[1]],
                                         go, ge, (float(meta[2]),
                                                  float(meta[3])))
        if err == 0:
            return aln
        if task == 0:
            return None
        if err == 2:
            tp.flen = min(int(tp.flen * 1.2) << 1, min(lens))
        elif err == 1:
            tp.xdrop = int(tp.xdrop * 2)
            tp.flen = min(int(tp.xdrop * 4) << 1, min(lens))
        else:
            raise AssertionError(f"host kernel error {err}")


def _jax_batcher(type_):
    dt = JaxDeviceTalco.__new__(JaxDeviceTalco)
    dt.option = Options(device_backend="numpy", type=type_)
    dt.param = Params.make(type_)
    dt.base_flen = 1 << 12
    dt.p = 6 if type_ == "n" else 22
    dt.p8 = 8 if type_ == "n" else 24
    dt.grp = 8
    return dt


@pytest.mark.parametrize("p,task", [(6, 0), (6, 1), (22, 0), (22, 1)])
def test_long_pack_equals_jax_packer(p, task):
    """At the 32768 bucket (off 0) the port's freq packer fills the JAX
    packer's arrays exactly; at the launch's own padlen L the port's ref
    block is the JAX block's last L columns and its query block the first
    L."""
    rng = np.random.default_rng(100 + p + task)
    param = Params.make("n" if p == 6 else "p")
    lens = [(2500, 2400), (3100, 2900), (2049, 2300)]
    prepared, metas = zip(*[_pair(rng, p, rl, ql, param, num=1 + t % 3)
                            for t, (rl, ql) in enumerate(lens)])
    chunk = [1, 0, 2]
    flen = [4096, 9000, 4096]
    xdrop = [5000, 20000, 5000]
    jax = _jax_batcher("n" if p == 6 else "p")
    want = jax._pack_batch(chunk, prepared, metas, task, 32768, 512,
                           len(chunk), flen, xdrop, off=0, tot=32768)
    st = dk.pack_batch(chunk, prepared, metas, task, 32768, p, jax.param,
                       flen, xdrop)
    i, f = st.ints.numpy(), st.floats.numpy()
    got = (i[0], i[1], f[0], f[1], i[2], i[3], f[2], f[3], f[4],
           st.ref.numpy(), st.qry.numpy())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    pad = dk.launch_padlen(3100)
    assert pad == 3328
    st = dk.pack_batch(chunk, prepared, metas, task, pad, p, jax.param,
                       flen, xdrop)
    np.testing.assert_array_equal(st.ref.numpy(), want[9][:, :, -pad:])
    np.testing.assert_array_equal(st.qry.numpy(), want[10][:, :, :pad])


@pytest.mark.parametrize("p", [6, 22])
def test_long_leaf_route_equals_freq_route(p):
    """A long raw-sequence pair gives the same bytes through the int8 leaf
    route and the f32 freq route at a long launch padlen."""
    rng = np.random.default_rng(200 + p)
    param = Params.make("n" if p == 6 else "p")
    rl, ql = (2300, 2260) if p == 6 else (2100, 2080)
    prep, meta = _pair(rng, p, rl, ql, param, leaf=True)
    pad = dk.launch_padlen(max(rl, ql))
    mat = torch.from_numpy(param.scoring_matrix.astype(np.float32))
    out = []
    for st in (dk.pack_batch_leaf([0], [prep], [meta], pad, p, param,
                                  [4096], [5000]),
               dk.pack_batch([0], [prep], [meta], 0, pad, p, param,
                             [4096], [5000])):
        # the freq route's gap_char is gap_extend at task 0, as the leaf's
        paths, tail = talco_cuda.talco_align(
            st.ints, st.floats, st.offs, st.ref, st.qry, mat, p=p,
            scratch_bytes=int(st.offs[-1]))
        out.append((paths[0, :int(tail[0, 0])].numpy(), tail[0].numpy()))
    (lp, lt), (fp, ft) = out
    assert lt[1] == 0 and lt[0] > max(rl, ql)
    np.testing.assert_array_equal(lt, ft)
    np.testing.assert_array_equal(lp, fp)
    want = _host_ladder(prep, meta, 0, param, 4096)
    np.testing.assert_array_equal(lp, want)


def test_split_launches_padlen_and_budgets():
    """A long launch's padlen is its longest side rounded up to 256; a
    launch holds at most `batch` pairs and stays within the staging and
    scratch budgets, and a pair over a budget on its own still runs."""
    assert [dk.launch_padlen(m) for m in (1, 2048, 2049, 2304, 2305,
                                          30000, 40000)] \
        == [2048, 2048, 2304, 2304, 2560, 30208, 40192]
    lens = [(30000, 29800), (29000, 29500), (25000, 24000), (3000, 2500)]
    prepared = [(None,) * 4 + (ln,) for ln in lens]
    flen = [4096] * 4
    idxs = [0, 1, 2, 3]
    assert dk.split_launches(idxs, prepared, flen, 8, 4, 128) \
        == [(idxs, 30208)]
    assert dk.split_launches(idxs, prepared, flen, 8, 4, 3) \
        == [([0, 1, 2], 30208), ([3], 3072)]
    # staging: two [B, 8, padlen] f32 blocks
    one = 2 * 8 * 30208 * 4
    assert dk.split_launches(idxs, prepared, flen, 8, 4, 128,
                             staging_budget=2 * one) \
        == [([0, 1], 30208), ([2, 3], 25088)]
    need = [talco_cuda.pair_scratch_bytes(rl, ql, 4096) for rl, ql in lens]
    assert dk.split_launches(idxs, prepared, flen, 8, 4, 128,
                             scratch_budget=need[0] + need[1] - 1) \
        == [([0], 30208), ([1, 2], 29696), ([3], 3072)]
    assert dk.split_launches([0], prepared, flen, 8, 4, 128,
                             staging_budget=1, scratch_budget=1) \
        == [([0], 30208)]


class _DB:
    def __init__(self, task):
        self.current_task = task


def test_batcher_long_and_wide_routes_on_cpu_tensors(monkeypatch, capfd):
    """A task-1 level through the batcher on CPU tensors with a starting
    ladder width of 216 and a MAX_WINDOW of 600 (so that the plain version
    runs them in seconds): a related 2100-column pair (long launch, error
    2, then a long wide launch at width 518 that succeeds), a small pair
    (short launch), an unrelated pair whose width climbs past 600 (host
    wide: None, announced, after one relaunch) and a zero-length pair.
    Results equal the native host kernel's ladder from the same width;
    the route counters say which route each pair took."""
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    rng = np.random.default_rng(9)
    param = Params.make("n")
    opt = Options(device_backend="cpu", type="n", pair_batch=4)
    prepared, metas = zip(*[
        _pair(rng, 6, 2100, 2080, param, num=2),
        _pair(rng, 6, 100, 95, param, num=2),
        _pair(rng, 6, 800, 790, param, related=False, num=2),
        _pair(rng, 6, 50, 40, param, num=2)])
    prepared, metas = list(prepared), list(metas)
    prepared[3] = prepared[3][:4] + ((0, 40),) + prepared[3][5:]
    batcher = dk.DeviceTalco(opt, param, "cpu")
    batcher.base_flen, batcher.max_window = 216, 600
    finals = {}
    res = batcher(prepared, metas, _DB(1), opt, param,
                  on_final=lambda i, p: finals.setdefault(i, p))
    assert set(finals) == {0, 1, 2, 3}
    assert res[2] is None and res[3] is None
    for i in (0, 1):
        np.testing.assert_array_equal(
            res[i], _host_ladder(prepared[i], metas[i], 1, param, 216))
    st = batcher.stats
    assert {k: st[k] for k in ("pairs", "zero_length", "pairs_on_device",
                               "long_launches", "wide_launches",
                               "ladder_relaunches", "host_wide",
                               "host_stolen", "launches")} == {
        "pairs": 4, "zero_length": 1, "pairs_on_device": 2,
        "long_launches": 2, "wide_launches": 2, "ladder_relaunches": 2,
        "host_wide": 1, "host_stolen": 0, "launches": 0}
    assert "1 pairs need a ladder width above 600 columns" \
        in capfd.readouterr().err
