"""The port's batcher (twilight_tpu_torch/ops/device_kernel.py) against the
JAX package's DeviceTalco: identical packed arrays, the leaf predicate,
the padlen buckets, the retry ladder on the kernel's output, the device
selection rules, and a CPU-tensor batcher run equal to the host kernel."""
import numpy as np
import pytest
import torch

from twilight_tpu.config import Options, Params
from twilight_tpu.constants import letter_lut
from twilight_tpu.ops.device_kernel import DeviceTalco as JaxDeviceTalco
from twilight_tpu_torch.ops import device_kernel as dk
from twilight_tpu_torch.ops import talco_cuda

from conftest import random_profile_pair

torch.set_num_threads(1)


def _jax_batcher(type_):
    """DeviceTalco built through __new__ (no jax device), as
    tests/test_leaf_pack.py does."""
    dt = JaxDeviceTalco.__new__(JaxDeviceTalco)
    dt.option = Options(device_backend="numpy", type=type_)
    dt.param = Params.make(type_)
    dt.base_flen = 1 << 12
    dt.p = 6 if type_ == "n" else 22
    dt.p8 = 8 if type_ == "n" else 24
    dt.grp = 8
    return dt


def _jax_order(st):
    """A Staging's arrays in DeviceTalco._pack_batch's order: ref_len,
    qry_len, ref_num, qry_num, flen, xdrop, gap_char, gap_open,
    gap_extend, ref, qry."""
    i, f = st.ints.numpy(), st.floats.numpy()
    return (i[0], i[1], f[0], f[1], i[2], i[3], f[2], f[3], f[4],
            st.ref.numpy(), st.qry.numpy())


def _prepared(rng, p, n, lens=None):
    """Prepared tuples shaped like aligner._prepare_pair's: profiles,
    consensus letters, gappy lists, lengths, position-specific gaps."""
    type_ = "n" if p == 6 else "p"
    lut = letter_lut(type_)
    inv = {}
    for ch in range(65, 91):
        inv.setdefault(int(lut[ch]), ch)
    prepared, metas = [], []
    for t in range(n):
        rl, ql = lens[t] if lens else (int(rng.integers(20, 300)),
                                       int(rng.integers(20, 300)))
        fr, fq = random_profile_pair(rng, rl, ql, p=p)
        num = 1 + t % 3
        fr, fq = fr * num, fq * num
        go = (rng.uniform(-60, -40, rl).astype(np.float32),
              rng.uniform(-60, -40, ql).astype(np.float32))
        ge = (rng.uniform(-6, -4, rl).astype(np.float32),
              rng.uniform(-6, -4, ql).astype(np.float32))
        cons = (np.array([inv[c] for c in fr.argmax(1)], np.uint8),
                np.array([inv[c] for c in fq.argmax(1)], np.uint8))
        prepared.append((fr, fq, cons, ([], []), (rl, ql), go, ge))
        metas.append((rl, ql, num, 20000 if t == 2 else num))
    return prepared, metas


@pytest.mark.parametrize("p,task", [(6, 0), (6, 1), (22, 0)])
def test_pack_batch_equals_jax_packer(p, task):
    rng = np.random.default_rng(p + task)
    prepared, metas = _prepared(rng, p, 5)
    chunk = [4, 0, 2, 1]
    flen = [4096, 100, 4096, 512, 4096]
    xdrop = [5000, 5000, 10000, 5000, 5000]
    jax = _jax_batcher("n" if p == 6 else "p")
    want = jax._pack_batch(chunk, prepared, metas, task, 2048, 512,
                           len(chunk), flen, xdrop, off=0, tot=2048)
    st = dk.pack_batch(chunk, prepared, metas, task, 2048, p, jax.param,
                       flen, xdrop)
    got = _jax_order(st)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        st.offs.numpy(),
        talco_cuda.scratch_offsets(want[0], want[1], want[4]))


@pytest.mark.parametrize("p", [6, 22])
def test_pack_batch_leaf_equals_jax_packer(p):
    rng = np.random.default_rng(40 + p)
    prepared, metas = _prepared(rng, p, 4)
    chunk = [3, 1, 0]
    flen, xdrop = [4096] * 4, [5000] * 4
    jax = _jax_batcher("n" if p == 6 else "p")
    want = jax._pack_batch_leaf(chunk, prepared, metas, 2048, 512,
                                len(chunk), flen, xdrop, 0, 2048)
    got = _jax_order(dk.pack_batch_leaf(chunk, prepared, metas, 2048, p,
                                        jax.param, flen, xdrop))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("type_", ["n", "p"])
def test_device_params(type_):
    """The scoring state a launch takes: the f32 matrix and the scalars
    the JAX batcher packs (gap scores, the starting X-drop)."""
    param = Params.make(type_)
    mat, sc = talco_cuda.device_params(param, "cpu")
    assert mat.dtype == torch.float32
    np.testing.assert_array_equal(mat.numpy(), param.scoring_matrix)
    assert sc == {"gap_open": float(np.float32(param.gap_open)),
                  "gap_extend": float(np.float32(param.gap_extend)),
                  "xdrop": int(1000 * -1 * param.gap_extend)}


def test_leaf_predicate_and_padlen_buckets():
    leaf_prep = (None, None, None, ([], []), (10, 12), None, None)
    gappy = (None, None, None, ([3], []), (10, 12), None, None)
    assert dk.is_leaf_pair(leaf_prep, (10, 12, 1, 1), 0, 4096, 4096)
    assert not dk.is_leaf_pair(leaf_prep, (10, 12, 1, 1), 1, 4096, 4096)
    assert not dk.is_leaf_pair(leaf_prep, (10, 12, 2, 1), 0, 4096, 4096)
    assert not dk.is_leaf_pair(leaf_prep, (10, 12, 1, 1), 0, 1000, 4096)
    assert not dk.is_leaf_pair(gappy, (10, 12, 1, 1), 0, 4096, 4096)
    assert [dk.padlen_bucket(m) for m in (1, 2048, 2049, 32768, 40000)] \
        == [2048, 2048, 32768, 32768, 65536]


def _fake_launch(batcher, chunk, errs, lens):
    """A completed launch whose output rows carry the given errors."""
    b = len(chunk)
    host = torch.zeros(b * 2 * 2048 + b * 16, dtype=torch.uint8)
    paths, tail = dk.out_views(host, b, 2048)
    for bi, (e, n) in enumerate(zip(errs, lens)):
        paths[bi, :n] = torch.arange(n) % 3
        tail[bi, 0] = n if e == 0 else 0
        tail[bi, 1] = e
    return dk._Launch(chunk, None, host, None, 2048)


@pytest.mark.parametrize("task", [0, 1])
def test_collect_ladder_and_host_fallback(task):
    opt = Options(device_backend="cpu", type="n")
    batcher = dk.DeviceTalco(opt, Params.make("n"), "cpu")
    prepared = [(None,) * 4 + ((300, 200),) + (None, None)] * 5
    results = [None] * 5
    finals = {}
    pending = []
    flen = [4096] * 5
    xdrop = [5000] * 5
    launch = _fake_launch(batcher, [0, 1, 2, 3, 4], [0, 1, 2, 3, 4],
                          [7, 0, 0, 0, 0])
    batcher._collect(launch, results, prepared, task, dk.threading.Lock(),
                     set(), pending, flen, xdrop,
                     lambda i, p: finals.setdefault(i, p))
    np.testing.assert_array_equal(results[0], np.arange(7) % 3)
    assert results[0].dtype == np.int8
    assert finals[3] is None and finals[4] is None
    assert batcher.stats["err3_fallbacks"] == 2
    assert batcher.stats["task0_errors"] == (2 if task == 0 else 0)
    if task == 0:
        assert pending == [] and finals[1] is None and finals[2] is None
    else:
        # error 1 doubles the X-drop and widens flen to 8x it (capped at
        # the shorter side); error 2 grows flen by 1.2x, doubled, capped
        assert sorted(pending) == [1, 2] and 1 not in finals
        assert xdrop[1] == 10000 and flen[1] == 200
        assert flen[2] == min(int(4096 * 1.2) << 1, 200)
    bad = _fake_launch(batcher, [0], [talco_cuda.ERR_LAYOUT], [0])
    with pytest.raises(RuntimeError, match="error 8"):
        batcher._collect(bad, results, prepared, task, dk.threading.Lock(),
                         set(), [], flen, xdrop, lambda i, p: None)


def test_select_devices(capfd):
    opt = Options(device_backend="cuda")
    assert dk.select_devices(4, opt) == [0, 1, 2, 3]
    opt.device_num, opt.device_index = 2, [3, 1]
    assert dk.select_devices(4, opt) == [3, 1]
    assert "Maximum available devices: 4. Using 2 devices." \
        in capfd.readouterr().err
    for num, idx, msg in [(5, None, "Invalid number of devices"),
                          (-1, None, "Invalid number of devices"),
                          (2, [0], "does not match"),
                          (1, [4], "device index >=")]:
        opt.device_num, opt.device_index = num, idx
        with pytest.raises(SystemExit) as ex:
            dk.select_devices(4, opt)
        assert ex.value.code == 1
        assert msg in capfd.readouterr().err


def test_make_device_kernel_backends(monkeypatch):
    param = Params.make("n")
    assert dk.make_device_kernel(Options(device_backend="native"), param) \
        is None
    assert dk.make_device_kernel(Options(device_backend="numpy"), param) \
        is None
    cpu = dk.make_device_kernel(Options(device_backend="cpu"), param)
    assert cpu.device.type == "cpu" and cpu.stream is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dk.make_device_kernel(Options(device_backend="cuda"), param)


class _DB:
    current_task = 0


def test_batcher_on_cpu_tensors_matches_host_kernel(monkeypatch):
    """A level through the batcher on CPU tensors (the plain version):
    leaf and freq launches, a zero-length pair and a pair longer than the
    2048 bucket (a long launch), each equal to the host ladder's path."""
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    rng = np.random.default_rng(5)
    opt = Options(device_backend="cpu", type="n", pair_batch=2)
    param = Params.make("n")
    prepared, metas = _prepared(rng, 6, 5, lens=[(60, 70), (90, 80),
                                                 (50, 55), (40, 45),
                                                 (2100, 2080)])
    # a leaf pair: unit weights and the scalar gap scores (a raw sequence
    # has no gaps to make them position-specific)
    metas[0] = (60, 70, 1, 1)
    prepared[0] = prepared[0][:5] + (
        (np.full(60, param.gap_open, np.float32),
         np.full(70, param.gap_open, np.float32)),
        (np.full(60, param.gap_extend, np.float32),
         np.full(70, param.gap_extend, np.float32)))
    prepared[3] = prepared[3][:4] + ((0, 45),) + prepared[3][5:]
    batcher = dk.DeviceTalco(opt, param, "cpu")
    finals = {}
    res = batcher(prepared, metas, _DB(), opt, param,
                  on_final=lambda i, p: finals.setdefault(i, p))
    assert set(finals) == {0, 1, 2, 3, 4}
    assert res[3] is None
    st = batcher.stats
    assert (st["pairs"], st["zero_length"], st["long_launches"],
            st["pairs_on_device"], st["host_stolen"]) == (5, 1, 1, 4, 0)
    for i in (0, 1, 2, 4):
        want = batcher._host_align(prepared[i], metas[i], 0)
        np.testing.assert_array_equal(res[i], want)
