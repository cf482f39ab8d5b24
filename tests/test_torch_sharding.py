"""The port's pairs mesh (twilight_tpu_torch/parallel/sharding.py) on CPU
devices, held to the JAX package's sharded kernel
(twilight_tpu/parallel/sharding.py under shard_map on the 8 virtual CPU
devices of conftest) and to the NumPy oracle: the cases of
tests/test_sharding.py, one pair a shard. Each shard's launch sees its own
offsets rebased to 0; a batch that is not a multiple of the mesh raises,
as under shard_map; with no card the mesh has no default."""
import numpy as np
import pytest
import torch

from twilight_tpu.ops import talco_jax
from twilight_tpu.parallel import sharding as jax_sharding
from twilight_tpu_torch.config import Params
from twilight_tpu_torch.ops import device_kernel as dk
from twilight_tpu_torch.ops import talco_cuda
from twilight_tpu_torch.parallel import sharding

from conftest import random_profile_pair
from test_talco_kernel import GE, GO, nuc_matrix, run_oracle

torch.set_num_threads(1)

PADLEN, FLEN, MARKER = 256, 256, 1024
CASES = [(100 + 7 * i, 100 + 5 * i) for i in range(8)]


def _prepared(fr, fq):
    rl, ql = fr.shape[0], fq.shape[0]
    go = (np.full(rl, GO, np.float32), np.full(ql, GO, np.float32))
    ge = (np.full(rl, GE, np.float32), np.full(ql, GE, np.float32))
    return (fr, fq, (None, None), ([], []), (rl, ql), go, ge), (rl, ql, 1, 1)


def _port_batch(pairs):
    """The pairs packed by the port's freq packer: ladder width 4096,
    X-drop 5000, gap_char GE (task 0), weights 1."""
    prepared, metas = zip(*(_prepared(fr, fq) for fr, fq in pairs))
    st = dk.pack_batch(list(range(len(pairs))), prepared, metas, 0, PADLEN,
                       6, Params.make("n"), [4096] * len(pairs),
                       [5000] * len(pairs), marker=MARKER)
    return st.ints, st.floats, st.offs, st.ref, st.qry


def _jax_sharded(pairs):
    """tests/test_sharding.py's batch through the JAX sharded kernel."""
    mesh = jax_sharding.make_pair_mesh()
    kern = jax_sharding.get_sharded_batch_kernel(
        PADLEN, FLEN, 6, MARKER, nuc_matrix().tobytes(), 6, mesh)
    b = jax_sharding.pad_batch_to_mesh(len(pairs), mesh)
    tot = FLEN + PADLEN + FLEN
    rr = np.zeros((b, tot, 6), np.float32)
    qq = np.zeros((b, tot, 6), np.float32)
    gor, goq, ger, geq = (np.zeros((b, tot), np.float32) for _ in range(4))
    rl = np.ones(b, np.int32)
    ql = np.ones(b, np.int32)
    for i, (fr, fq) in enumerate(pairs):
        go = (np.full(fr.shape[0], GO, np.float32),
              np.full(fq.shape[0], GO, np.float32))
        ge = (np.full(fr.shape[0], GE, np.float32),
              np.full(fq.shape[0], GE, np.float32))
        rr[i], qq[i], gor[i], goq[i], ger[i], geq[i] = talco_jax.pack_pair(
            fr, fq, go, ge, PADLEN, FLEN)
        rl[i], ql[i] = fr.shape[0], fq.shape[0]
    ones = np.ones(b, np.float32)
    out, lens, errs = kern(
        rr, qq, gor, goq, ger, geq, rl, ql, ones, ones,
        np.full(b, 4096, np.int32), np.full(b, 5000, np.int32),
        np.full(b, GE, np.float32), np.float32(GO), np.float32(GE))
    return np.asarray(out), np.asarray(lens), np.asarray(errs)


def test_sharded_kernel_matches_jax_sharded_kernel_and_oracle(rng):
    pairs = [random_profile_pair(rng, r, q) for r, q in CASES]
    mesh = sharding.make_pair_mesh(["cpu"] * 8)
    assert sharding.pad_batch_to_mesh(len(pairs), mesh) == 8
    kern = sharding.get_sharded_batch_kernel(6, MARKER, nuc_matrix(), mesh)
    paths, tail = kern(*_port_batch(pairs))
    paths, tail = paths.numpy(), tail.numpy()
    jout, jlens, jerrs = _jax_sharded(pairs)
    for i, (fr, fq) in enumerate(pairs):
        gold, gerr = run_oracle(fr, fq)
        n = len(gold)
        assert int(tail[i, 1]) == int(jerrs[i]) == gerr == 0
        assert int(tail[i, 0]) == int(jlens[i]) == n
        np.testing.assert_array_equal(paths[i, :n], jout[i, :n])
        np.testing.assert_array_equal(paths[i, :n], gold)


def test_each_shard_gets_rebased_offsets(rng, monkeypatch):
    """Two shards of four pairs: each launch's offsets start at 0 and end
    at its scratch size, the shard's sizes unchanged; the outputs equal
    one unsharded launch's, in input order."""
    pairs = [random_profile_pair(rng, 60 + 9 * i, 55 + 4 * i)
             for i in range(8)]
    ints, floats, offs, ref, qry = _port_batch(pairs)
    calls = []
    real = talco_cuda.talco_align

    def spy(i_, f_, o_, r_, q_, m_, **kw):
        calls.append((o_.clone(), kw["scratch_bytes"], i_[0].tolist()))
        return real(i_, f_, o_, r_, q_, m_, **kw)

    monkeypatch.setattr(talco_cuda, "talco_align", spy)
    kern = sharding.get_sharded_batch_kernel(6, MARKER, nuc_matrix(),
                                             ["cpu", "cpu"])
    paths, tail = kern(ints, floats, offs, ref, qry)
    sizes = np.diff(offs.numpy())
    assert [c[2] for c in calls] == [ints[0, :4].tolist(),
                                     ints[0, 4:].tolist()]
    for k, (o, scratch, _) in enumerate(calls):
        assert int(o[0]) == 0 and int(o[-1]) == scratch
        np.testing.assert_array_equal(np.diff(o.numpy()),
                                      sizes[4 * k:4 * k + 4])
    whole = real(ints, floats, offs, ref, qry, torch.from_numpy(
        nuc_matrix()), p=6, marker=MARKER, scratch_bytes=int(offs[-1]))
    assert torch.equal(paths, whole[0]) and torch.equal(tail, whole[1])


@pytest.mark.parametrize("n_pairs,size,want", [
    (0, 4, 0), (1, 4, 4), (4, 4, 4), (5, 4, 8), (8, 8, 8), (9, 8, 16),
    (3, 1, 3), (7, 2, 8)])
def test_pad_batch_to_mesh(n_pairs, size, want):
    mesh = sharding.make_pair_mesh(["cpu"] * size)
    assert sharding.pad_batch_to_mesh(n_pairs, mesh) == want


def test_batch_not_a_multiple_of_the_mesh_raises(rng):
    pairs = [random_profile_pair(rng, 50, 50) for _ in range(3)]
    kern = sharding.get_sharded_batch_kernel(6, MARKER, nuc_matrix(),
                                             ["cpu"] * 2)
    with pytest.raises(ValueError, match="not a multiple of the mesh"):
        kern(*_port_batch(pairs))


def test_make_pair_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_pair_mesh()
    assert sharding.make_pair_mesh(["cpu", "cpu"]) == (
        torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError):
        sharding.make_pair_mesh([])
