"""Entry points of the port: a one-launch TALCO step and a
multi-device dry run of the production batcher.

The counterpart of the repository root's `__graft_entry__.py`, which is the
JAX package's. MSA has no neural model, so the "forward step" is one
batch of pairwise profile alignments: `TalcoStep`, one launch of the
TALCO-XDrop CUDA kernel (`ops/talco_cuda.talco_align`) over a packed
batch. `dryrun_multichip` runs the production multi-device batcher
(`ops/device_kernel.DeviceTalco`) over n devices with host stealing off,
through every kernel route (short freq, leaf, long, and the retry ladder's
wide relaunch), and holds every pair byte for byte to the NumPy oracle
(`ops/talco_np.align_freq`) run through the same width ladder.

    python -m twilight_tpu_torch.graft_entry

runs both on the card (the dry run over every visible GPU).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import Options, Params
from .ops import device_kernel, ladder, talco_cuda

PADLEN, FLEN, BATCH = 256, 256, 4      # the example batch (entry)
XDROP = 5000
# the dry run's ladder pair: a query insertion whose gaps cost more than
# the X-drop (50 + 5 x 1500 > 5000), so the band collapses (error 1)
LADDER_INDEL = 1500
MARKER = 1 << 10
GO, GE = -50.0, -5.0
_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def _nuc_matrix():
    m = np.zeros((6, 6), dtype=np.float32)
    for i in range(5):
        for j in range(5):
            m[i, j] = 18.0 if i == j else (-4.0 if abs(i - j) == 2 else -8.0)
    m[4, :5] = m[:5, 4] = 0.0
    return m


def _one_hot(codes):
    f = np.zeros((len(codes), 6), np.float32)
    f[np.arange(len(codes)), codes] = 1.0
    return f


def _prepared(rcodes, qcodes, num):
    """(prepared tuple, meta) of one nt pair in the batcher's layout,
    with the scalar gap scores as position-specific rows; a pair of
    weight 1 also ships its letters (the leaf route's input)."""
    rl, ql = len(rcodes), len(qcodes)
    go = (np.full(rl, GO, np.float32), np.full(ql, GO, np.float32))
    ge = (np.full(rl, GE, np.float32), np.full(ql, GE, np.float32))
    cons = ((_LETTERS[rcodes], _LETTERS[qcodes]) if num == 1
            else (None, None))
    return ((_one_hot(rcodes), _one_hot(qcodes), cons, ([], []), (rl, ql),
             go, ge), (rl, ql, num, num))


def _example_pairs(batch, padlen, seed=0):
    """The pairs of __graft_entry__._example_batch, drawn in its order:
    padlen * 3 // 4 columns each, 10% substitutions, no indels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        n = int(padlen * 3 // 4)
        base = rng.integers(0, 4, n + 8)
        q = base.copy()
        mut = rng.random(len(q)) < 0.1
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        out.append(_prepared(base[:n], q[:n], 1))
    return out


def _example_batch(batch=BATCH, padlen=PADLEN, flen=FLEN, seed=0):
    """(ints, floats, offs, ref, qry) of the example pairs on the CPU,
    packed by the batcher's freq packer (ref reversed and right-aligned,
    query left-aligned, no FLEN padding): gap rows GO/GE, gap_char GE,
    ref_num = qry_num = 1, ladder width `flen`, X-drop 5000."""
    prepared, metas = zip(*_example_pairs(batch, padlen, seed))
    st = device_kernel.pack_batch(
        list(range(batch)), prepared, metas, 0, padlen, 6, Params.make("n"),
        [flen] * batch, [XDROP] * batch, marker=MARKER)
    return (st.ints.clone(), st.floats.clone(), st.offs.clone(),
            st.ref.clone(), st.qry.clone())


class TalcoStep(torch.nn.Module):
    """One batch of nt profile pairs aligned by one launch of the TALCO
    kernel (its plain version on CPU tensors). The scoring matrix is a
    buffer; forward returns (paths int8 [B, 2*padlen], tail int32 [B,
    4])."""

    def __init__(self):
        super().__init__()
        self.p, self.marker = 6, MARKER
        self.register_buffer("matrix", torch.from_numpy(_nuc_matrix()))

    def forward(self, ints, floats, offs, ref, qry):
        return talco_cuda.talco_align(
            ints, floats, offs, ref, qry, self.matrix, p=self.p,
            marker=self.marker, scratch_bytes=int(offs[-1]))


def entry(device=None):
    """(TalcoStep, example_args) on `device`: the card unless the caller
    passes one (e.g. "cpu"); with no card and no device it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry(): no CUDA device (torch.cuda."
                               "is_available() is false); pass "
                               "device='cpu' for the plain version")
        device = "cuda"
    device = torch.device(device)
    args = tuple(t.to(device) for t in _example_batch())
    return TalcoStep().to(device), args


# ----------------------------------------------------------------------
# the multi-device dry run
# ----------------------------------------------------------------------

class _DB:
    def __init__(self, task):
        self.current_task = task


def _dryrun_pairs(n, base_flen, seed=0):
    """The dry run's two levels, each [(prepared, meta, route)]: at task
    0, 2n short freq pairs, n leaf pairs (raw letters) and n long pairs
    (2300-2600 columns); at task 1 (where errors take the retry ladder,
    as a deferred pair's realignment does) one ladder pair: base_flen +
    base_flen / 8 related columns with LADDER_INDEL random ones inserted
    into the query. Its band collapses at the starting width (error 1),
    and the ladder relaunches it with twice the X-drop at width min(lens)
    > base_flen, on the wide route (the counterpart of __graft_entry__.py's
    900-column pair with 620 inserted, which outgrows the TPU's window of
    512). The long pairs' bands need about 750 columns, so base_flen
    should be 1024 or more. Drawn like __graft_entry__.py's pairs: 10%
    substitutions; freq pairs carry weight 2 on one-hot columns."""
    rng = np.random.default_rng(seed)

    def pair(ln, num, indel=0):
        base = rng.integers(0, 4, ln + indel + 16)
        q = base.copy()
        mut = rng.random(len(q)) < 0.1
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        if indel:
            q = np.concatenate([q[:ln // 2], rng.integers(0, 4, indel),
                                q[ln // 2:]])
        return _prepared(base[:ln], q[:ln + indel], num)

    level0 = [pair(int(rng.integers(64, 128)), 2) + ("freq",)
              for _ in range(2 * n)]
    level0 += [pair(int(rng.integers(64, 128)), 1) + ("leaf",)
               for _ in range(n)]
    level0 += [pair(int(rng.integers(2300, 2600)), 2) + ("long",)
               for _ in range(n)]
    level1 = [pair(base_flen + base_flen // 8, 2, LADDER_INDEL)
              + ("ladder",)]
    return [level0, level1]


def oracle_ladder(prep, meta, task, flen0):
    """The reference retry ladder (`ops/ladder.py`) on the NumPy oracle
    from width flen0, nt scoring: the path, or None where the batcher
    gives None at task 0 (an error)."""
    path, needs_fallback = ladder.align_prepared(
        prep, meta, task, Params.make("n"), Options(device_backend="numpy"),
        flen=flen0)
    return None if needs_fallback else np.asarray(path, np.int8)


def _cuda_devices(n):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"dryrun_multichip: need {n} distinct CUDA "
                           f"devices, have {have}; pass devices= (e.g. "
                           f"['cuda:0'] * {n} or ['cpu'] * {n})")
    return [torch.device("cuda", i) for i in range(n)]


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     base_flen: Optional[int] = None, pool=None) -> dict:
    """Runs the production batcher (DeviceTalco) over n devices with host
    stealing off (its `no_steal`) through every route, and holds every
    pair byte for byte to the oracle's ladder from the same starting
    width. `devices` defaults to the first n distinct
    CUDA devices (it raises naming the count when there are fewer); a
    list may repeat a device or name CPU devices (the plain version).
    `base_flen` defaults to the batcher's starting ladder width (4096).
    `pool`, an optional concurrent.futures executor, runs the oracle
    (the ladder pair's first) while the devices run. Raises on any
    mismatch, on a host-stolen pair, on a device that made no launch and
    on a route that was never taken; returns the batcher's stats, its
    summary line and the pairs by route."""
    devs = (_cuda_devices(n_devices) if devices is None
            else [torch.device(d) for d in devices])
    if len(devs) != n_devices:
        raise ValueError(f"dryrun_multichip: {len(devs)} devices given "
                         f"for n_devices={n_devices}")
    backend = "cuda" if all(d.type == "cuda" for d in devs) else "cpu"
    opt = Options(device_backend=backend, pair_batch=8)
    param = Params.make("n")
    dt = device_kernel.DeviceTalco(opt, param, devs)
    dt.no_steal = True
    try:
        if base_flen is not None:
            dt.base_flen = int(base_flen)
        levels = _dryrun_pairs(n_devices, dt.base_flen)
        jobs = [(prep, meta, task, dt.base_flen)
                for task, level in enumerate(levels)
                for prep, meta, _ in level]
        futures = None
        if pool is not None:
            # the ladder pair's reference is the slowest: first
            order = sorted(range(len(jobs)),
                           key=lambda j: (jobs[j][2] == 0,
                                          -jobs[j][1][0] * jobs[j][1][1]))
            submitted = {j: pool.submit(oracle_ladder, *jobs[j])
                         for j in order}
            futures = [submitted[j] for j in range(len(jobs))]
        results = []
        for task, level in enumerate(levels):
            prepared = [prep for prep, _, _ in level]
            metas = [meta for _, meta, _ in level]
            results += dt(prepared, metas, _DB(task), opt, param)
        routes = [route for level in levels for _, _, route in level]
        for j, job in enumerate(jobs):
            gold = (futures[j].result() if futures is not None
                    else oracle_ladder(*job))
            got = results[j]
            if gold is None or got is None \
                    or not np.array_equal(got, gold):
                raise AssertionError(
                    f"dryrun_multichip: pair {j} ({routes[j]}, "
                    f"{job[0][4][0]} x {job[0][4][1]} columns) "
                    "differs from the oracle: device "
                    f"{None if got is None else len(got)} steps, "
                    f"oracle {None if gold is None else len(gold)}")
        st = dt.stats
        if st["host_stolen"]:
            raise AssertionError(f"dryrun_multichip: the host stole "
                                 f"{st['host_stolen']} pairs despite "
                                 "no_steal")
        if not all(st["launches_by_device"]):
            raise AssertionError(
                "dryrun_multichip: a device made no launch: "
                f"launches_by_device {st['launches_by_device']}")
        for k in ("leaf_launches", "long_launches", "wide_launches",
                  "ladder_relaunches"):
            if st[k] < 1:
                raise AssertionError(f"dryrun_multichip: {k} is 0: "
                                     "a route was never taken")
        by_route = {r: routes.count(r) for r in dict.fromkeys(routes)}
        return {"devices": [str(d) for d in devs],
                "base_flen": dt.base_flen, "pairs": by_route,
                "stats": dict(st), "summary": dt.summary()}
    finally:
        dt.close()


def main() -> int:
    step, args = entry()
    paths, tail = step(*args)
    torch.cuda.synchronize()
    print("entry() ok:", [tuple(t.shape) for t in (paths, tail)],
          "lengths", tail[:, 0].tolist(), "errors", tail[:, 1].tolist())
    res = dryrun_multichip(torch.cuda.device_count())
    print(res["summary"])
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
