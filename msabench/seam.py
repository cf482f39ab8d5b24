"""The benchmark's one seam into the program: the DP batcher.

`install` replaces `twilight_tpu_torch.cli.make_device_kernel` with a
function that wraps what the original returns, so that every `cli.run`
hands its levels to a `KernelSeam`. The seam forwards each call and every
attribute to the batcher, and records:

- a span around each call (host clock), for `batcher_s` and
  `pipeline_host_s`;
- a seeded sample of the pairs handed over in the window, with the
  program's answer for each, for the kernel and pipeline checks: leaf
  pairs (two raw sequences at task 0, both unique in the input) and freq
  pairs (profiles, with the names of each side's sequences at task 0,
  read from the level's node pairs, which `install` has
  `aligner.align_pairs` hand to the recorder), in two reservoirs;
- what the card itself answered for a sampled pair in its first launch
  (the ladder's first step): the tail's error and DP cells and the path,
  also where the host stole the pair and the batcher never read the
  launch. The seam wraps the batcher's `_launch` on the instance and
  keeps the output buffer of each launch that holds a sampled pair (of
  every launch in a traced window, whose tails give `talco_roofline` its
  cells and bytes) until the alignment has ended and the batcher's
  streams have been synchronised, then reads it (`Recorder.drain`).

What the program should offer in its place (structured spans and a DP
cell counter in `DeviceTalco.stats`) is listed in PERF.md for a later
change.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .roofline import pair_bytes, pair_ops


class Recorder:
    """What the seam saw in the measured window."""

    def __init__(self, n_leaf: int, n_freq: int, p: int):
        self.cap = {"leaf": n_leaf, "freq": n_freq}
        self.p = p
        self.lock = threading.Lock()
        self.active = False          # recording only inside the window
        self.every_launch = False    # keep every launch's tails (traced)
        self.reset(0)

    def reset(self, seed: int) -> None:
        """Forgets the last window; the sample is drawn from `seed`."""
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EA])
        self.samples = {"leaf": [], "freq": []}
        self.seen = {"leaf": 0, "freq": 0}
        self.index = -1              # the alignment in flight
        self.unique = {}             # its sequences that occur once
        self.spans = []              # (alignment, t0, t1) a batcher call
        self.kept = []               # launches to read after the alignment
        self.ops = 0.0
        self.bytes = 0.0
        self.launches = 0
        self.pairs = None            # the level in flight: its node pairs

    def _offer(self, kind: str, item: dict) -> bool:
        """Reservoir sampling: item joins the kind's sample with the
        chance its share of all offers so far gives it."""
        self.seen[kind] += 1
        sample, cap = self.samples[kind], self.cap[kind]
        if len(sample) < cap:
            sample.append(item)
            return True
        j = int(self.rng.integers(0, self.seen[kind]))
        if j < cap:
            sample[j] = item
            return True
        return False

    def drain(self) -> None:
        """Reads the kept launches' outputs; call once the alignment has
        ended and every stream is synchronised."""
        from twilight_tpu_torch.ops.device_kernel import out_views
        with self.lock:
            kept, self.kept = self.kept, []
        for host_out, lens, padlen, leaf, mine in kept:
            paths, tail = out_views(host_out, len(lens), padlen)
            paths, tail = paths.numpy(), tail.numpy()
            for bi, item in mine:
                ln, err = int(tail[bi, 0]), int(tail[bi, 1])
                item.update(cells=int(tail[bi, 2]), card_err=err,
                            card_path=paths[bi, :ln].copy() if err == 0
                            else None)
            if self.every_launch:
                self.launches += 1
                for bi, (rl, ql) in enumerate(lens):
                    self.ops += pair_ops(int(tail[bi, 2]), self.p, leaf)
                    self.bytes += pair_bytes(rl, ql, int(tail[bi, 0]),
                                             self.p, leaf)


class _Call(threading.local):
    items = None     # {pair index: sampled item} of the call in flight


class KernelSeam:
    """Forwards the kernel contract of pipeline/aligner.py to `inner`."""

    def __init__(self, inner, rec: Recorder):
        self._inner = inner
        self._rec = rec
        self._call = _Call()
        launch = inner._launch

        def _launch(chunk, padlen, prepared, metas, task, leaf, *rest):
            out = launch(chunk, padlen, prepared, metas, task, leaf, *rest)
            self._keep(out, chunk, padlen, prepared, leaf)
            return out

        inner._launch = _launch

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _keep(self, launch, chunk, padlen, prepared, leaf) -> None:
        rec = self._rec
        if not rec.active:
            return
        items = self._call.items or {}
        mine = [(bi, items[i]) for bi, i in enumerate(chunk)
                if i in items and "card_err" not in items[i]]
        if not mine and not rec.every_launch:
            return
        for _, item in mine:
            item["card_err"] = None      # its first launch is this one
        with rec.lock:
            rec.kept.append((launch.host_out,
                             [prepared[i][4] for i in chunk], padlen,
                             bool(leaf), mine))

    def _sample(self, prepared, metas, database) -> dict:
        rec = self._rec
        task = database.current_task
        pairs = rec.pairs
        if pairs is not None and len(pairs) != len(prepared):
            pairs = None
        items = {}
        with rec.lock:
            for i, prep in enumerate(prepared):
                rl, ql = prep[4]
                if rl <= 0 or ql <= 0:
                    continue
                rn, qn = metas[i][2], metas[i][3]
                if task == 0 and rn == 1 and qn == 1:
                    cons = (bytes(prep[2][0][:rl]), bytes(prep[2][1][:ql]))
                    names = tuple(rec.unique.get(c) for c in cons)
                    if None in names:
                        continue
                    item = {"kind": "leaf", "names": names}
                else:
                    item = {"kind": "freq"}
                item.update(k=rec.index, task=task,
                            num=(float(rn), float(qn)))
                if rec._offer(item["kind"], item):
                    if item["kind"] == "freq":
                        fr, fq, _, _, _, go, ge = prep
                        item.update(fr=np.array(fr[:rl]),
                                    fq=np.array(fq[:ql]),
                                    go=(np.array(go[0]), np.array(go[1])),
                                    ge=(np.array(ge[0]), np.array(ge[1])))
                        sides = (_names(pairs[i], database, metas[i])
                                 if task == 0 and pairs is not None
                                 else None)
                        if sides is not None:
                            item.update(sides=sides, lens=metas[i][:2])
                    items[i] = item
        return items

    def __call__(self, prepared, metas, database, option, param,
                 on_final=None):
        rec = self._rec
        if not rec.active:
            return self._inner(prepared, metas, database, option, param,
                               on_final=on_final)
        items = self._sample(prepared, metas, database)
        self._call.items = items
        t0 = time.perf_counter()
        try:
            res = self._inner(prepared, metas, database, option, param,
                              on_final=on_final)
        finally:
            t1 = time.perf_counter()
            self._call.items = None
        with rec.lock:
            rec.spans.append((rec.index, t0, t1))
        for i, item in items.items():
            item["path"] = None if res[i] is None else np.array(res[i])
        return res


def _names(pair, database, meta):
    """(names of the reference side's sequences, of the query side's),
    or None where a side's count is not its meta's. A side past the
    program's collapse threshold lists its sequences under a negative
    id, which each of them holds as its `subtree_idx`."""
    out = []
    for node, num in zip(pair, meta[2:]):
        ids = list(node.seqs_included)
        if any(j < 0 for j in ids):
            neg = {j for j in ids if j < 0}
            ids = [j for j in ids if j >= 0] + [
                j for j, s in enumerate(database.sequences)
                if s.subtree_idx in neg]
        if len(ids) != num:
            return None
        out.append([database.sequences[j].name for j in ids])
    return tuple(out)


def install(rec: Recorder, fault=None):
    """Makes every later `cli.run` hand its levels to a KernelSeam over
    the batcher, and each level's node pairs to `rec` (`fault(batcher)`,
    for the harness's own tests, breaks the batcher underneath the seam
    first)."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.pipeline import aligner
    align = getattr(aligner.align_pairs, "original", aligner.align_pairs)

    def align_pairs(pairs, *args, **kwargs):
        rec.pairs = pairs
        try:
            return align(pairs, *args, **kwargs)
        finally:
            rec.pairs = None

    align_pairs.original = align
    aligner.align_pairs = align_pairs
    # a second install in one process replaces the first seam
    make = getattr(cli.make_device_kernel, "original", cli.make_device_kernel)

    def make_seam(option, param):
        kernel = make(option, param)
        if fault is not None:
            fault(kernel)
        return KernelSeam(kernel, rec)

    make_seam.original = make
    cli.make_device_kernel = make_seam
