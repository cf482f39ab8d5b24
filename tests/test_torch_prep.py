"""The port's native level prep (`helpers.prepare_level_native`, through
`aligner._prepare_level`) held byte for byte to the JAX package's
`_prepare_pair` and to the port's own Python `_prepare_pair` on every
element of the prepared 7-tuple, and on the `msa_freq` it stores:
nucleotide and protein levels, cached sides, a side of 1000 members
(stored), threshold 1.0, gappy runs at the ends and over a whole side, a
zero-length side, unequal weights, and a side with a negative member id
(left to Python).
On one thread, on eight and on more threads than the host has cores, and
with the tracer's two counters adding up to the level's pairs."""
import time

import numpy as np
import pytest

from twilight_tpu import config as jax_config
from twilight_tpu.core.seqdb import SequenceDB as JaxSequenceDB
from twilight_tpu.phylo.tree import Node as JaxNode
from twilight_tpu.pipeline import aligner as jax_aligner
from twilight_tpu_torch import trace
from twilight_tpu_torch.config import Options, Params
from twilight_tpu_torch.constants import letter_lut, profile_size
from twilight_tpu_torch.core.seqdb import SequenceDB
from twilight_tpu_torch.phylo.tree import Node
from twilight_tpu_torch.pipeline import aligner, helpers

LETTERS = {"n": b"ACGTNacgtRY", "p": b"ACDEFGHIKLMNPQRSTVWYXBZacd"}


def _side(db, node_cls, rng, type_, width, n, gap_cols=(), cached=False,
          weights="equal", extra=0, neg=False):
    """A node of n new sequences `width` columns wide (their rows `extra`
    bytes longer), a share of letters gaps and `gap_cols` gaps in every
    row; `cached`: its profile as msa_freq (3 rows past aln_len), its
    members behind a negative id as after a collapse; `neg`: its last
    member id negative (Python's index of its first member while no
    sequence follows it: the level's last side)."""
    letters = np.frombuffer(LETTERS[type_], np.uint8)
    rows = letters[rng.integers(0, len(letters), (n, width + extra))]
    rows[rng.random(rows.shape) < 0.2] = ord("-")
    rows[:, list(gap_cols)] = ord("-")
    ids = []
    for r in rows:
        w = rng.uniform(0.05, 3.0) if weights == "random" else 1.0
        db.add_sequence(len(db.sequences), f"s{len(db.sequences)}",
                        r.tobytes().decode("latin-1"), 0, w, False, 0)
        ids.append(len(db.sequences) - 1)
    node = node_cls(f"node_{len(db.sequences)}", 0.0)
    node.aln_len, node.aln_num = width, n
    node.aln_weight = float(np.float32(sum(
        np.float32(db.sequences[i].weight) for i in ids)))
    node.seqs_included = ids
    if neg:
        node.seqs_included = ids[:-1] + [ids[0] - len(db.sequences)]
    if cached:
        lut, psize = letter_lut(type_), profile_size(type_)
        freq = np.zeros((width + 3, psize), dtype=np.float32)
        for i in ids:
            np.add.at(freq, (np.arange(width), lut[db.sequences[i].aln[:width]]),
                      db.sequences[i].weight)
        freq[width:, psize - 1] = 1.0
        node.msa_freq = freq
        node.seqs_included = [-ids[0] - 1]
    return node


# case: (type, threshold, the level's pairs as (ref side, query side)
# keyword sets for _side, each with its width and member count)
CASES = {
    "nt": ("n", 0.95, [(dict(width=120, n=5), dict(width=110, n=3)),
                       (dict(width=60, n=1), dict(width=64, n=1)),
                       (dict(width=200, n=12, gap_cols=[7, 8, 50]),
                        dict(width=190, n=2))]),
    "protein": ("p", 0.95, [(dict(width=90, n=4), dict(width=80, n=6)),
                            (dict(width=40, n=1), dict(width=45, n=1)),
                            (dict(width=70, n=9, gap_cols=[3]),
                             dict(width=75, n=3, gap_cols=[70, 74]))]),
    "cached_ref": ("n", 0.95, [(dict(width=80, n=7, cached=True,
                                     gap_cols=[0, 1]),
                                dict(width=70, n=2)),
                               (dict(width=30, n=2), dict(width=33, n=2))]),
    "cached_qry": ("p", 0.95, [(dict(width=50, n=3),
                                dict(width=60, n=5, cached=True,
                                     gap_cols=[59])),
                               (dict(width=20, n=1), dict(width=25, n=1))]),
    "store_1000": ("n", 0.95, [(dict(width=300, n=1000, gap_cols=[0, 299]),
                                dict(width=36, n=4)),
                               (dict(width=30, n=3), dict(width=31, n=2))]),
    "threshold_1": ("n", 1.0, [(dict(width=60, n=4, gap_cols=[0, 59]),
                                dict(width=55, n=3, cached=True,
                                     gap_cols=[5])),
                               (dict(width=30, n=2), dict(width=40, n=1))]),
    "gappy_edges": ("p", 0.5, [(dict(width=50, n=6, gap_cols=[0, 1, 2]),
                                dict(width=48, n=5, gap_cols=[46, 47])),
                               (dict(width=20, n=3, gap_cols=range(20)),
                                dict(width=22, n=4)),
                               (dict(width=25, n=2, gap_cols=[0, 24]),
                                dict(width=30, n=2, gap_cols=range(30)))]),
    "zero_length": ("n", 0.95, [(dict(width=0, n=1), dict(width=50, n=3)),
                                (dict(width=40, n=2), dict(width=0, n=2))]),
    "unequal_weights": ("p", 0.95, [(dict(width=60, n=8, weights="random",
                                          extra=5),
                                     dict(width=50, n=3, weights="random")),
                                    (dict(width=70, n=2, weights="random",
                                          cached=True),
                                     dict(width=66, n=5,
                                          weights="random"))]),
    "negative_id": ("n", 0.95, [(dict(width=50, n=3), dict(width=45, n=2)),
                                (dict(width=35, n=2), dict(width=38, n=5)),
                                (dict(width=44, n=2),
                                 dict(width=40, n=4, neg=True))]),
}


def _level(case, jax=False):
    """(database, pairs, type, threshold) of a case, the same every call;
    `jax`: built of the JAX package's SequenceDB and Node."""
    type_, threshold, specs = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    db, node_cls = (JaxSequenceDB(), JaxNode) if jax else (SequenceDB(), Node)
    pairs = [(_side(db, node_cls, rng, type_, **r),
              _side(db, node_cls, rng, type_, **q)) for r, q in specs]
    return db, pairs, type_, threshold


def _same(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{k}]")
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_prep_equals_python(case):
    db, pairs, type_, threshold = _level(case, jax=True)
    want = [jax_aligner._prepare_pair(
        p, db, jax_config.Options(type=type_, gappy_vertical=threshold),
        jax_config.Params.make(type_)) for p in pairs]
    want_freq = [nd.msa_freq for p in pairs for nd in p]
    db, pairs, type_, threshold = _level(case)
    param = Params.make(type_)
    option = Options(type=type_, gappy_vertical=threshold)
    py = [aligner._prepare_pair(p, db, option, param) for p in pairs]
    _same(want, py, f"{case} port's Python against the JAX package")
    _same(want_freq, [nd.msa_freq for p in pairs for nd in p],
          f"{case} port's Python msa_freq against the JAX package")
    n_py = sum(not helpers.native_prep_ok(p, profile_size(type_))
               for p in _level(case)[1])
    assert n_py == (1 if case == "negative_id" else 0)
    for threads in (1, 8, 32):
        db, pairs, _, _ = _level(case)
        option = Options(type=type_, gappy_vertical=threshold,
                         cpu_num=threads)
        metas = [(r.aln_len, q.aln_len, r.aln_num, q.aln_num)
                 for r, q in pairs]
        tr = trace.start(True, time.perf_counter_ns())
        try:
            got = aligner._prepare_level(pairs, metas, db, option, param)
        finally:
            trace.finish(tr)
        assert tr.counts == {"pairs_prep_native": len(pairs) - n_py,
                             "pairs_prep_py": n_py}
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{case} threads={threads} pair {i}")
        for k, (wf, nd) in enumerate(zip(want_freq,
                                         [nd for p in pairs for nd in p])):
            if wf is None:
                assert nd.msa_freq is None
            else:
                _same(wf, nd.msa_freq, f"{case} msa_freq side {k}")
    if case == "store_1000":
        assert all(f is not None for f in want_freq[:2])
