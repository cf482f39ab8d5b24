"""nt.sars_long's generator against the real genomes it was fitted to
(tests/golden/sars_20.aln): random 20-subsets of one set of the cell,
aligned by the port on the host, read a nearest-neighbour p-distance, an
all-pairs median p-distance and internal gap runs a genome within the
ranges the configuration's `assumed` states, and so does sars_20."""
import contextlib
import io
import itertools
import json
import os

import numpy as np

from conftest import ROOT

from msabench import spec
from msabench.reference import read_fasta
from msabench.simulate import simulate, write_input

SARS_20 = os.path.join(ROOT, "tests", "golden", "sars_20.aln")
# the ranges of the configuration's `assumed`
NEAREST = (5e-5, 2e-4)
ALL_PAIRS = (1.5e-4, 4.5e-4)
GAP_RUNS = (1.5, 6.5)


def readings(rows):
    """(nearest-neighbour p-distance, median over the rows; all-pairs
    median p-distance; mean internal gap runs a row) of aligned rows, over
    the columns where both rows hold one of ACGT."""
    a = np.frombuffer(b"".join(rows).upper(), np.uint8).reshape(len(rows),
                                                                 -1)
    letter = np.isin(a, np.frombuffer(b"ACGT", np.uint8))
    n = len(a)
    p = np.zeros((n, n))
    for i, j in itertools.combinations(range(n), 2):
        both = letter[i] & letter[j]
        p[i, j] = p[j, i] = np.mean(a[i][both] != a[j][both])
    nearest = np.median([np.delete(p[i], i).min() for i in range(n)])
    runs = []
    for row in a == ord("-"):
        edges = np.flatnonzero(np.diff(np.concatenate(([0], row, [0]))))
        runs.append(sum(s > 0 and e < len(row)
                        for s, e in zip(edges[::2], edges[1::2])))
    return nearest, np.median(p[np.triu_indices(n, 1)]), np.mean(runs)


def _inside(value, rng):
    return rng[0] <= value <= rng[1]


def test_sars_20_lies_in_the_ranges():
    rows = list(read_fasta(SARS_20)[0].values())
    nearest, median, runs = readings(rows)
    assert len(rows) == 20
    assert (_inside(nearest, NEAREST) and _inside(median, ALL_PAIRS)
            and _inside(runs, GAP_RUNS))


def test_cell_subsets_read_like_sars_20(tmp_path):
    from twilight_tpu_torch import cli
    bench = spec.load_benchmark()
    cell = spec.cell(bench, "nt.sars_long")
    assumed = " ".join(cell["config"]["assumed"])
    assert "5e-5 to 2e-4" in assumed and "1.5e-4 to 4.5e-4" in assumed \
        and "1.5 to 6.5" in assumed
    names, seqs, nwk = simulate(cell["workload"]["generator"], "n",
                                "nt.sars_long", 0, 2 ** 31 + 17)
    assert len(names) == 1000
    assert abs(np.mean([len(s) for s in seqs]) - 29682) < 20
    rng = np.random.default_rng(20)
    got = []
    for k in range(4):
        pick = sorted(rng.choice(len(names), 20, replace=False))
        fa, tree = write_input(str(tmp_path / f"s{k}"),
                               [names[i] for i in pick],
                               [seqs[i] for i in pick], nwk)
        out = str(tmp_path / f"s{k}.aln")
        with contextlib.redirect_stderr(io.StringIO()):
            rc, _ = cli.run(["-t", tree, "-i", fa, "-o", out, "--backend",
                             "native", "--prune"])
        assert rc == 0
        got.append(readings(list(read_fasta(out)[0].values())))
    nearest, median, runs = np.median(got, axis=0)
    assert _inside(nearest, NEAREST), json.dumps(got)
    assert _inside(median, ALL_PAIRS), json.dumps(got)
    assert _inside(np.mean([g[2] for g in got]), GAP_RUNS), json.dumps(got)
