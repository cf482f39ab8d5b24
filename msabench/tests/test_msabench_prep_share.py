"""The reader of the program's level-prep counters on hand-made records:
the share of pairs prepped natively, and None where the program left no
such counters (a program without them, or an untraced run)."""
import pytest

from msabench import spec


@pytest.mark.parametrize("native,py,share", [(90, 30, 75.0), (8, 0, 100.0),
                                             (0, 8, 0.0), (0, 0, None)])
def test_prep_native_pair_share(native, py, share):
    read = spec.reader("prep_native_pair_share")
    rec = {"align_s": [1.0], "stats": {"count.pairs_prep_native": native,
                                       "count.pairs_prep_py": py}}
    assert read(rec) == (share if share is None else pytest.approx(share))


@pytest.mark.parametrize("stats", [{"pairs": 4},
                                   {"count.pairs_prep_native": 4},
                                   {"count.pairs_prep_py": 4}])
def test_prep_native_pair_share_without_counters(stats):
    assert spec.reader("prep_native_pair_share")(
        {"align_s": [1.0], "stats": stats}) is None


def test_benchmark_lists_the_reader():
    """A per-layer entry of BENCHMARK.json that moves msa_s in both
    cells, read from the program's counters."""
    m = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[
        "prep_native_pair_share"]
    assert (m["source"], m["moves"], m["layer"], m["better"], m["unit"]) == (
        "program_counter", "msa_s", "pipeline host", "higher", "%")
    assert m["workloads"] == ["nt.rnasim_tall", "protein.homfam"]
