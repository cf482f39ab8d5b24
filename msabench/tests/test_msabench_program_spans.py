"""The readers of the program's span totals and gate counters, on
hand-made records: each alignment's share of the window's summed
`span_ns.*` and `count.*` stats, and None where the program left none
(a program without the tracer, or an untraced run)."""
import pytest

from msabench import spec

# metric: (its span names, the seconds they give in the record below)
SPANS = {"host_io_s": (("io.tree", "io.read", "io.write", "subtree.store"),
                       0.5),
         "host_setup_s": (("run.setup", "tree.partition", "tree.subtree",
                           "schedule"), 1.0),
         "host_prep_s": (("level.prep",), 2.0),
         "host_dp_s": (("level.dp_host",), 0.25),
         "host_post_s": (("level.post", "root_update"), 1.5),
         "wait_batcher_s": (("level.wait",), 0.75),
         "host_other_s": (("run", "level", "deferred", "subtree", "merge"),
                          0.1),
         "batcher_pack_s": (("batcher.pack",), 0.3),
         "batcher_event_wait_s": (("batcher.wait",), 0.05)}


def _record():
    """Two alignments whose summed totals give each metric twice the
    seconds of SPANS, split evenly over its names."""
    stats = {"pairs": 90, "count.pairs_card": 90, "count.pairs_host": 30}
    for names, seconds in SPANS.values():
        for n in names:
            stats[f"span_ns.{n}"] = int(2 * seconds * 1e9 / len(names))
    return {"align_s": [3.0, 4.0], "stats": stats}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_seconds_per_alignment(metric):
    names, seconds = SPANS[metric]
    read = spec.reader(metric)
    rec = _record()
    assert read(rec) == pytest.approx(seconds)
    # one name's total missing: no reading, as from a program without it
    del rec["stats"][f"span_ns.{names[-1]}"]
    assert read(rec) is None
    assert read({"align_s": [3.0], "stats": {"pairs": 4}}) is None


def test_gate_card_pair_share():
    read = spec.reader("gate_card_pair_share")
    assert read(_record()) == pytest.approx(75.0)
    assert read({"align_s": [1.0], "stats": {"pairs": 4}}) is None
    assert read({"align_s": [1.0], "stats": {
        "count.pairs_card": 0, "count.pairs_host": 0}}) is None
    assert read({"align_s": [1.0], "stats": {
        "count.pairs_card": 0, "count.pairs_host": 8}}) == 0.0


def test_benchmark_lists_each_reader():
    """Each metric is a per-layer entry of BENCHMARK.json that moves
    msa_s in both cells, read from the program's counters."""
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in [*SPANS, "gate_card_pair_share"]:
        m = entries[name]
        assert m["source"] == "program_counter" and m["moves"] == "msa_s"
        assert m["workloads"] == ["nt.rnasim_tall", "protein.homfam"]
