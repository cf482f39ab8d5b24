"""The readers of the program's long-route counters (nt.sars_long's
per-layer metrics) on hand-made records, and one CPU run of the harness
on a SARS-shaped cell small enough for the batcher's plain version, in
which every pair takes the long route."""
import json

import pytest

from conftest import add_cell, cpu_testing

from msabench import run, spec

NEW = ("long_card_pair_share", "long_pairs_per_launch", "long_steal_s",
       "talco_long_roofline")


def _record(**stats):
    """Two alignments of a traced window whose kernels took 2 s and whose
    collected launches need 0.67 s at the f32 peak."""
    return {"align_s": [3.0, 5.0], "stats": stats, "ops": 67e12 * 0.67,
            "bytes": 1e9, "trace": {"kernel_s": 2.0}}


FULL = {"count.pairs_long_card": 30, "count.pairs_long_host": 10,
        "count.pairs_long_launched": 36, "count.launches_long": 3,
        "span_ns.batcher.steal_long": 4_000_000_000, "launches": 3,
        "long_launches": 3}


@pytest.mark.parametrize("metric,want", [
    ("long_card_pair_share", 75.0), ("long_pairs_per_launch", 12.0),
    ("long_steal_s", 2.0), ("talco_long_roofline", 33.5)])
def test_reader_values(metric, want):
    assert spec.reader(metric)(_record(**FULL)) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
def test_reader_without_counters(metric):
    """A record from a program without the counters, or an untraced run."""
    assert spec.reader(metric)(_record(pairs=4)) is None


@pytest.mark.parametrize("stats", [
    {"count.pairs_long_card": 0, "count.pairs_long_host": 0,
     "count.pairs_long_launched": 0, "count.launches_long": 0},
    {"launches": 5, "long_launches": 3},
    {"launches": 0, "long_launches": 0}])
def test_reader_with_nothing_to_read(stats):
    """No long pair finished, no long launch, or a window whose card
    launches were not all long: no reading."""
    rec = _record(**stats)
    assert [spec.reader(m)(rec) for m in NEW] == [None] * 4


def test_benchmark_lists_the_readers():
    """Each a per-layer entry that moves msa_s in nt.sars_long alone."""
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "msa_s" and m["workloads"] == ["nt.sars_long"]
        assert (m["source"], m["layer"]) == (
            ("device_trace", "kernel") if name == "talco_long_roofline"
            else ("program_counter", "batcher"))
    cell = spec.cell(bench, "nt.sars_long")
    assert cell["entry"]["chips"] == 1
    assert cell["config"]["flags"] == [] and cell["workload"]["flags"] == []
    assert cell["config"]["scoring"] == spec.cell(
        bench, "nt.rnasim_tall")["config"]["scoring"]


def test_sars_shaped_run_on_the_long_route(bench_copy, capsys):
    """8 genomes of ~2.5 kb (so that every pair is above the 2048-column
    bucket) with the cell's generator, at a divergence raised so that no
    two genomes are equal, through the whole harness with --trace 1."""
    with open(spec.HERE + "/workloads/nt.sars_long.json") as f:
        cell = json.load(f)
    gen = {**cell["generator"], "n": 8, "length": 2500, "mut_rate": 2e-3}
    add_cell(bench_copy, "nt.sars_tiny", {
        **cell, "traffic": "sars_tiny", "generator": gen,
        "warmup": {"n": 4, "length": 300, "flags": []},
        "check": {"leaf_pairs": 4, "freq_pairs": 4}})
    rc = run.main(["--workload", "nt.sars_tiny", "--seed",
                   str(2 ** 31 + 20), "--seconds", "0.5", "--trace", "1"],
                  testing=cpu_testing(bench_copy))
    assert rc == 0
    lines = capsys.readouterr()
    res = json.loads(lines.out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    batcher = next(ln for ln in lines.err.splitlines()
                   if ln.startswith("batcher: "))
    st = dict(kv.split("=") for kv in batcher.split()[1:])
    assert int(st["long_launches"]) > 0
    assert int(st["count.pairs_long_card"]) + int(
        st["count.pairs_long_host"]) == int(st["pairs"]) - int(
        st["zero_length"])
    assert int(st["count.pairs_long_card"]) == int(st["pairs_on_device"])
    assert int(st["count.pairs_long_host"]) == int(st["host_stolen"])
    m = res["metrics"]
    assert {"long_card_pair_share", "long_pairs_per_launch",
            "long_steal_s"} <= set(m)
    # the plain version's launches on the CPU are not card launches
    assert "talco_long_roofline" not in m
