"""Discovery of configurations, workloads and metrics by name."""
import hashlib
import json
import os

from conftest import HERE, ROOT, TINY, add_cell

from msabench import spec


def _digests(folder):
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" not in d and not f.endswith(".pyc"):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, folder)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_every_cell_and_metric_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell["config"]["type"] in ("n", "p")
        assert cell["workload"]["chips"] == w["chips"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_new_cell_and_metric_are_files_plus_entries(bench_copy):
    before = _digests(os.path.join(bench_copy, "msabench"))
    add_cell(bench_copy, "protein.tiny",
             {**TINY, "config": "protein_blosum62", "traffic": "tiny_p"})
    with open(os.path.join(bench_copy, "msabench", "metrics",
                           "alignments.per.window.py"), "w") as f:
        f.write("def read(rec):\n    return len(rec['align_s'])\n")
    path = os.path.join(bench_copy, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "alignments.per.window", "unit": "count",
        "better": "higher", "source": "host_clock", "layer": "pipeline host",
        "moves": "msa_s", "workloads": ["protein.tiny"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    after = _digests(os.path.join(bench_copy, "msabench"))
    assert {k: v for k, v in after.items() if k in before} == before
    here = os.path.join(bench_copy, "msabench")
    bench = spec.load_benchmark(bench_copy)
    cell = spec.cell(bench, "protein.tiny", root=bench_copy, here=here)
    assert cell["config"]["type"] == "p"
    names = [m["name"] for m in spec.metrics_of(bench, "protein.tiny", True)]
    assert "alignments.per.window" in names and "talco_roofline" in names
    assert "alignments.per.window" not in [
        m["name"] for m in spec.metrics_of(bench, "nt.rnasim_tall", True)]
    assert spec.reader("alignments.per.window", here)(
        {"align_s": [1.0, 2.0]}) == 2


def test_benchmark_json_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["msabench"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"msa_s", "peak_rss_gib", "setup_s"} <= e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    assert os.path.commonpath([HERE, ROOT]) == ROOT
