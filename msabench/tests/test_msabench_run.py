"""Whole runs of the harness on the CPU (the batcher's plain version on
CPU tensors, a tiny cell): the last line's keys, and `correct` coming out
false when the timed path is broken underneath the seam."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, cpu_testing

from msabench import control, judge, run

E2E = {"msa_s", "peak_rss_gib", "setup_s"}
PER_LAYER = {"pipeline_host_s", "batcher_s", "device_pair_share"}


def _last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_last_line_keys(bench_copy, capsys):
    rc = run.main(["--workload", "nt.tiny", "--seed", str(2 ** 31 + 5),
                   "--seconds", "0.5", "--trace", "0"],
                  testing=cpu_testing(bench_copy))
    assert rc == 0
    res = _last_line(capsys)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["failed"] == 0
    assert set(res["metrics"]) == E2E
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_traced_line(bench_copy, capsys):
    rc = run.main(["--workload", "nt.tiny", "--seed", "12", "--seconds",
                   "0.5", "--trace", "1"], testing=cpu_testing(bench_copy))
    assert rc == 0
    res = _last_line(capsys)
    assert res["correct"] is True
    assert PER_LAYER <= set(res["metrics"])   # no device trace on the CPU
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def _break_collect(alter):
    """A fault under the seam: `alter(paths, tail)` rewrites a launch's
    results in place before the batcher reads them."""
    def fault(kernel):
        collect = kernel._collect

        def broken(launch, *rest):
            from twilight_tpu_torch.ops.device_kernel import out_views
            launch.wait()
            paths, tail = out_views(launch.host_out, len(launch.chunk),
                                    launch.padlen)
            alter(paths.numpy(), tail.numpy())
            collect(launch, *rest)
        kernel._collect = broken
    return fault


def _swap_first_step(paths, tail):
    # an answer altered where it is produced: the first two steps that
    # differ trade places, which keeps the path's letter counts
    for bi in range(len(tail)):
        p = paths[bi, :tail[bi, 0]]
        j = np.flatnonzero(p[1:] != p[:-1])
        if len(j):
            p[j[0]], p[j[0] + 1] = p[j[0] + 1], p[j[0]]


def _unwritten(paths, tail):
    # a step that leaves its output as it found it
    paths[:] = 0
    tail[:] = 0


def _half_left_out(paths, tail):
    # the second half of the launch's pairs never computed
    h = (len(tail) + 1) // 2
    paths[h:] = 0
    tail[h:] = 0


def _change_a_letter(path):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    i = data.index(b"\n") + 1
    while data[i] == ord("-"):
        i += 1
    data[i] = ord("A") if data[i] != ord("A") else ord("C")
    with open(path, "wb") as f:
        f.write(data)


def _shifted_profile(monkeypatch):
    # an internal profile off by one column: the DP aligns what the rows
    # do not hold, and the file follows its path
    from twilight_tpu_torch.pipeline import helpers
    calc = helpers.calculate_profile

    def wrong(nodes, *args):
        fr, fq = calc(nodes, *args)
        if nodes[0].aln_num > 1 and nodes[0].aln_len > 1:
            fr = fr.copy()
            fr[1:nodes[0].aln_len] = fr[:nodes[0].aln_len - 1].copy()
        return fr, fq
    monkeypatch.setattr(helpers, "calculate_profile", wrong)


def _shifted_merge(monkeypatch):
    # a merge that puts one side's gap column one step from where the
    # path has it: the first two differing steps trade places
    from twilight_tpu_torch.pipeline import helpers
    update = helpers.update_alignment

    def wrong(nodes, database, aln, *args):
        aln = np.array(aln)
        j = np.flatnonzero(aln[1:] != aln[:-1])
        if len(j):
            aln[j[0]], aln[j[0] + 1] = aln[j[0] + 1], aln[j[0]]
        return update(nodes, database, aln, *args)
    monkeypatch.setattr(helpers, "update_alignment", wrong)


@pytest.mark.parametrize("fault", ["altered_answer", "output_unwritten",
                                   "half_left_out", "altered_file",
                                   "shifted_profile", "shifted_merge"])
def test_broken_path_is_not_correct(bench_copy, capsys, monkeypatch, fault):
    extra = {"env": {"TWILIGHT_FORCE_DEVICE": "1", "TWILIGHT_NO_STEAL": "1"}}
    if fault == "altered_file":
        extra["after_align"] = _change_a_letter
    elif fault in ("shifted_profile", "shifted_merge"):
        {"shifted_profile": _shifted_profile,
         "shifted_merge": _shifted_merge}[fault](monkeypatch)
    else:
        extra["fault"] = _break_collect({
            "altered_answer": _swap_first_step,
            "output_unwritten": _unwritten,
            "half_left_out": _half_left_out}[fault])
    rc = run.main(["--workload", "nt.tiny", "--seed", "99", "--seconds",
                   "0.5", "--trace", "0"],
                  testing=cpu_testing(bench_copy, **extra))
    assert rc == 0
    res = _last_line(capsys)
    assert res["correct"] is False
    if fault == "shifted_profile":
        assert res["checks"]["profile_residual"]["value"] > \
            res["checks"]["profile_residual"]["limit"]
    if fault == "shifted_merge":
        assert res["checks"]["merge_paths_differ"]["value"] > 0


def test_a_layer_left_unjudged_is_not_correct():
    info = {"kernel_pairs_judged": 8, "dp_cells_judged": 8,
            "leaf_pairs_judged": 4, "merge_pairs_judged": 4,
            "profile_sides_judged": 8}
    assert judge.all_judged(info)
    for k in info:
        assert not judge.all_judged({**info, k: 0})


def test_no_card_no_result(bench_copy, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "nt.tiny", "--seed", "1", "--seconds",
                   "1", "--trace", "0"],
                  testing={"root": bench_copy,
                           "here": os.path.join(bench_copy, "msabench")})
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "msabench"), tmp_path / "msabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "msabench.run", "--workload",
         "nt.rnasim_tall", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout == ""


def test_control_reads_its_numbers(bench_copy, capsys):
    rc = control.main(["--workload", "nt.tiny", "--seeds", "3,4",
                       "--seconds", "0.5"], testing=cpu_testing(bench_copy))
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [ln["seed"] for ln in lines[:-1]] == [3, 4]
    limits = _limits()
    assert all(v <= limits[k] for k, v in lines[-1]["lower"].items())
    assert set(lines[-1]["upper"]) >= {"kernel_pairs_differ",
                                       "leaf_pairs_differ",
                                       "merge_paths_differ",
                                       "profile_residual", "psgp_residual"}
    assert any(v > limits[k] for k, v in lines[-1]["upper"].items())


def _limits():
    """Each compared number's limit, as judge.py sets it."""
    out = {k: 0 for k in ("kernel_pairs_differ", "dp_cells_differ",
                          "leaf_pairs_differ", "merge_paths_differ",
                          "rows_wrong", "failed_alignments")}
    out.update(profile_residual=judge.PROFILE_LIMIT,
               psgp_residual=judge.PSGP_LIMIT)
    return out


@pytest.mark.cuda
def test_control_fails_on_the_card(bench_copy, capsys):
    """The control at a test's size on the card: the program reads 0, the
    bfloat16 reference above 0, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    testing = {"root": bench_copy, "here": os.path.join(bench_copy,
                                                        "msabench")}
    from conftest import add_cell, TINY
    add_cell(bench_copy, "nt.small", {
        **TINY, "generator": {**TINY["generator"], "n": 200,
                              "length": 1500},
        "check": {"leaf_pairs": 6, "freq_pairs": 6}})
    rc = control.main(["--workload", "nt.small", "--seeds", "5,6,7",
                       "--seconds", "1"], testing=testing)
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = _limits()
    assert all(v <= limits[k] for k, v in last["lower"].items())
    assert any(v > limits[k] for k, v in last["upper"].items())
