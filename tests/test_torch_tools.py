"""The port's tools on the CPU: the kernel fuzz (tools/fuzz_talco.py) holds
the plain version to the oracle and names a pair that differs, the kernel
bench (tools/bench_kernel.py) prints the JAX tool's keys with no device
figure, every tool that did not ask for the CPU exits without a card, and
the quality harness (tools/quality_harness.py) gives the JAX package's SP
figures and the same bytes on the cpu backend as on the native one."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from twilight_tpu_torch.ops import talco_cuda
from twilight_tpu_torch.tools import bench_kernel, fuzz_talco, quality_harness

from conftest import REPO

torch.set_num_threads(1)
BENCH_KEYS = ("metric", "value", "unit", "batch", "len", "padlen",
              "err_rate", "ms_per_pair", "ms_per_pair_resident", "h2d_share",
              "us_per_diag", "cells_per_s", "bound_ms", "bound_share",
              "device", "power_limit_w")


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["nt", "protein"])
def test_fuzz_plain_version_matches_oracle(path, capsys):
    """Short pairs, freq and leaf, through the plain version on CPU
    tensors, each byte-equal to talco_np."""
    rc = fuzz_talco.main(["--device", "cpu", "--n", "2", "--paths", path,
                          "--workers", "1"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err[-2000:]
    res = _last_json(captured.out)
    assert res["pairs"] == 4 and res["mismatches"] == 0
    assert res["device"] == "cpu" and res["route"] == "short"
    assert "plain PyTorch version" in captured.err


def test_fuzz_names_a_pair_that_differs(monkeypatch, capsys):
    """One path byte of the first pair that has a path, flipped in the
    plain version's output: the fuzz exits 1 and names that pair."""
    real = talco_cuda.talco_align_reference

    def flipped(*args, **kwargs):
        paths, tail = real(*args, **kwargs)
        i = int(np.flatnonzero(tail[:, 1].numpy() == 0)[0])
        paths[i, 0] = (paths[i, 0] + 1) % 3
        return paths, tail

    monkeypatch.setattr(talco_cuda, "talco_align_reference", flipped)
    rc = fuzz_talco.main(["--device", "cpu", "--n", "2", "--paths", "nt",
                          "--modes", "leaf", "--seed", "3", "--workers",
                          "1"])
    captured = capsys.readouterr()
    assert rc == 1
    assert _last_json(captured.out)["mismatches"] == 1
    assert "MISMATCH seed 3 route short nt leaf task 0 marker 1024 pair" \
        in captured.out


def test_bench_cpu_prints_the_keys_without_device_figures(capsys):
    rc = bench_kernel.main(["--device", "cpu", "--batch", "2", "--len", "80",
                            "--iters", "1", "--json"])
    assert rc == 0
    res = _last_json(capsys.readouterr().out)
    for key in BENCH_KEYS:
        assert key in res
    assert res["device"] == "cpu" and res["err_rate"] == 0
    assert res["metric"] == "plain_pairs_per_s_cpu" and res["value"] > 0
    assert res["batch"] == 2 and res["padlen"] == 2048
    for key in ("ms_per_pair_resident", "h2d_share", "bound_ms",
                "bound_share", "power_limit_w"):
        assert res[key] is None


@pytest.mark.parametrize("tool, argv", [
    (fuzz_talco, ["--n", "2"]),
    (bench_kernel, ["--batch", "2", "--json"]),
    (quality_harness, ["-n", "8", "-l", "50"]),
])
def test_tools_exit_without_a_card(tool, argv, capsys):
    """A run that did not ask for the CPU needs the card: without one it
    exits non-zero and says why, and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main(argv) != 0
    captured = capsys.readouterr()
    assert "torch.cuda.is_available() is false" in captured.err
    assert "{" not in captured.out


def test_quality_native_equals_jax_tool(capsys):
    """Every strategy's SP per pair and share of the true tree's, as the
    JAX package's harness gives them with the same arguments."""
    argv = ["-n", "60", "-l", "200", "--seed", "2", "--backend", "native",
            "--json"]
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "quality_harness.py")]
        + argv, cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    want = _last_json(r.stdout)
    assert quality_harness.main(argv) == 0
    got = _last_json(capsys.readouterr().out)
    assert (got["n"], got["l"], got["seed"]) == (60, 200, 2)
    assert list(got["results"]) == list(want["results"])
    for key, w in want["results"].items():
        g = got["results"][key]
        assert (g["sp_per_pair"], g["pct_of_true_tree"]) \
            == (w["sp_per_pair"], w["pct_of_true_tree"]), key
        assert g["launches"] == 0


def test_quality_cpu_backend_equals_native(monkeypatch, tmp_path):
    """The device forced on the cpu backend (the plain version in the
    batcher) gives every strategy the bytes of its native run."""
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    runs = {b: quality_harness.run(16, 100, 4, backend=b,
                                   workdir=str(tmp_path / b))
            for b in ("cpu", "native")}
    assert runs["cpu"]["backbone"]["md5"] == runs["native"]["backbone"]["md5"]
    assert set(runs["cpu"]["results"]) == set(runs["native"]["results"])
    for key, nat in runs["native"]["results"].items():
        cpu = runs["cpu"]["results"][key]
        assert cpu["md5"] == nat["md5"], key
        assert cpu["sp_per_pair"] == nat["sp_per_pair"], key


def test_trace_device_ms_sums_and_unions(tmp_path):
    """talco_inputs.trace_device_ms on a hand-written chrome trace: the
    TALCO kernels' time, every kernel's, the copies', and the card's busy
    time as the union of overlapping device intervals (us in, ms out);
    host events count for nothing."""
    from twilight_tpu_torch.tools.talco_inputs import trace_device_ms
    ev = [("kernel", "void talco_xdrop_kernel<22, false>(...)", 0, 100),
          ("kernel", "void talco_xdrop_kernel<22, true>(...)", 50, 100),
          ("kernel", "void at::native::fill(...)", 400, 10),
          ("gpu_memcpy", "Memcpy HtoD", 140, 20),
          ("gpu_memset", "Memset", 1000, 5),
          ("cpu_op", "aten::copy_", 0, 5000)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": c, "name": n, "ts": t, "dur": d, "ph": "X"}
        for c, n, t, d in ev] + [{"cat": "kernel", "name": "no dur"}]}))
    got = trace_device_ms(str(path))
    assert got == {"talco_ms": 0.2, "talco_kernels": 2, "kernel_ms": 0.21,
                   "copy_ms": 0.025, "busy_ms": 0.175}


def test_trace_device_ms_reads_a_cli_trace(tmp_path):
    """The CLI's --profile-trace on the CPU (the plain version): a trace
    that parses, with no device event in it."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.tools.talco_inputs import trace_device_ms
    prot = os.path.join(REPO, "tests", "data", "prot_16")
    assert cli.main(["--backend", "cpu", "-t", prot + ".nwk", "-i",
                     prot + ".fa", "--type", "p", "-o",
                     str(tmp_path / "p.aln"), "--profile-trace",
                     str(tmp_path / "tr")]) == 0
    got = trace_device_ms(str(tmp_path / "tr" / "trace.json"))
    assert got["talco_kernels"] == 0 and got["busy_ms"] == 0.0
