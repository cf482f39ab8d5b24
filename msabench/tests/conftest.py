"""The benchmark's own tests (`python -m pytest msabench/tests`). The
repository's tests/conftest.py does not reach this folder, so the `cuda`
marker is registered here too. A test marked `cuda` decides inside the
test whether a card is there, and skips without one."""
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"config": "nt_default", "traffic": "tiny",
        "generator": {"n": 16, "length": 150, "mut_rate": 0.05,
                      "indel_rate": 0.02},
        "flags": [], "warmup": {"n": 4, "length": 60, "flags": []},
        "check": {"leaf_pairs": 4, "freq_pairs": 4}, "chips": 1,
        "why": "a cell small enough for a test run"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skips without one")


def add_cell(root: str, name: str, workload: dict) -> None:
    """Adds a cell to the copy at `root` as a new file plus a new
    BENCHMARK.json entry, listing it under every per-layer metric."""
    with open(os.path.join(root, "msabench", "workloads", name + ".json"),
              "w") as f:
        json.dump(workload, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": name, "config": workload["config"],
                               "traffic": workload["traffic"], "chips": 1,
                               "why": workload["why"]})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and msabench/ with a tiny cell added."""
    root = str(tmp_path / "checkout")
    shutil.copytree(HERE, os.path.join(root, "msabench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    add_cell(root, "nt.tiny", TINY)
    return root


def cpu_testing(root: str, **extra) -> dict:
    """Run.Bench's `testing` for a CPU run of the copy at `root`: the
    batcher's plain version on CPU tensors, every level handed to it."""
    return {"root": root, "here": os.path.join(root, "msabench"),
            "cpu": True, "flags": ["--backend", "cpu"],
            "env": {"TWILIGHT_FORCE_DEVICE": "1"}, **extra}
