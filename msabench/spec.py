"""Finds what BENCHMARK.json names: a cell's configuration file, its
workload file and the reader of each metric, by name alone.

- configs/<config>.json (the path BENCHMARK.json's `file` gives): the
  deployment's flags, alphabet and scores;
- workloads/<cell>.json: the generator's parameters and the cell's flags;
- metrics/<metric>.py: `read(rec)`, the metric's value from the run's
  record (run.py's `Run.record`), or None where the run has nothing to
  read, in which case the metric is left out of the result.

A new cell or metric is a new file here plus a new entry in
BENCHMARK.json; no existing file changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell(bench: dict, name: str, root: str = ROOT, here: str = HERE) -> dict:
    """The cell `name`: its BENCHMARK.json entry (`entry`), its
    configuration's entry (`config_entry`) and file (`config`), and its
    workload file (`workload`)."""
    entry = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], entry["config"], "configuration")
    with open(os.path.join(root, cfg_entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(here, "workloads", name + ".json")) as f:
        wl = json.load(f)
    if wl["config"] != entry["config"] or wl["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json is for {wl['config']} / "
                         f"{wl['traffic']}, BENCHMARK.json says "
                         f"{entry['config']} / {entry['traffic']}")
    return {"entry": entry, "config_entry": cfg_entry, "config": cfg,
            "workload": wl}


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell `name` reports: the end-to-end ones
    without --trace, the per-layer ones with it; a metric with a
    `workloads` list only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str, here: str = HERE):
    """`read` of metrics/<metric>.py (a name may hold dots)."""
    path = os.path.join(here, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "msabench.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
