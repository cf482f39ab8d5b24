"""The port's tracer (`twilight_tpu_torch.trace`) through `cli.run` on the
CPU: under an open torch.profiler the batcher's stats hold the span and
counter totals, and the run thread's seven groups of self time add up to
the `run` span; without a profiler, flag or variable the run keeps no
record and the stats gain no key; the output is the same bytes either
way; and `--profile-trace` puts the batcher thread's spans on the trace's
clock, inside the run thread's level ranges."""
import filecmp
import json
import os
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import DATA
from twilight_tpu_torch import cli, trace
from twilight_tpu_torch.tools import simulate

# the run thread's spans, grouped as the benchmark's host metrics read them
MAIN = {"host_io_s": ("io.tree", "io.read", "io.write", "subtree.store"),
        "host_setup_s": ("run.setup", "tree.partition", "tree.subtree",
                         "schedule"),
        "host_prep_s": ("level.prep",),
        "host_dp_s": ("level.dp_host",),
        "host_post_s": ("level.post", "root_update"),
        "wait_batcher_s": ("level.wait",),
        "host_other_s": ("run", "level", "deferred", "subtree", "merge")}
BATCHER = ("batcher.pack", "batcher.wait")
COUNTS = ("levels_card", "levels_host", "pairs_card", "pairs_host",
          "deferred", "bytes_written", "pairs_prep_native", "pairs_prep_py")


@pytest.fixture(scope="module")
def sim16(tmp_path_factory):
    """16 nucleotide sequences of ~60 letters (prot_16's count), small
    enough for the batcher's plain version."""
    prefix = str(tmp_path_factory.mktemp("sim") / "s16")
    assert simulate.main(["-n", "16", "-l", "60", "--seed", "4", "-o",
                          prefix]) == 0
    return prefix


def _route(name, sim16, monkeypatch):
    """(input prefix, extra flags) of a route: `card` forces every level
    to the batcher (no stealing), `host` leaves prot_16's levels to the
    gate, which keeps them on the host."""
    monkeypatch.delenv("TWILIGHT_PROFILE", raising=False)
    if name == "card":
        monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
        monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
        return sim16, []
    monkeypatch.delenv("TWILIGHT_FORCE_DEVICE", raising=False)
    return os.path.join(DATA, "prot_16"), ["--type", "p"]


def _run(prefix, out, flags, monkeypatch):
    """(the batcher, the run's tracer) of one `cli.run`."""
    tracers = []
    start = trace.start
    monkeypatch.setattr(trace, "start",
                        lambda *a: tracers.append(start(*a)) or tracers[-1])
    rc, kernel = cli.run(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                          "-o", out, "--backend", "cpu", *flags])
    assert rc == 0 and kernel is not None and len(tracers) == 1
    return kernel, tracers[0]


@pytest.mark.parametrize("route", ["card", "host"])
def test_spans_split_the_run(route, sim16, tmp_path, monkeypatch):
    prefix, flags = _route(route, sim16, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        kernel, tr = _run(prefix, str(tmp_path / "on.aln"), flags,
                          monkeypatch)
    st = kernel.stats
    names = [k for keys in MAIN.values() for k in keys]
    assert {f"span_ns.{k}" for k in names + list(BATCHER)} <= set(st)
    assert {f"count.{k}" for k in COUNTS} <= set(st)
    # every span of the run thread belongs to one of the seven groups,
    # and their self times add up to the run's span
    runs = [s for s in tr.records if s.name == "run"]
    assert len(runs) == 1
    main = {s.name for s in tr.records if s.tid == runs[0].tid}
    assert main <= set(names)
    total = sum(st[f"span_ns.{k}"] for k in names)
    assert abs(total - runs[0].ns) <= 0.01 * runs[0].ns
    assert st["count.pairs_card"] == st["pairs"]
    # every level's pairs prepped, all in the native level prep
    assert st["count.pairs_prep_native"] == (st["count.pairs_card"]
                                             + st["count.pairs_host"])
    assert st["count.pairs_prep_py"] == 0
    if route == "card":
        assert st["count.levels_host"] == 0 and st["count.levels_card"] > 0
        assert st["dp_cells"] > 0 and st["span_ns.batcher.pack"] > 0
        assert st["span_ns.level.wait"] > 0
    else:
        assert st["count.levels_card"] == 0 and st["count.levels_host"] > 0
        assert st["count.pairs_host"] > 0 and st["span_ns.level.dp_host"] > 0
    assert st["count.bytes_written"] == (tmp_path / "on.aln").stat().st_size

    # off: no record, no new key but dp_cells, and the same bytes
    kernel, tr = _run(prefix, str(tmp_path / "off.aln"), flags, monkeypatch)
    st = kernel.stats
    assert not tr.on and tr.records == []
    assert not [k for k in st if k.startswith(("span_ns.", "count."))]
    assert "dp_cells" in st
    assert filecmp.cmp(tmp_path / "on.aln", tmp_path / "off.aln",
                       shallow=False)


def test_profile_trace_places_every_thread(sim16, tmp_path, monkeypatch):
    """Under --profile-trace each batcher call, timed on the batcher's
    own thread, lies inside the run thread's `twilight.level` range that
    made it: the clock's anchor puts both on the trace's clock."""
    prefix, flags = _route("card", sim16, monkeypatch)
    kernel, _ = _run(prefix, str(tmp_path / "p.aln"),
                     flags + ["--profile-trace", str(tmp_path / "tr")],
                     monkeypatch)
    st = kernel.stats
    assert st["span_ns.batcher.call"] > 0
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    main = threading.get_native_id()
    levels = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == "twilight.level"]
    calls = [e for e in events if e.get("cat") == "twilight"
             and e["name"] == "batcher.call"]
    assert levels and len(calls) == st["count.levels_card"]
    assert all(e["tid"] != main for e in calls)
    for e in calls:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in levels), e
    mine = {e["name"] for e in events
            if e.get("cat") == "twilight" and e["tid"] == main}
    assert {"run", "level", "level.prep", "level.post", "io.write"} <= mine
