"""One run of one cell of the port's benchmark (README.md beside this
file): `python3 -m msabench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`.

Set-up imports torch, opens the CUDA context, installs the seam on the
DP batcher and runs one small warm-up alignment of the cell's alphabet
and flags, which loads the kernel libraries (built into the checkout on
the first run there) and the host libraries. The window then runs
`twilight_tpu_torch.cli.run`, one call an alignment, each on its own
input made from (seed, index), back to back until the alignments have
taken `--seconds`; the one in flight then is finished and counted. After
the window the run reads its peaks, frees the program, judges every
written alignment and a seeded sample of the batcher's pairs against the
plain reference, and prints one JSON line last on stdout.
"""
from __future__ import annotations

import time

_T_START = time.time()   # set-up is counted from here

import argparse
import contextlib
import json
import os
import resource
import subprocess
import sys
import tempfile

from . import judge, spec
from .simulate import simulate, write_input

FORBIDDEN = ("jax", "jaxlib", "flax", "twilight_tpu")
CACHE_DIR = os.path.join(spec.ROOT, ".msabench_cache")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="msabench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is jax, jaxlib, flax or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def set_environment() -> None:
    """The user's default run: none of the program's debug switches, and
    every kernel cache at a fixed place inside the checkout."""
    for k in list(os.environ):
        if k.startswith("TWILIGHT_") or k.startswith("TW_DEBUG"):
            del os.environ[k]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


@contextlib.contextmanager
def program_output(log):
    """Sends what the program prints (Python and native code alike) to
    `log`, so that the benchmark's own lines stay last."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(saved[0])
        os.close(saved[1])


def card_lines() -> list:
    """The card's name, power limit and clocks (nvidia-smi), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return [f"card: {ln}" for ln in out.stdout.strip().splitlines()]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"card: nvidia-smi failed: {e}"]


class NoCard(RuntimeError):
    pass


class Window:
    """What one measured window did."""

    def __init__(self):
        self.inputs = []          # (fasta, newick) an alignment
        self.outputs = []
        self.align_s = []
        self.run_starts = []
        self.failed = 0
        self.stats = {}
        self.cpu_s = 0.0
        self.trace = None
        self.rec = None


class Bench:
    """A cell's set-up, and the windows run on it. `testing`, for the
    harness's own tests only, may name another checkout (`root`) and
    benchmark folder (`here`), run on the CPU without looking for a card
    (`cpu`), add CLI flags and environment, break the batcher under the
    seam (`fault(batcher)`) and alter each written alignment
    (`after_align(path)`)."""

    def __init__(self, workload: str, work: str, testing=None):
        self.testing = testing or {}
        root = self.testing.get("root", spec.ROOT)
        self.here = self.testing.get("here", spec.HERE)
        self.bench = spec.load_benchmark(root)
        self.name = workload
        self.cell = spec.cell(self.bench, workload, root=root, here=self.here)
        self.cfg = self.cell["config"]
        self.wl = self.cell["workload"]
        self.type = self.cfg["type"]
        self.chips = self.cell["entry"]["chips"]
        self.work = work
        import torch
        self.torch = torch
        self.setup_parts = {"python_and_torch_import": time.time() - _T_START}
        self.cuda = not self.testing.get("cpu")
        if self.cuda and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < self.chips):
            raise NoCard(
                f"the cell needs {self.chips} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"device count {torch.cuda.device_count()}")
        self.log = open(os.path.join(work, "program.log"), "w")

    def close(self) -> None:
        self.log.close()

    def make_input(self, tag: str, index: int, gen: dict, seed: int):
        gen = {**self.wl["generator"], **gen}
        names, seqs, nwk = simulate(gen, self.type, tag, index, seed)
        prefix = os.path.join(self.work, f"{tag}_{seed}_{index}")
        return write_input(prefix, names, seqs, nwk), names, seqs

    def align(self, files, flags, tag: str):
        """One `cli.run` on files; (exit code, batcher or None, output)."""
        fa, nwk = files
        out = os.path.join(self.work, f"{tag}.aln")
        argv = ["-t", nwk, "-i", fa, "-o", out, *self.cfg["flags"], *flags,
                *self.testing.get("flags", [])]
        if "-m" in flags:
            argv += ["-d", os.path.join(self.work, f"{tag}_tmp")]
        with program_output(self.log):
            try:
                rc, kernel = self.cli.run(argv)
            except Exception as e:       # a crash is a failed alignment
                print(f"msabench: cli.run raised {e!r}", file=sys.stderr)
                rc, kernel = 1, None
        if self.cuda:
            self.torch.cuda.synchronize()
        if "after_align" in self.testing and os.path.exists(out):
            self.testing["after_align"](out)
        return rc, kernel, out

    def setup(self, seed: int) -> None:
        """Environment, CUDA context, seam and the warm-up alignment."""
        from . import seam
        set_environment()
        os.environ.update(self.testing.get("env", {}))
        t0 = time.time()
        if self.cuda:
            self.torch.zeros(1, device="cuda")
        t1 = time.time()
        from twilight_tpu_torch import cli
        from twilight_tpu_torch.ops import build
        self.cli = cli
        t2 = time.time()
        chk = self.wl["check"]
        self.rec = seam.Recorder(chk["leaf_pairs"], chk["freq_pairs"],
                                 6 if self.type == "n" else 22)
        seam.install(self.rec, self.testing.get("fault"))
        wu = self.wl["warmup"]
        files, _, _ = self.make_input(self.name + ".warmup", 0, wu, seed)
        t3 = time.time()
        rc, _, _ = self.align(files, wu["flags"], "warmup")
        self.setup_parts.update(
            cuda_context=t1 - t0, port_import=t2 - t1, warmup_input=t3 - t2,
            warmup_alignment=time.time() - t3,
            nvcc_in_warmup=build.build_seconds or 0.0)
        if rc != 0:
            raise RuntimeError(f"the warm-up alignment failed (exit {rc}); "
                               f"the program's last output:\n{self.tail()}")

    def window(self, seed: int, seconds: float, trace: bool,
               first=None) -> Window:
        """Alignments back to back until they have taken `seconds`."""
        from torch.profiler import record_function
        win = Window()
        win.rec = rec = self.rec
        rec.reset(seed)
        rec.every_launch = trace
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        cpu0 = _cpu()
        index = 0
        while True:
            if first is not None and index == 0:
                files, names, seqs = first
            else:
                files, names, seqs = self.make_input(self.name, index, {},
                                                     seed)
            counts = {}
            for s in seqs:
                counts[s] = counts.get(s, 0) + 1
            rec.unique = {s.encode(): n for n, s in zip(names, seqs)
                          if counts[s] == 1}
            rec.index = index
            rec.active = True
            t0 = time.perf_counter()
            with record_function(f"msabench.cli_run#{index}"):
                rc, kernel, out = self.align(files, self.wl["flags"],
                                             f"aln_{seed}_{index}")
            t1 = time.perf_counter()
            rec.active = False
            rec.drain()
            win.inputs.append(files)
            win.outputs.append(out)
            win.align_s.append(t1 - t0)
            win.run_starts.append(t0)
            win.failed += rc != 0
            if kernel is not None:
                for k, v in kernel.stats.items():
                    if isinstance(v, int):
                        win.stats[k] = win.stats.get(k, 0) + v
            index += 1
            if sum(win.align_s) >= seconds:
                break
        win.cpu_s = _cpu() - cpu0
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(self.work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            from .trace import reduce
            win.trace = reduce(path, win.run_starts,
                               [(a, b) for _, a, b in rec.spans])
            os.remove(path)
        return win

    def tail(self, n: int = 3000) -> str:
        self.log.flush()
        with open(self.log.name, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode("utf-8", "replace")


def _host_s_per_col():
    """The port's calibration of its host DP, which its level gate acts
    on (measured once a process, in the warm-up)."""
    from twilight_tpu_torch.pipeline import aligner
    return aligner._host_s_per_col


def _cpu() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def record_of(win: Window, setup_s: float, peak_rss: int) -> dict:
    """What the metric readers read (spec.reader)."""
    rec = win.rec
    return {"setup_s": setup_s, "align_s": win.align_s,
            "peak_rss_bytes": peak_rss, "stats": win.stats,
            "batcher_spans": rec.spans, "ops": rec.ops, "bytes": rec.bytes,
            "trace": win.trace}


def main(argv=None, testing=None) -> int:
    """Runs one cell; returns the exit code."""
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="msabench-") as work:
        try:
            b = Bench(args.workload, work, testing)
        except NoCard as e:
            print(f"msabench: {e}", file=sys.stderr)
            return 2
        try:
            return _measure(b, args)
        finally:
            b.close()


def _measure(b: Bench, args) -> int:
    try:
        b.setup(args.seed)
    except RuntimeError as e:
        print(f"msabench: {e}", file=sys.stderr)
        return 1
    t0 = time.time()
    first = b.make_input(b.name, 0, {}, args.seed)
    b.setup_parts["first_input"] = time.time() - t0
    setup_s = time.time() - _T_START
    win = b.window(args.seed, args.seconds, bool(args.trace), first)
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    peak_dev = b.torch.cuda.max_memory_allocated(0) if b.cuda else 0
    if b.cuda:
        b.torch.cuda.empty_cache()
    record = record_of(win, setup_s, peak_rss)
    checks, info = judge.judge(b, win)
    if win.trace is not None:
        # the seam must see the launches whose kernels the trace shows
        checks["launches_unseen"] = (
            int(win.trace["kernel_s"] > 0 and win.rec.launches == 0), 0)
    found = forbidden_modules()
    checks["forbidden_modules"] = (len(found), 0)

    wall = sum(win.align_s)
    lines = [*(card_lines() if b.cuda else []),
             f"window: {len(win.align_s)} alignments in {wall:.3f} s; "
             f"process CPU {win.cpu_s:.3f} s (CPU/wall "
             f"{win.cpu_s / wall:.2f})",
             "batcher: " + " ".join(f"{k}={v}" for k, v in
                                    sorted(win.stats.items())),
             f"device: peak {peak_dev} bytes allocated; launches read "
             f"{win.rec.launches}",
             "judged: " + " ".join(f"{k}={v}" for k, v in info.items()),
             "setup: " + " ".join(f"{k}={v:.3f}s" for k, v in
                                  b.setup_parts.items()),
             "alignments (s): " + " ".join(f"{t:.3f}" for t in win.align_s),
             f"level gate: host DP {_host_s_per_col()} s a column"]
    if found:
        lines.append("forbidden modules loaded: " + " ".join(found))
    if win.failed:
        lines.append("the program's last output:\n" + b.tail())
    for ln in lines:
        print(ln, file=sys.stderr)
    if found:
        return 3
    correct = (all(v <= lim for v, lim in checks.values())
               and judge.all_judged(info))
    metrics = {}
    for m in spec.metrics_of(b.bench, b.name, bool(args.trace)):
        value = spec.reader(m["name"], b.here)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if b.cuda else "cpu",
              "kind": b.torch.cuda.get_device_name(0) if b.cuda else "cpu",
              "count": b.chips, "memory_peak_bytes": peak_dev}
    result = {"correct": bool(correct), "attempted": len(win.align_s),
              "failed": win.failed, "metrics": metrics, "device": device}
    if win.trace is not None:
        device["busy_s"] = win.trace["busy_s"]
        device["window_s"] = win.trace["window_s"]
        result["breakdown"] = {"device_ops": win.trace["device_ops"],
                               "idle_gaps": win.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
