"""Command line of the PyTorch/CUDA port.

The flags, option checks and pipeline are TWILIGHT-TPU's own
(`twilight_tpu.cli`, `twilight_tpu.pipeline.modes`); this module picks the
DP engine: `--backend cuda` runs the TALCO-XDrop kernel on the first
selected GPU, `cpu` runs the same batcher with the kernel's plain PyTorch
version on CPU tensors, `native` and `numpy` run the host kernels, and
`auto` takes the host kernel for small workloads and single-core hosts,
else the GPU when there is one.
"""
from __future__ import annotations

import os
import sys
import time

import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu.config import Params
from twilight_tpu.ops import talco_host
from twilight_tpu.pipeline import modes

from .ops.device_kernel import make_device_kernel

BACKENDS = ("auto", "cuda", "cpu", "native", "numpy")
_TAG = "[twilight-tpu-torch]"


def build_parser():
    p = tpu_cli.build_parser()
    p.prog = "twilight-tpu-torch"
    p.description = ("Multiple sequence alignment (TWILIGHT-compatible) "
                     "with the TALCO-XDrop DP on an NVIDIA GPU")
    for action in p._actions:
        if action.dest == "backend":
            action.choices = BACKENDS
            action.help = ("DP engine: CUDA kernel (cuda), its plain "
                           "PyTorch version on the CPU (cpu), native C++ "
                           "host kernel, NumPy oracle, or auto")
        elif action.dest == "profile_trace":
            action.help = ("capture a torch.profiler trace of the run into "
                           "DIR/trace.json (chrome trace format)")
        elif action.dest in ("hosts", "host_id"):
            action.help = "multi-host runs are not ported yet"
    return p


def _pick_backend(opt, param) -> str:
    """Resolve --backend auto; any other choice stands as given."""
    backend = opt.device_backend
    if backend != "auto":
        return backend
    if tpu_cli._single_core_host() or tpu_cli._small_workload(opt, param):
        print(f"{_TAG} small workload: using the native host kernel "
              "(--backend cuda forces the device)", file=sys.stderr)
        return "native"
    if torch.cuda.is_available():
        print(f"{_TAG} auto backend: cuda "
              f"({torch.cuda.get_device_name(0)})", file=sys.stderr)
        return "cuda"
    print(f"{_TAG} auto backend: no CUDA device; using the native host "
          "kernel", file=sys.stderr)
    return "native"


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """`main`, returning (exit code, the DP batcher or None) so that a
    caller can read the batcher's counts."""
    t_main0 = time.time()
    args = build_parser().parse_args(argv)
    if not args.output:
        print("ERROR: Output file name is required.", file=sys.stderr)
        return 1, None
    if args.hosts or args.host_id >= 0:
        print("ERROR: multi-host runs (--hosts/--host-id) are not ported to "
              "twilight-tpu-torch yet.", file=sys.stderr)
        return 1, None
    try:
        opt = tpu_cli.options_from_args(args)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1, None
    param = Params.make(
        opt.type, match=args.match, mismatch=args.mismatch,
        transition=args.transition, gap_open=args.gap_open,
        gap_extend=args.gap_extend, gap_ends=args.gap_ends,
        xdrop_scale=args.xdrop, blosum=args.blosum,
        wildcard=args.wildcard, matrix_file=args.matrix)
    if args.verbose:
        from twilight_tpu.config import dump_params
        dump_params(param, opt.type, args.blosum,
                    user_matrix=bool(args.matrix))
    kernel = None
    if opt.device_num != 0:    # --devices 0 / --cpu-only: host only
        opt.device_backend = _pick_backend(opt, param)
        try:
            # raises for --backend cuda without a card, or a failed build
            kernel = make_device_kernel(opt, param)
        except RuntimeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1, None
    if opt.device_backend != "numpy":
        # load the native host kernel here, on the main thread: the first
        # level's pool threads would otherwise race its lazy load
        # (talco_host.get_lib marks it checked before the library is
        # bound), and a thread that loses runs the NumPy oracle instead
        talco_host.get_lib()
    prof = None
    if args.profile_trace and kernel is not None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if kernel.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    err = None
    try:
        modes.run(opt, param, kernel=kernel, prune=args.prune,
                  write_prune=args.write_prune)
    except ValueError as e:
        err = e
    finally:
        if kernel is not None:
            kernel.close()
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.profile_trace, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile_trace, "trace.json"))
    if kernel is not None:
        print(kernel.summary(), file=sys.stderr)
    if err is not None:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1, kernel
    print(f"Total Execution in {time.time() - t_main0:.6f} s",
          file=sys.stderr)
    return 0, kernel


if __name__ == "__main__":
    sys.exit(main())
