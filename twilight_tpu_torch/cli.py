"""Command line of the PyTorch/CUDA port.

The flags, option checks and pipeline are TWILIGHT-TPU's own, in the
port's copies (`config`, `pipeline.modes`); this module picks the DP
engine: `--backend cuda` runs the TALCO-XDrop kernel on every selected
GPU, `cpu` runs the same batcher with the kernel's plain PyTorch version on
CPU tensors, `native` and `numpy` run the host kernels, and `auto` (the
default) is `cuda` whenever a GPU is present and an error without one.
Under `cuda` the level gate (pipeline/aligner.py) still sends each level
to the host kernel or the card.

A host-only run (`--backend native|numpy`, `--devices 0`, `--cpu-only`,
also across hosts with `--hosts/--host-id`), `-h` and `--version` import
no torch: the modules that need it are imported in the branches that use
them.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from . import trace
from .config import (INT32_MAX, PLACE_WO_TREE, Options, Params,
                     detect_mode, detect_type)
from .parallel.distributed import (detect_topology, detect_topology_implicit,
                                   distributed_live)
from .pipeline import modes

BACKENDS = ("auto", "cuda", "cpu", "native", "numpy")
HOST_BACKENDS = ("native", "numpy")
_TAG = "[twilight-tpu-torch]"


def build_parser() -> argparse.ArgumentParser:
    """The flags of TWILIGHT-TPU's command line (the reference CLI,
    TWILIGHT src/twilight-main.cpp:16-83, plus the device knobs), with the
    port's backends."""
    p = argparse.ArgumentParser(
        prog="twilight-tpu-torch",
        description="Multiple sequence alignment (TWILIGHT-compatible) "
                    "with the TALCO-XDrop DP on an NVIDIA GPU")
    p.add_argument("-t", "--tree", help="Guide tree (Newick)")
    p.add_argument("-i", "--sequences", help="Unaligned sequences (FASTA)")
    p.add_argument("-a", "--alignment", help="Backbone alignment (FASTA)")
    p.add_argument("-f", "--files", help="Directory of MSA files to merge")
    p.add_argument("-o", "--output", required=False, help="Output file")
    p.add_argument("-d", "--temp-dir", help="Temporary directory")
    p.add_argument("-k", "--keep-temp", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="Skip subtrees whose checkpoints exist in the temp "
                        "dir (divide-and-conquer runs; use with -d and -k)")
    p.add_argument("-c", "--compress", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("-C", "--cpu", type=int, default=0,
                   help="CPU worker threads for the host DP kernel "
                        "(default: all cores; reference -C/--cpu-num)")
    p.add_argument("--type", choices=["n", "p"])
    p.add_argument("-m", "--max-subtree", type=int, default=INT32_MAX)
    p.add_argument("-r", "--remove-gappy", type=float, default=0.95)
    p.add_argument("-w", "--wildcard", action="store_true")
    p.add_argument("--rooted", action="store_true")
    p.add_argument("--prune", action="store_true")
    p.add_argument("--write-prune", action="store_true")
    p.add_argument("--length-deviation", type=float, default=0.0)
    p.add_argument("--max-ambig", type=float, default=0.1)
    p.add_argument("--max-len", type=int, default=INT32_MAX)
    p.add_argument("--min-len", type=int, default=0)
    p.add_argument("--filter", action="store_true")
    p.add_argument("--write-filtered", action="store_true")
    p.add_argument("--match", type=float, default=18.0)
    p.add_argument("--mismatch", type=float, default=-8.0)
    p.add_argument("--transition", type=float, default=-4.0)
    p.add_argument("--gap-open", type=float, default=-50.0)
    p.add_argument("--gap-extend", type=float, default=-5.0)
    p.add_argument("--gap-ends", type=float, default=None)
    p.add_argument("--xdrop", type=float, default=600.0)
    p.add_argument("-x", "--matrix", help="User substitution matrix file")
    p.add_argument("-b", "--blosum", type=int, default=62)
    p.add_argument("--check", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-V", "--version", action="version",
                   version="twilight-tpu-torch 0.1.0 (TWILIGHT-compatible, "
                           "reference v0.2.3)")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="DP engine: CUDA kernel (cuda), its plain PyTorch "
                        "version on the CPU (cpu), native C++ host kernel, "
                        "NumPy oracle, or auto")
    p.add_argument("--pair-batch", type=int, default=128,
                   help="alignment pairs per device launch")
    p.add_argument("-G", "--devices", type=int, default=None,
                   help="number of GPUs to use (default: all available; "
                        "reference GPU build's --gpu)")
    p.add_argument("--device-index", default=None,
                   help="comma-separated device indices to use, e.g. "
                        "0,2,3 (reference GPU build's --gpu-index)")
    p.add_argument("--cpu-only", action="store_true",
                   help="run only on the CPU (reference GPU build's "
                        "--cpu-only; same as --devices 0)")
    p.add_argument("--hosts", type=int, default=0,
                   help="multi-host subtree dispatch: total host count "
                        "(defaults to torch.distributed's world size when "
                        "a default process group is initialized)")
    p.add_argument("--host-id", type=int, default=-1,
                   help="this host's index (defaults to "
                        "torch.distributed's rank)")
    p.add_argument("--profile-trace", metavar="DIR",
                   help="capture a torch.profiler trace of the run into "
                        "DIR/trace.json (chrome trace format)")
    return p


def _validate_args(args) -> None:
    """Input validation mirroring the reference Option ctor
    (TWILIGHT src/option.cpp:49-97)."""
    if args.max_subtree <= 0:
        raise ValueError(
            "Invalid value for --max-subtree. The value of --max-subtree "
            f"should be a positive integer (got {args.max_subtree}).")
    if args.remove_gappy > 1 or args.remove_gappy <= 0:
        raise ValueError("Invalid value for --remove-gappy. The value of "
                         "--remove-gappy should be in (0,1]")
    if args.length_deviation < 0:
        raise ValueError("Invalid value for --length-deviation. The value "
                         "of --length-deviation should be non-negative")
    if args.max_ambig > 1 or args.max_ambig <= 0:
        raise ValueError("Invalid value for --max-ambig. The value of "
                         "--max-ambig should be in (0,1]")
    if args.max_len <= 0:
        raise ValueError(
            "Invalid value for --max-len. The value of --max-len should "
            f"be larger than 0 (got {args.max_len}).")
    if args.min_len < 0:
        raise ValueError(
            "Invalid value for --min-len. The value of --min-len should "
            f"be larger than 0 (got {args.min_len}).")
    if args.min_len >= args.max_len:
        raise ValueError(
            "Invalid value for --min-len and --max-len. --max-len should "
            f"be larger than --min-len (got --max-len: {args.max_len}, "
            f"--min-len: {args.min_len}).")
    if (args.min_len > 0 or args.max_len < INT32_MAX) \
            and args.length_deviation > 0:
        raise ValueError("Invalid arguments. --length-deviation cannot be "
                         "used together with --min-len or --max-len.")


def _check_output_file(args) -> None:
    """Output-exists guard + writability probe
    (TWILIGHT src/option.cpp:174-204). Like the reference, the probe
    creates and removes the (uncompressed-named) output file — so with
    --overwrite an existing output is cleared at startup."""
    out = args.output
    guarded = out + ".gz" if args.compress else out
    if not args.overwrite and os.path.exists(guarded):
        raise ValueError(
            f"{guarded} already exists. Please use another file name or "
            "add --overwrite to overwrite the existing file.")
    try:
        with open(out, "wb"):
            pass
        os.remove(out)
    except OSError:
        raise ValueError(f"failed to open file: {out}")


def _echo_config(opt: Options) -> None:
    """'====== Configuration =======' stderr block
    (TWILIGHT src/option.cpp:240-250)."""
    from .config import fmt_float
    err = sys.stderr
    print("====== Configuration =======", file=err)
    if opt.max_subtree != INT32_MAX:
        print(f"Max-subtree: {opt.max_subtree}", file=err)
    if opt.gappy_vertical == 1:
        print("Disable removing gappy columns.", file=err)
    else:
        print("Threshold for removing gappy columns: "
              f"{fmt_float(opt.gappy_vertical)}", file=err)
    if opt.len_dev > 0:
        print("Allowed deviation from the median length: "
              f"{fmt_float(opt.len_dev * 100)}%", file=err)
    elif opt.min_len > 0 or opt.max_len < INT32_MAX:
        print(f"Allowed sequence length range: [{opt.min_len}, "
              f"{opt.max_len}]", file=err)
    if opt.max_ambig < 1:
        print("Allowed proportion of ambiguous characters: "
              f"{fmt_float(opt.max_ambig * 100)}%", file=err)
    avail = os.cpu_count() or 1
    using = opt.cpu_num if opt.cpu_num > 0 else avail
    print(f"Maximum available CPU cores: {avail}. Using {using} CPU "
          "cores.", file=err)


def options_from_args(args) -> Options:
    mode = detect_mode(bool(args.tree), bool(args.sequences),
                       bool(args.files), bool(args.alignment))
    _validate_args(args)
    opt = Options(
        aln_mode=mode,
        tree_file=args.tree or "",
        seq_file=args.sequences or "",
        msa_dir=args.files or "",
        backbone_aln_file=args.alignment or "",
        out_file=args.output or "",
        max_subtree=args.max_subtree,
        gappy_vertical=args.remove_gappy,
        len_dev=args.length_deviation,
        max_ambig=args.max_ambig,
        max_len=args.max_len,
        min_len=args.min_len,
        write_filtered=args.write_filtered,
        debug=args.check,
        no_filter=not args.filter,
        reroot=not args.rooted,
        compressed=args.compress,
        print_detail=args.verbose,
        delete_temp=not args.keep_temp,
        resume=args.resume,
        n_hosts=1,
        host_id=0,
        device_backend=args.backend,
        pair_batch=args.pair_batch,
        cpu_num=max(0, args.cpu or 0),
        device_num=0 if args.cpu_only else args.devices,
        device_index=([int(x) for x in args.device_index.split(",") if x]
                      if args.device_index else None),
    )
    # cap requested workers at the hardware thread count, like the
    # reference (option.cpp:42-47)
    avail = os.cpu_count() or 1
    if opt.cpu_num > avail:
        print(f"Requested {opt.cpu_num} CPU cores, but only {avail} "
              "are available.", file=sys.stderr)
        opt.cpu_num = avail
    if args.type:
        opt.type = args.type
    else:
        seq_file = opt.seq_file
        if opt.msa_dir:
            entries = sorted(os.listdir(opt.msa_dir))
            seq_file = os.path.join(opt.msa_dir, entries[0]) if entries else ""
        opt.type = detect_type(seq_file) if seq_file else "n"
    _check_output_file(args)
    # temp dir (reference option.cpp:206-237)
    if (opt.max_subtree < INT32_MAX or opt.msa_dir
            or opt.aln_mode == PLACE_WO_TREE):
        if args.temp_dir:
            opt.temp_dir = args.temp_dir.rstrip("/")
            # exists-guard (option.cpp:228-233); --resume and multi-host
            # runs (flags or a live torch.distributed group) legitimately
            # share/reuse the directory
            if (os.path.exists(opt.temp_dir) and not args.overwrite
                    and not args.resume and not args.hosts
                    and not distributed_live()):
                raise ValueError(
                    f"{opt.temp_dir} already exists. In order to prevent "
                    "your file from being overwritten, please delete this "
                    "folder or use another folder name.")
            os.makedirs(opt.temp_dir, exist_ok=True)
        else:
            base = "./twilight_temp"
            temp = base
            idx = 1
            while os.path.exists(temp):
                temp = f"{base}_{idx}"
                idx += 1
            os.makedirs(temp)
            opt.temp_dir = temp
        print(f"{opt.temp_dir} created for storing temporary alignments")
    _echo_config(opt)
    return opt


def make_device_kernel(option: Options, param: Params):
    """The DP batcher of the resolved backend (ops/device_kernel.py, which
    imports torch)."""
    from .ops import device_kernel
    return device_kernel.make_device_kernel(option, param)


def resolve_backend(backend: str) -> str:
    """Resolve --backend auto: the card whenever there is one (the level
    gate then sends each level to the host or the card, as under
    --backend cuda); without a card it refuses to carry on on the host
    (RuntimeError). Any other choice stands as given."""
    if backend != "auto":
        return backend
    import torch
    if torch.cuda.is_available():
        print(f"{_TAG} auto backend: cuda "
              f"({torch.cuda.get_device_name(0)})", file=sys.stderr)
        return "cuda"
    raise RuntimeError("--backend auto found no CUDA device "
                       "(torch.cuda.is_available() is false); run on the "
                       "host with --backend native, --backend cpu or "
                       "--cpu-only")


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """`main`, returning (exit code, the DP batcher or None) so that a
    caller can read the batcher's counts. The run's tracer (`trace`)
    spans the call; its totals reach the batcher's stats."""
    t0_ns = time.perf_counter_ns()
    t_main0 = time.time()
    args = build_parser().parse_args(argv)
    tracer = trace.start(bool(args.profile_trace), t0_ns)
    kernel = None
    try:
        with trace.span("run.setup"):
            made = _setup(args)
        if made is None:
            return 1, None
        opt, param, kernel = made
        err = _align(args, opt, param, kernel, tracer)
    finally:
        trace.finish(tracer, kernel)
    if kernel is not None:
        if args.profile_trace:
            tracer.export(os.path.join(args.profile_trace, "trace.json"))
        print(kernel.summary(), file=sys.stderr)
    if err is not None:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1, kernel
    print(f"Total Execution in {time.time() - t_main0:.6f} s",
          file=sys.stderr)
    return 0, kernel


def _setup(args):
    """(options, scores, the DP batcher or None) of the parsed flags, or
    None after printing why the run cannot go on."""
    if not args.output:
        print("ERROR: Output file name is required.", file=sys.stderr)
        return None
    try:
        opt = options_from_args(args)
        if args.hosts or args.host_id >= 0:
            opt.n_hosts, opt.host_id = detect_topology(args.hosts,
                                                       args.host_id)
        else:
            opt.n_hosts, opt.host_id = detect_topology_implicit()
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return None
    if opt.n_hosts > 1 and not opt.temp_dir:
        print("ERROR: multi-host runs need a shared temp dir (-d) and "
              "divide-and-conquer (-m).", file=sys.stderr)
        return None
    param = Params.make(
        opt.type, match=args.match, mismatch=args.mismatch,
        transition=args.transition, gap_open=args.gap_open,
        gap_extend=args.gap_extend, gap_ends=args.gap_ends,
        xdrop_scale=args.xdrop, blosum=args.blosum,
        wildcard=args.wildcard, matrix_file=args.matrix)
    if args.verbose:
        from .config import dump_params
        dump_params(param, opt.type, args.blosum,
                    user_matrix=bool(args.matrix))
    kernel = None
    # --devices 0 / --cpu-only and the host kernels: host only, no torch
    if opt.device_num != 0 and opt.device_backend not in HOST_BACKENDS:
        try:
            # raises without a card (auto, cuda), or for a failed build
            opt.device_backend = resolve_backend(opt.device_backend)
            kernel = make_device_kernel(opt, param)
        except RuntimeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return None
    return opt, param, kernel


def _align(args, opt, param, kernel, tracer):
    """The pipeline (`modes.run`), under --profile-trace inside a
    torch.profiler that DIR/trace.json receives; the ValueError that
    stopped it, or None."""
    prof = None
    if args.profile_trace and kernel is not None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if kernel.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        tracer.profiler_started()
    try:
        modes.run(opt, param, kernel=kernel, prune=args.prune,
                  write_prune=args.write_prune)
    except ValueError as e:
        return e
    finally:
        if kernel is not None:
            kernel.close()
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.profile_trace, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile_trace, "trace.json"))
    return None


if __name__ == "__main__":
    sys.exit(main())
