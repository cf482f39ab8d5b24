"""Snakemake-style configuration surface for the workflow command.

The reference drives its iterative/placement pipeline through Snakemake
with `--config KEY=VALUE` pairs (TWILIGHT workflow/Snakefile:6-39,
config keys in workflow/config.yaml). This module accepts the SAME keys
on `twilight-tpu-torch-workflow --config ...` and translates them to the
workflow's argv, including the Snakefile's pre-flight overwrite guards
(`checkFiles`, Snakefile:44-60) with its exact error texts — so a
reference-workflow user can paste their `--config` line unchanged.
"""
from __future__ import annotations

import os
import sys
from typing import List

HELP = """\
TWILIGHT Iterative and Placement Mode (twilight-tpu-torch workflow command)

Usage:
    twilight-tpu-torch-workflow --config TYPE=VALUE SEQ=VALUE OUT=VALUE [OPTION=VALUE ...]
    twilight-tpu-torch-workflow --config TYPE=VALUE SEQ=VALUE OUT=VALUE ALN=VALUE [OPTION=VALUE ...]

Options (use with --config)
Iterative Mode:
    SEQ        Path to input unaligned sequence file. [Required]
    ITER       Total number of iterations (1-5). Default: 3.
    INITTREE   Tree estimation method for the initial guide tree: "dipper", "parttree", or "maffttree".
    ITERTREE   Tree estimation method for intermediate iterations: "dipper", "rapidnj" or "fasttree".
    FINALTREE  Final tree estimation method (skip if unspecified): "fasttree", "raxml" or "iqtree".
Placement Mode:
    ALN        Backbone alignment for placing new sequences. [Required]
    SEQ        New sequences to be placed [Required]
    TREE       Backbone tree [Optional, estimated from the backbone if unspecified]
    ITER       Total number of iterations (1-5). Default: 2.
    FINALTREE  Final tree estimation method (skip if unspecified): "fasttree", "raxml" or "iqtree".
General:
    TYPE       Input data type: "n" (nucleotide) or "p" (protein). [Required]
    OUT        Path to output MSA file. [Required]
    DIR        Directory for storing temporary files.
    KEEP       Keep the temporary files: "yes" or "no". (default: no)
    OVERWRITE  Overwrite the existing file: "yes" or "no". (default: no)

NOTES
    - Any unspecified option uses the workflow's default.
    - ITER values above 5 are not supported.
"""

_KNOWN = {"TYPE", "SEQ", "OUT", "ALN", "TREE", "ITER", "INITTREE",
          "ITERTREE", "FINALTREE", "DIR", "KEEP", "OVERWRITE"}


def _fail(msg: str) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(1)


def config_to_argv(argv: List[str]) -> List[str]:
    """Translate `--config K=V ...` (reference Snakefile keys) into the
    workflow's argv. Everything before `--config` passes through."""
    i = argv.index("--config")
    passthrough = list(argv[:i])
    pairs = argv[i + 1:]
    if not pairs:
        print(HELP)
        raise SystemExit(0)
    cfg = {}
    for p in pairs:
        if "=" not in p:
            _fail(f"ERROR: malformed --config entry '{p}' (expected "
                  "KEY=VALUE).")
        k, v = p.split("=", 1)
        if k not in _KNOWN:
            _fail(f"ERROR: unknown --config key '{k}'.")
        cfg[k] = v

    out = cfg.get("OUT", "")
    if out == "":
        _fail("ERROR: Please specify the output file name.")
    if "SEQ" not in cfg:
        _fail("ERROR: Please specify the input sequence file (SEQ=).")

    temp_dir = cfg.get("DIR") or (os.path.splitext(out)[0] + "_iter")
    overwrite = cfg.get("OVERWRITE", "no") == "yes"
    if not overwrite:
        # Snakefile checkFiles semantics (Snakefile:44-60)
        if os.path.isdir(temp_dir):
            _fail(f"ERROR: {temp_dir} already exists. Please use another "
                  "directory name or set OVERWRITE=yes.")
        if os.path.isfile(out):
            _fail(f"ERROR: {out} already exists. Please use another file "
                  "name or set OVERWRITE=yes.")
        if cfg.get("FINALTREE") and os.path.isfile(out + ".tree"):
            _fail(f"ERROR: {out}.tree already exists. Please use another "
                  "file name or set OVERWRITE=yes.")

    if "ITER" in cfg and cfg["ITER"] != "":
        try:
            iters = int(cfg["ITER"])
        except ValueError:
            _fail(f"ERROR: invalid ITER value '{cfg['ITER']}'.")
        if iters > 5:
            _fail("ERROR: ITER values above 5 are not supported.")
        if iters < 1:
            _fail("ERROR: ITER must be at least 1.")

    args = passthrough + ["-i", cfg["SEQ"], "-o", out, "-d", temp_dir]
    if cfg.get("TYPE") in ("n", "p"):
        args += ["--type", cfg["TYPE"]]
    if cfg.get("ALN"):
        args += ["-a", cfg["ALN"]]
    if cfg.get("TREE"):
        args += ["-t", cfg["TREE"]]
    if cfg.get("ITER"):
        args += ["-n", cfg["ITER"]]
    if cfg.get("INITTREE"):
        args += ["--init-tree", _tool(cfg["INITTREE"])]
    if cfg.get("ITERTREE"):
        args += ["--iter-tree", _tool(cfg["ITERTREE"])]
    if cfg.get("FINALTREE"):
        args += ["--final-tree", _tool(cfg["FINALTREE"])]
    if cfg.get("KEEP", "no") == "yes":
        args += ["-k"]
    return args


def _tool(name: str) -> str:
    """Map Snakefile tool names onto adapter keys (trees/external.py)."""
    return {"maffttree": "mafft"}.get(name, name)
