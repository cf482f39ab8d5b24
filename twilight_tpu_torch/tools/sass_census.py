"""SASS census of the port's CUDA kernels: the instruction mix of every
kernel instance that `ops/build.py` builds.

The counterpart of tools/mosaic_census.py, which counts the Mosaic IR ops
of the grouped Pallas kernel's loop bodies. Here the compiler's output is
SASS: `cuobjdump -sass` of each library of `build.SOURCES`
(`talco_xdrop.cu`: the four `talco_xdrop_kernel<P, Leaf>` instances;
`probe_loop_costs.cu`: the nine probe variants, each as one block,
`probe_loop_kernel<V>`, and as one cluster, `probe_cluster_kernel<V>`).
Each function's instructions are counted by class after stripping the
predicate (`@P0`, `@!PT`) and the modifiers (`.64`, `.E`, `.STRONG.GPU`):

- fp32: FADD, FMUL, FFMA, FMNMX, FSETP, FSEL, FCHK, MUFU, ...
- integer: IADD3, IMAD, LOP3, ISETP, SHF, LEA, SEL, PRMT, VIADD, ... (and
  their uniform-datapath forms)
- move: MOV, S2R, LDC, CS2R, R2UR, ... (registers, constants, special
  registers, predicates)
- shared: LDS, STS, ATOMS, LDSM, STAS (st.async into a cluster peer's
  shared memory); global: LDG, STG, ATOMG, RED, LDGSTS; local: LDL, STL
  (spills and stack arrays)
- barrier: BAR, SYNCS (mbarriers), MEMBAR, WARPSYNC, DEPBAR, UCGABAR_ARV
  and UCGABAR_WAIT (the cluster barrier's arrive and wait), ...
- warp: SHFL, VOTE, MATCH, REDUX, ELECT, ENDCOLLECTIVE
- branch: BRA, BSSY, BSYNC, CALL, RET, EXIT, ...
- conversion: F2I, I2F, F2F, I2I, F2FP, ...
- other: every opcode the table does not know, listed by name (f64
  arithmetic, for instance, would show here).

Each instance also lists its loops: the instructions from a backward
branch's target to the branch, by opcode (what a loop trip issues, where
the loop has no branch inside it).

Two invariants show at the instruction level. The kernels are built with
-fmad=false, yet FFMA appears where the correctly rounded f32 division
(-prec-div=true) runs its Newton steps with an explicit fma; the census
counts FFMA and FCHK (the division's range check) side by side and does
not treat FFMA as a fault. LDL/STL are local-memory traffic, which must be
absent where cudaFuncGetAttributes reports no local bytes (chip_smoke.py's
`census` phase holds that).

    python -m twilight_tpu_torch.tools.sass_census [--json] [--listing FILE]

--listing parses a saved `cuobjdump -sass` listing instead of the built
libraries. Without it the tool builds the libraries if need be (nvcc) and
finds cuobjdump beside nvcc, else in Triton's bundled CUDA tools; when
there is none it raises naming the tool.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

from ..ops.probe_loop import CLUSTER_VARIANTS, KERNEL_ID

CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK",
             "MUFU", "FSET", "FRND", "FSWZADD"),
    "integer": ("IADD3", "IMAD", "LOP3", "ISETP", "SHF", "LEA", "IABS",
                "SEL", "PRMT", "IMNMX", "VIMNMX", "IMUL", "IADD", "ISCADD",
                "POPC", "FLO", "BREV", "BMSK", "SGXT", "PLOP3", "UIADD3",
                "UIMAD", "ULOP3", "USHF", "ULEA", "UISETP", "USEL",
                "UPRMT", "UFLO", "UPOPC", "UBMSK", "USGXT", "UPLOP3",
                "UIMNMX", "UBREV", "VIADD", "VIADDMNMX", "VIMNMX3"),
    "move": ("MOV", "MOV32I", "UMOV", "S2R", "S2UR", "CS2R", "LDC", "ULDC",
             "R2UR", "P2R", "R2P", "UP2UR"),
    "shared": ("LDS", "STS", "ATOMS", "LDSM", "STSM", "STAS"),
    "global": ("LDG", "STG", "ATOMG", "RED", "LDGSTS", "ATOM", "LD", "ST"),
    "local": ("LDL", "STL"),
    "barrier": ("BAR", "SYNCS", "MEMBAR", "WARPSYNC", "DEPBAR", "LDGDEPBAR",
                "ERRBAR", "FENCE", "CCTL", "ARRIVES", "UCGABAR_ARV",
                "UCGABAR_WAIT", "CGAERRBAR"),
    "warp": ("SHFL", "VOTE", "VOTEU", "MATCH", "REDUX", "ELECT",
             "ENDCOLLECTIVE"),
    "branch": ("BRA", "BRX", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "JMP",
               "JMX", "BREAK", "KILL", "BPT"),
    "conversion": ("F2I", "I2F", "F2F", "I2I", "F2FP", "I2FP", "F2IP"),
}
CLASS_ORDER = tuple(CLASSES) + ("other",)
_CLASS_OF = {op: cls for cls, ops in CLASSES.items() for op in ops}
KERNELS = ("talco_xdrop_kernel", "probe_loop_kernel", "probe_cluster_kernel")
# the probe kernels' variant names, by their template argument V
PROBE_VARIANTS = tuple(sorted(KERNEL_ID, key=KERNEL_ID.get))
# a probe kernel's layout (ops/probe_loop.LAYOUTS), by its name
PROBE_LAYOUTS = {"probe_loop_kernel": "block",
                 "probe_cluster_kernel": "cluster"}
EXPECTED = tuple(f"talco_xdrop_kernel<{p}, {leaf}>" for p in (6, 22)
                 for leaf in ("false", "true")) + tuple(
    f"probe_loop_kernel<{v}>" for v in range(len(PROBE_VARIANTS))) + tuple(
    f"probe_cluster_kernel<{KERNEL_ID[n]}>" for n in CLUSTER_VARIANTS)

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)\s*$", re.M)
# "/*0070*/  @!P0 BRA 0x1a0 ;": the address, then the instruction up to
# its ";" (the encoding lines "/* 0x... */" never match)
_INSTR = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+([^;]*?)\s*;", re.M)
_PRED = re.compile(r"^@!?U?P[0-9T]+\s+")
_BRA_TARGET = re.compile(r"^BRA(?:\.\S+)?\s+0x([0-9a-fA-F]+)$")


def opcode(instr: str) -> str:
    """The opcode of one instruction's text, without predicate and
    modifiers: "@!P0 LDG.E.64.STRONG.GPU R2, [R4.64]" gives "LDG"."""
    return _PRED.sub("", instr.strip()).split(None, 1)[0].split(".")[0]


def split_functions(text: str) -> List[Tuple[str, List[Tuple[int, str]]]]:
    """[(mangled name, [(address, instruction text)])] of a cuobjdump
    -sass listing."""
    heads = list(_FUNCTION.finditer(text))
    out = []
    for k, m in enumerate(heads):
        end = heads[k + 1].start() if k + 1 < len(heads) else len(text)
        out.append((m.group(1), [(int(a, 16), i) for a, i in
                                 _INSTR.findall(text, m.end(), end)]))
    return out


def _demangle_fallback(name: str) -> str:
    """The instance of a known kernel from its Itanium-mangled name
    (template arguments Li<n>E and Lb<0|1>E), else the name itself."""
    for kern in KERNELS:
        m = re.search(kern + r"I((?:L[a-z]+\d+E)+)E", name)
        if m:
            args = []
            for kind, val in re.findall(r"L([a-z]+)(\d+)E", m.group(1)):
                args.append(("true" if val != "0" else "false")
                            if kind == "b" else val)
            return f"{kern}<{', '.join(args)}>"
    return name


def demangle(names: List[str]) -> Dict[str, str]:
    """{mangled: demangled} by cu++filt or c++filt where present, else by
    the fallback (known kernels' template arguments)."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool and names:
        r = subprocess.run([tool], input="\n".join(names) + "\n",
                           capture_output=True, text=True, timeout=60)
        got = r.stdout.splitlines()
        if r.returncode == 0 and len(got) == len(names):
            return dict(zip(names, got))
    return {n: _demangle_fallback(n) for n in names}


def _template_arg(arg: str) -> str:
    """"(bool)0" gives "false", "(int)7" gives "7" (demanglers spell the
    arguments of a kernel in an anonymous namespace with casts)."""
    m = re.fullmatch(r"\((\w+)\)(\d+)", arg.strip())
    if m is None:
        return arg.strip()
    if m.group(1) == "bool":
        return "false" if m.group(2) == "0" else "true"
    return m.group(2)


def instance_name(demangled: str) -> str:
    """"void talco_xdrop_kernel<6, false>(Batch)" gives
    "talco_xdrop_kernel<6, false>"; names of other functions stay."""
    for kern in KERNELS:
        m = re.search(kern + r"<([^<>]*)>", demangled)
        if m:
            args = [_template_arg(a) for a in m.group(1).split(",")]
            return f"{kern}<{', '.join(args)}>"
    return demangled


def loops(instrs: List[Tuple[int, str]]) -> List[dict]:
    """Each backward branch of one function ((address, text) in address
    order) with the opcodes from its target to it: {"from", "to" (hex
    addresses), "mix" ({opcode: n})}. A branch to itself (the trap after
    EXIT) is no loop."""
    out = []
    for addr, ins in instrs:
        m = _BRA_TARGET.match(_PRED.sub("", ins.strip()))
        if m is None or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        mix: Dict[str, int] = {}
        for a, i in instrs:
            if start <= a <= addr:
                op = opcode(i)
                mix[op] = mix.get(op, 0) + 1
        out.append({"from": hex(start), "to": hex(addr),
                    "mix": dict(sorted(mix.items()))})
    return out


def count(instrs: List[Tuple[int, str]]) -> dict:
    """The mix of one function ((address, text) of each instruction):
    total, per class, FFMA, FCHK, LDL, STL, the opcodes of class "other"
    by name, and its loops."""
    classes = dict.fromkeys(CLASS_ORDER, 0)
    ops: Dict[str, int] = {}
    for _, ins in instrs:
        op = opcode(ins)
        ops[op] = ops.get(op, 0) + 1
        classes[_CLASS_OF.get(op, "other")] += 1
    other = {op: n for op, n in sorted(ops.items())
             if op not in _CLASS_OF}
    ffma, fchk = ops.get("FFMA", 0), ops.get("FCHK", 0)
    if ffma == 0:
        source = "none"
    elif fchk:
        source = ("the correctly rounded f32 division (-prec-div=true: "
                  f"{fchk} FCHK), whose Newton steps use an explicit fma")
    else:
        source = "not attributed (no FCHK: no division routine)"
    return {"total": len(instrs), "classes": classes, "ffma": ffma,
            "fchk": fchk, "ldl": ops.get("LDL", 0), "stl": ops.get("STL", 0),
            "ffma_source": source, "other_ops": other, "loops": loops(instrs)}


def census(text: str) -> Dict[str, dict]:
    """{instance: mix} of every function in a cuobjdump -sass listing;
    probe instances carry their variant's name and layout."""
    funcs = split_functions(text)
    names = demangle([f for f, _ in funcs])
    out: Dict[str, dict] = {}
    for mangled, instrs in funcs:
        inst = instance_name(names[mangled])
        if inst in out:
            raise ValueError(f"sass_census: {inst} appears twice in the "
                             "listing")
        rec = {"function": mangled, **count(instrs)}
        m = re.fullmatch(f"({'|'.join(PROBE_LAYOUTS)})<(\\d+)>", inst)
        if m and int(m.group(2)) < len(PROBE_VARIANTS):
            rec["variant"] = PROBE_VARIANTS[int(m.group(2))]
            rec["layout"] = PROBE_LAYOUTS[m.group(1)]
        out[inst] = rec
    return out


def cuobjdump_path() -> str:
    """cuobjdump beside nvcc (ops/build.nvcc_path), else in Triton's
    bundled CUDA tools; raises naming the tool when there is none."""
    from ..ops import build
    tried = []
    try:
        cand = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        tried.append(cand)
        if os.path.exists(cand):
            return cand
    except RuntimeError as e:
        tried.append(str(e))
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cand = os.path.join(os.path.dirname(spec.origin), "backends",
                            "nvidia", "bin", "cuobjdump")
        tried.append(cand)
        if os.path.exists(cand):
            return cand
    raise RuntimeError("sass_census: cuobjdump not found (tried: "
                       + "; ".join(tried) + ")")


def listing() -> str:
    """cuobjdump -sass of every library build.SOURCES builds (built on
    first use)."""
    from ..ops import build
    tool = cuobjdump_path()
    paths = [build.library_path(name) for name in build.SOURCES]
    if not all(os.path.exists(p) for p in paths):
        build.prebuild(())
    parts = []
    for path in paths:
        r = subprocess.run([tool, "-sass", path], capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"sass_census: {tool} -sass {path} failed "
                               f"({r.returncode}): {r.stderr[-2000:]}")
        parts.append(r.stdout)
    return "\n".join(parts)


def table(res: Dict[str, dict]) -> str:
    """One line per instance: total, each class, FFMA and LDL/STL."""
    head = ["instance", "total", *CLASS_ORDER, "FFMA", "LDL/STL"]
    rows = [head]
    for inst, r in res.items():
        name = inst + (f" {r['variant']}" if "variant" in r else "")
        rows.append([name, str(r["total"]),
                     *(str(r["classes"][c]) for c in CLASS_ORDER),
                     str(r["ffma"]), f"{r['ldl']}/{r['stl']}"])
    widths = [max(len(row[k]) for row in rows) for k in range(len(head))]
    lines = ["  ".join(c.ljust(w) if k == 0 else c.rjust(w)
                       for k, (c, w) in enumerate(zip(row, widths)))
             for row in rows]
    for inst, r in res.items():
        if r["other_ops"]:
            lines.append(f"{inst} other: " + json.dumps(r["other_ops"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m twilight_tpu_torch.tools.sass_census",
        description="instruction mix of each built CUDA kernel instance "
        "(cuobjdump -sass), by class")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object {instance: mix}")
    ap.add_argument("--listing", help="parse this saved cuobjdump -sass "
                    "listing instead of the built libraries")
    args = ap.parse_args(argv)
    if args.listing:
        with open(args.listing) as f:
            text = f.read()
    else:
        text = listing()
    res = census(text)
    if not res:
        print("sass_census: no function in the listing", file=sys.stderr)
        return 1
    print(json.dumps(res) if args.json else table(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
