"""The port's SASS census (twilight_tpu_torch/tools/sass_census.py) on a
hand-written `cuobjdump -sass` excerpt: two functions, predicated and
modified opcodes, encoding lines, an opcode the class table does not
know. The counts by class are exact. The tool itself needs cuobjdump,
which only the machine with the CUDA toolkit has (chip_smoke.py's
`census` phase runs it on the built libraries); here a missing cuobjdump
must raise naming it."""
import json

import pytest

from twilight_tpu_torch.ops import build
from twilight_tpu_torch.tools import sass_census

LISTING = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _Z18talco_xdrop_kernelILi6ELb0EEv5Batch
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
                                                                           /* 0x000e220000002100 */
        /*0020*/              @!P0 FFMA R3, -R2, R4, 1 ;                   /* 0x3f80000002037423 */
                                                                           /* 0x000fe20000000104 */
        /*0030*/                   FCHK P0, R5, R2 ;                       /* 0x0000000205007302 */
                                                                           /* 0x000e220000000000 */
        /*0040*/               @P1 LDG.E.64.STRONG.GPU R6, desc[UR4][R8.64] ;  /* 0x0000000408067981 */
                                                                           /* 0x000ea8000c1f1b00 */
        /*0050*/                   STL [R1], R6 ;                          /* 0x0000000601007387 */
                                                                           /* 0x000fe80000100800 */
        /*0060*/                   SYNCS.ARRIVE.TRANS64.A1T0 RZ, [UR4], RZ ;  /* 0x000000ffffff79a7 */
                                                                           /* 0x000fe20008000004 */
        /*0070*/              @!PT BRA 0x1a0 ;                             /* 0x000000000048794 */
                                                                           /* 0x000fea0003800000 */
        /*0080*/                   DADD R10, R10, R12 ;                    /* 0x0000000c0a0a7229 */
                                                                           /* 0x000fe2000000000c */
        /*0090*/                   EXIT ;                                  /* 0x000000000000794d */
                                                                           /* 0x000fea0003800000 */
		..........


		Function : _ZN12_GLOBAL__N_117probe_loop_kernelILi7EEEviiPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;  /* 0x00000a00ff017624 */
                                                                           /* 0x000fe400078e00ff */
        /*0010*/              @!UP0 SHFL.BFLY PT, R3, R2, 0x1, 0x1f ;     /* 0x0c201f0002037f89 */
                                                                           /* 0x000e2400000e0000 */
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;           /* 0x0000000000007b1d */
                                                                           /* 0x000fec0000010000 */
        /*0030*/                   LDS.U.128 R4, [R3+0x10] ;               /* 0x0000100003047984 */
                                                                           /* 0x000e280000000c00 */
        /*0040*/                   F2I.TRUNC.NTZ R5, R4 ;                  /* 0x0000000400057305 */
                                                                           /* 0x000e24000020f100 */
        /*0050*/                   NOP ;                                   /* 0x0000000000007918 */
                                                                           /* 0x000fc00000000000 */
		..........
"""

TALCO = "talco_xdrop_kernel<6, false>"
PROBE = "probe_loop_kernel<7>"


def _classes(**nonzero):
    return {c: nonzero.get(c, 0) for c in sass_census.CLASS_ORDER}


def _check(res):
    assert list(res) == [TALCO, PROBE]
    t, p = res[TALCO], res[PROBE]
    assert t["function"] == "_Z18talco_xdrop_kernelILi6ELb0EEv5Batch"
    assert t["total"] == 10
    assert t["classes"] == _classes(fp32=2, move=2, local=1, barrier=1,
                                    branch=2, other=1, **{"global": 1})
    assert (t["ffma"], t["fchk"], t["ldl"], t["stl"]) == (1, 1, 0, 1)
    assert "division" in t["ffma_source"]
    assert t["other_ops"] == {"DADD": 1}
    assert "variant" not in t
    assert p["total"] == 6
    assert p["classes"] == _classes(integer=1, warp=1, barrier=1,
                                    shared=1, conversion=1, other=1)
    assert (p["ffma"], p["fchk"], p["ldl"], p["stl"]) == (0, 0, 0, 0)
    assert p["ffma_source"] == "none"
    assert p["other_ops"] == {"NOP": 1}
    assert p["variant"] == "nested"
    assert t["loops"] == p["loops"] == []     # a forward branch only


def test_census_counts_each_loop():
    """A backward branch's loop is counted by opcode from its target to
    the branch; the trap after EXIT (a branch to itself) is no loop."""
    listing = """
		Function : _ZN12_GLOBAL__N_117probe_loop_kernelILi0EEEviiiPf
        /*0000*/                   MOV R0, RZ ;
        /*0010*/                   FADD R1, R1, 1 ;
        /*0020*/                   FADD R2, R2, 1 ;
        /*0030*/                   UIADD3 UR4, UR4, 0x2, URZ ;
        /*0040*/                   ISETP.LE.AND P0, PT, R3, UR4, PT ;
        /*0050*/              @!P0 BRA 0x10 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70 ;
"""
    res = sass_census.census(listing)["probe_loop_kernel<0>"]
    assert res["variant"] == "carcass"
    assert res["loops"] == [{"from": "0x10", "to": "0x50", "mix": {
        "BRA": 1, "FADD": 2, "ISETP": 1, "UIADD3": 1}}]


@pytest.mark.parametrize("instr,op", [
    ("@!P0 BRA 0x1a0", "BRA"), ("@!PT LDS R2, [R3]", "LDS"),
    ("@UP1 LDG.E.64.STRONG.GPU R2, desc[UR4][R4.64]", "LDG"),
    ("IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28]", "IMAD"),
    ("SYNCS.EXCH.64 URZ, [UR4], UR6", "SYNCS"), ("EXIT", "EXIT")])
def test_opcode_strips_predicate_and_modifiers(instr, op):
    assert sass_census.opcode(instr) == op


@pytest.mark.parametrize("demangled,inst", [
    ("void talco_xdrop_kernel<22, false>(Batch)",
     "talco_xdrop_kernel<22, false>"),
    ("void (anonymous namespace)::talco_xdrop_kernel<(int)22, (bool)1>("
     "(anonymous namespace)::Batch)", "talco_xdrop_kernel<22, true>"),
    ("void (anonymous namespace)::probe_loop_kernel<(int)3>(int, int, "
     "float *)", "probe_loop_kernel<3>"),
    ("__internal_fdiv", "__internal_fdiv")])
def test_instance_names_whatever_the_demangler_spells(demangled, inst):
    assert sass_census.instance_name(demangled) == inst


def test_anonymous_namespace_kernel_without_a_demangler():
    name = ("_ZN47_GLOBAL__N__63f3eedd_14_talco_xdrop_cu_6a9e4ff818"
            "talco_xdrop_kernelILi22ELb0EEEvNS_5BatchE")
    assert sass_census._demangle_fallback(name) == \
        "talco_xdrop_kernel<22, false>"


def test_census_counts_by_class_exactly():
    _check(sass_census.census(LISTING))


def test_census_without_a_demangler(monkeypatch):
    """Without cu++filt and c++filt the instances are named from the
    mangled template arguments, the same names."""
    monkeypatch.setattr(sass_census.shutil, "which", lambda name: None)
    _check(sass_census.census(LISTING))


def test_cli_listing_json(tmp_path, capsys):
    path = tmp_path / "kernels.sass"
    path.write_text(LISTING)
    assert sass_census.main(["--listing", str(path), "--json"]) == 0
    _check(json.loads(capsys.readouterr().out))
    assert sass_census.main(["--listing", str(path)]) == 0
    text = capsys.readouterr().out
    assert "probe_loop_kernel<7> nested" in text
    assert f'{TALCO} other: {{"DADD": 1}}' in text


def test_expected_instances():
    """The 4 TALCO instances, the 9 one-block probe variants, the probe
    names in probe_loop.KERNEL_ID's order, and the 9 cluster instances
    (every variant: the carcass, body's 2, scalar0d's 3, deadcode,
    nested's 2)."""
    from twilight_tpu_torch.ops.probe_loop import CLUSTER_VARIANTS, KERNEL_ID
    assert len(sass_census.EXPECTED) == 22
    assert "probe_cluster_kernel<0>" in sass_census.EXPECTED
    assert sass_census.EXPECTED[:4] == (
        "talco_xdrop_kernel<6, false>", "talco_xdrop_kernel<6, true>",
        "talco_xdrop_kernel<22, false>", "talco_xdrop_kernel<22, true>")
    for name, v in KERNEL_ID.items():
        assert sass_census.PROBE_VARIANTS[v] == name
    assert sass_census.EXPECTED[13:] == tuple(
        f"probe_cluster_kernel<{KERNEL_ID[n]}>" for n in CLUSTER_VARIANTS)


@pytest.mark.parametrize("v,name", [(0, "carcass"), (1, "body/carried"),
                                    (2, "body/scratch"), (6, "deadcode")])
def test_census_names_the_new_cluster_instances(v, name):
    """K6's, K7's and K9's cluster instances are named by variant and
    layout, beside their one-block instances, and are expected."""
    listing = (f"\t\tFunction : _ZN12_GLOBAL__N_120probe_cluster_kernelILi{v}"
               "EEEviiiPf\n        /*0000*/                   EXIT ;\n"
               f"\t\tFunction : _ZN12_GLOBAL__N_117probe_loop_kernelILi{v}"
               "EEEviiiPf\n        /*0000*/                   EXIT ;\n")
    res = sass_census.census(listing)
    assert {k: (r["variant"], r["layout"]) for k, r in res.items()} == {
        f"probe_cluster_kernel<{v}>": (name, "cluster"),
        f"probe_loop_kernel<{v}>": (name, "block")}
    assert f"probe_cluster_kernel<{v}>" in sass_census.EXPECTED


def test_missing_cuobjdump_raises_naming_it(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda)")
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(sass_census.importlib.util, "find_spec",
                        lambda name: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        sass_census.cuobjdump_path()
    with pytest.raises(RuntimeError, match="cuobjdump"):
        sass_census.main(["--json"])
