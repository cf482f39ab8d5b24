"""The port's kernel builder (twilight_tpu_torch/ops/build.py) with a
stand-in nvcc: one compile a source, only the source asked for on
`load`, libraries named by their flags, `variant` switching the wrappers
to a library built with extra flags, and a failed build raising with the
compiler's output.

The stand-in compiles, with the host C compiler, a library that exports
the kernels' C interface; its `talco_xdrop_config` reports whether
TALCO_PROFILE was defined (in the ring-cells slot) and refuses marker 0.
The CUDA kernels themselves build only on a machine with nvcc, where
chip_smoke.py builds and checks them.
"""
import os
import stat
import sys

import pytest

from twilight_tpu_torch.ops import build, talco_cuda

STUB_C = r"""
int talco_xdrop_launch(void) { return 0; }
int talco_xdrop_config(int leaf, int marker, int msize, long long* out) {
    for (int i = 0; i < 8; ++i) out[i] = 0;
    if (marker < 1) return 1;
#ifdef TALCO_PROFILE
    out[2] = 1;
#endif
    out[3] = leaf ? 0 : 256;
    out[4] = 256;
    return 0;
}
int talco_xdrop_attributes(int p, int leaf, int* out) { return 0; }
const char* talco_xdrop_error_string(int e) { return "stand-in"; }
int probe_loop_launch(void) { return 0; }
int probe_loop_attributes(int v, int* out) { return 0; }
"""

NVCC = r'''#!{python}
import os, subprocess, sys
argv = sys.argv[1:]
with open(os.environ["STANDIN_LOG"], "a") as f:
    f.write(os.path.basename(argv[-1]) + " " + " ".join(
        a for a in argv if a.startswith("-D")) + "\n")
if "-DFAIL" in argv:
    sys.stderr.write("stand-in nvcc: refused\n")
    sys.exit(1)
out = argv[argv.index("-o") + 1]
defines = [a for a in argv if a.startswith("-D")]
stub = out + ".c"
with open(stub, "w") as f:
    f.write({stub!r})
sys.exit(subprocess.call(["cc", "-shared", "-fPIC", *defines, "-o", out,
                          stub]))
'''


@pytest.fixture
def standin(tmp_path, monkeypatch):
    """PATH with the stand-in nvcc first, a fresh build directory and no
    library loaded; returns the compile log's path."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(NVCC.format(python=sys.executable, stub=STUB_C))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("STANDIN_LOG", str(log))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_libs", {})
    return log


def compiles(log):
    return sorted(log.read_text().splitlines()) if log.exists() else []


def test_load_builds_each_source_once(standin):
    lib = build.load()
    assert build.load() is lib
    probe = build.load(build.PROBE)
    assert probe is not lib and build.load(build.PROBE) is probe
    assert compiles(standin) == sorted(f"{s} " for s in build.SOURCES)
    for name in build.SOURCES:
        assert os.path.exists(build.library_path(name))
    cfg = talco_cuda.launch_config(False)
    assert (cfg["ring_cells"], cfg["producers"], cfg["consumers"]) == \
        (0, 256, 256)
    assert talco_cuda.launch_config(True)["producers"] == 0
    with pytest.raises(ValueError, match="refuses"):
        talco_cuda.launch_config(False, marker=0)


def test_talco_library_compiles_only_its_source(standin):
    """The batcher's library: making it compiles talco_xdrop.cu alone,
    and its namespace holds the TALCO kernel's functions only."""
    lib = build.load()
    assert compiles(standin) == [f"{build.TALCO} "]
    assert not os.path.exists(build.library_path(build.PROBE))
    assert hasattr(lib, "talco_xdrop_launch")
    assert not hasattr(lib, "probe_loop_launch")


def test_variant_uses_its_own_library(standin):
    plain = build.load()
    with build.variant("-DTALCO_PROFILE") as profiled:
        assert profiled is not plain and build.load() is profiled
        assert talco_cuda.launch_config(False)["ring_cells"] == 1
    assert build.load() is plain
    assert talco_cuda.launch_config(False)["ring_cells"] == 0
    assert build.library_path(build.SOURCES[0]) != build.library_path(
        build.SOURCES[0], ("-DTALCO_PROFILE",))
    # the plain TALCO library, every source of the variant once, and
    # none again on a second entry
    with build.variant("-DTALCO_PROFILE"):
        pass
    assert compiles(standin) == sorted(
        [f"{build.TALCO} "]
        + [f"{s} -DTALCO_PROFILE" for s in build.SOURCES])


def test_failed_build_raises_with_nvcc_output(standin):
    with pytest.raises(RuntimeError, match="stand-in nvcc: refused"):
        with build.variant("-DFAIL"):
            pass
    assert not os.path.exists(build.library_path(build.SOURCES[0],
                                                 ("-DFAIL",)))
    assert build.load() is not None       # the plain libraries still build


def test_prebuild_compiles_every_flag_set_once(standin):
    """prebuild compiles the plain libraries and a variant's in one round;
    load and variant then compile nothing."""
    build.prebuild((), ("-DPROBE_CLUSTER_EXCHANGE=1",))
    want = sorted([f"{s} " for s in build.SOURCES]
                  + [f"{s} -DPROBE_CLUSTER_EXCHANGE=1"
                     for s in build.SOURCES])
    assert compiles(standin) == want
    assert build._libs == {}               # nothing loaded yet
    plain = build.load()
    with build.variant("-DPROBE_CLUSTER_EXCHANGE=1") as lib:
        assert lib is not plain
    build.prebuild(())
    assert compiles(standin) == want
