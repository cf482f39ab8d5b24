"""The port stands alone: nothing under twilight_tpu_torch/ and nothing in
chip_smoke.py imports jax or the JAX package (twilight_tpu), neither at the
top of a module nor lazily inside a function, nor runs it as a
subprocess (`-m twilight_tpu.…`)."""
import ast
import os
import subprocess
import sys

from conftest import DATA, REPO

REFUSED = ("jax", "jaxlib", "twilight_tpu")
PROT16_MD5 = "8174145594cfcd5404008e233e10ea30"


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "twilight_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _refused(module: str) -> bool:
    return module.split(".")[0] in REFUSED


def _offences(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _refused(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _refused(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # a module name handed to importlib, __import__ or `python -m`
            v = node.value
            if " " not in v and "/" not in v and _refused(v):
                found.append(repr(v))
    return [f"{os.path.relpath(path, REPO)}: {n}" for n in found]


def test_ast_scan_finds_no_jax_or_jax_package_import():
    files = _port_sources()
    assert len(files) > 30      # the package and its copied pipeline
    offences = [o for f in files for o in _offences(f)]
    assert offences == []


def test_ast_scan_reaches_the_last_modules():
    """The scan walks the whole package: the graft entry, the pairs mesh
    and the SASS census are among its files."""
    files = {os.path.relpath(f, REPO) for f in _port_sources()}
    assert {"twilight_tpu_torch/graft_entry.py",
            "twilight_tpu_torch/parallel/sharding.py",
            "twilight_tpu_torch/tools/sass_census.py"} <= files


def test_ast_scan_catches_an_offence(tmp_path):
    """The scan itself sees each form it looks for."""
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import os\n"
        "import jax.numpy as jnp\n"
        "from twilight_tpu.ops import talco_np\n"
        "from twilight_tpu_torch import cli\n"
        "def f():\n"
        "    import twilight_tpu\n"
        "    return ['python', '-m', 'twilight_tpu.tools.simulate']\n")
    got = _offences(str(bad))
    assert len(got) == 4, got


def _pipeline_imports(path, package):
    """The modules under twilight_tpu_torch.pipeline that the file at
    `path`, a module of `package`, imports, relative imports resolved."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            base = (parts[:len(parts) - node.level + 1] if node.level
                    else [])
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return sorted({n for n in names
                   if n.split(".")[:2] == ["twilight_tpu_torch",
                                           "pipeline"]})


def test_ops_never_imports_the_pipeline(tmp_path):
    """The layers' arrows point one way: cli -> pipeline -> ops. No module
    under twilight_tpu_torch/ops/ imports twilight_tpu_torch.pipeline,
    neither relatively nor by its full name (and the scan sees both)."""
    ops = os.path.join(REPO, "twilight_tpu_torch", "ops")
    files = sorted(os.path.join(ops, n) for n in os.listdir(ops)
                   if n.endswith(".py"))
    assert os.path.join(ops, "device_kernel.py") in files
    found = {os.path.basename(f): _pipeline_imports(
        f, "twilight_tpu_torch.ops") for f in files}
    assert {f: n for f, n in found.items() if n} == {}
    bad = tmp_path / "bad.py"
    bad.write_text("from ..pipeline.aligner import align_pairs\n"
                   "from .. import pipeline\n"
                   "def f():\n"
                   "    import twilight_tpu_torch.pipeline.helpers\n")
    assert _pipeline_imports(str(bad), "twilight_tpu_torch.ops") == [
        "twilight_tpu_torch.pipeline",
        "twilight_tpu_torch.pipeline.aligner",
        "twilight_tpu_torch.pipeline.aligner.align_pairs",
        "twilight_tpu_torch.pipeline.helpers"]


# Runs in a fresh interpreter: a meta-path finder refuses jax and the JAX
# package (and records every attempt), then the port's command line (prot_16
# on the native, numpy and cpu backends, and a divide-and-conquer run), its
# tools and the graft entry run end to end.
_CHILD = r"""
import hashlib, importlib.abc, io, os, sys, contextlib
REFUSED = {refused!r}
attempts = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            attempts.append(name)
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
assert not any(m.split(".")[0] in REFUSED for m in sys.modules)

def md5(p):
    return hashlib.md5(open(p, "rb").read()).hexdigest()

from twilight_tpu_torch.cli import main
from twilight_tpu_torch import graft_entry
from twilight_tpu_torch.parallel import sharding
from twilight_tpu_torch.tools import probe_loop_costs, sass_census, simulate
td = {td!r}
prot = ["-t", {data!r} + "/prot_16.nwk", "-i", {data!r} + "/prot_16.fa",
        "--type", "p"]
assert main(prot + ["-o", td + "/native.aln", "--backend", "native"]) == 0
assert main(prot + ["-o", td + "/numpy.aln", "--backend", "numpy"]) == 0
os.environ["TWILIGHT_FORCE_DEVICE"] = "1"
assert main(prot + ["-o", td + "/cpu.aln", "--backend", "cpu"]) == 0
del os.environ["TWILIGHT_FORCE_DEVICE"]
assert simulate.main(["-n", "12", "-l", "200", "--seed", "3",
                      "-o", td + "/sim"]) == 0
assert main(["-t", td + "/sim.nwk", "-i", td + "/sim.fa", "-o",
             td + "/sim.aln", "--backend", "numpy", "-m", "5", "-d",
             td + "/tmp"]) == 0
with contextlib.redirect_stdout(io.StringIO()):
    assert probe_loop_costs.main(["carcass", "--device", "cpu", "--trips",
                                  "2", "4"]) == 0
step, args = graft_entry.entry("cpu")
assert step(*args)[1][:, :2].tolist() == [[192, 0]] * 4
assert sharding.pad_batch_to_mesh(5, sharding.make_pair_mesh(["cpu"] * 4)) == 8
assert sass_census.opcode("@!P0 BRA 0x1a0") == "BRA"
print("MD5", *(md5(f"{{td}}/{{b}}.aln") for b in ("native", "numpy", "cpu")))
print("ATTEMPTS", attempts)
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in REFUSED))
"""


def test_port_runs_with_jax_and_jax_package_refused(tmp_path):
    code = _CHILD.format(refused=REFUSED, td=str(tmp_path), data=DATA)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                 if ln.split(" ", 1)[0] in ("MD5", "ATTEMPTS", "LOADED"))
    assert lines["MD5"] == " ".join([PROT16_MD5] * 3)
    assert lines["ATTEMPTS"] == "[]"
    assert lines["LOADED"] == "[]"
    with open(tmp_path / "sim.aln", "rb") as f:
        assert f.read().count(b">") == 12


def test_chip_smoke_refuses_a_directory_without_the_port(tmp_path):
    """chip_smoke.py alone in a directory exits non-zero and prints no
    result line."""
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py"), "rb") as f:
        lone.write_bytes(f.read())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
