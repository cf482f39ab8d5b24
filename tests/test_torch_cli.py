"""End to end through the port's command line (twilight_tpu_torch.cli):
the CPU-tensor batcher reproduces the prot_16 golden and the JAX package's
output on a simulated set, never imports jax, --backend cuda without a
card fails loudly, and the default backend (auto) takes the card whenever
there is one and exits without one. The front door: a host-only run, -h
and --version import no torch."""
import hashlib
import os
import subprocess
import sys

import pytest
import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu_torch import cli
from twilight_tpu_torch.tools import simulate

from conftest import DATA, GOLDEN, REPO

torch.set_num_threads(1)
PROT16_MD5 = "8174145594cfcd5404008e233e10ea30"


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def _simulate(tmp_path, n=24, length=120, seed=7):
    prefix = str(tmp_path / "mini")
    r = subprocess.run(
        [sys.executable, "-m", "twilight_tpu.tools.simulate",
         "-n", str(n), "-l", str(length), "--seed", str(seed),
         "-o", prefix], cwd=REPO, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    return prefix


@pytest.fixture
def device_forced(monkeypatch):
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")


def test_prot16_golden_on_cpu_backend(tmp_path, device_forced):
    out = str(tmp_path / "p16.aln")
    rc, kernel = cli.run(["--backend", "cpu", "-t", f"{DATA}/prot_16.nwk",
                          "-i", f"{DATA}/prot_16.fa", "-o", out,
                          "--type", "p"])
    assert rc == 0
    assert _md5(out) == PROT16_MD5 == _md5(f"{GOLDEN}/prot_16.aln")
    assert kernel.stats["pairs_on_device"] == 15
    assert kernel.stats["launches"] == 0       # no CUDA kernel on the CPU


def test_simulated_set_matches_jax_package(tmp_path, monkeypatch):
    prefix = _simulate(tmp_path)
    args = ["-t", prefix + ".nwk", "-i", prefix + ".fa", "--rooted"]
    outs = {k: str(tmp_path / f"{k}.aln") for k in ("np", "jax", "port")}
    assert tpu_cli.main(args + ["-o", outs["np"], "--backend", "numpy"]) \
        == 0
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    # the JAX package's device path: the grouped Pallas kernel in
    # interpret mode
    assert tpu_cli.main(args + ["-o", outs["jax"], "--backend", "cpu",
                                "--pair-batch", "8"]) == 0
    rc, kernel = cli.run(args + ["-o", outs["port"], "--backend", "cpu",
                                 "--pair-batch", "8"])
    assert rc == 0
    assert kernel.stats["pairs_on_device"] == kernel.stats["pairs"] == 23
    want = open(outs["np"], "rb").read()
    assert open(outs["jax"], "rb").read() == want
    assert open(outs["port"], "rb").read() == want


def test_cli_long_set_matches_jax_package(tmp_path, device_forced):
    """Four simulated 2200-column sequences: every pair is longer than the
    2048 bucket and runs in long launches (the plain version on CPU
    tensors); the output equals the JAX package's --backend native run."""
    prefix = _simulate(tmp_path, n=4, length=2200, seed=5)
    args = ["-t", prefix + ".nwk", "-i", prefix + ".fa"]
    want, got = str(tmp_path / "native.aln"), str(tmp_path / "port.aln")
    assert tpu_cli.main(args + ["-o", want, "--backend", "native"]) == 0
    rc, kernel = cli.run(args + ["-o", got, "--backend", "cpu"])
    assert rc == 0
    st = kernel.stats
    assert st["pairs_on_device"] == st["pairs"] - st["zero_length"] == 3
    assert st["long_launches"] >= 2 and st["host_wide"] == 0
    assert _md5(got) == _md5(want)


def test_host_kernel_load_race_repaired(tmp_path):
    """The native host kernel loads lazily at its first use, which in a
    --backend native run is on the first level's pool threads. The port's
    talco_host binds the library under a lock before it marks it checked,
    so no thread sees it unavailable meanwhile: with the load slowed by
    0.3 s and the NumPy oracle's calls counted, a run of the port's command
    line (which loads nothing ahead of the run) makes no oracle call."""
    prefix = _simulate(tmp_path, n=8, length=400, seed=5)
    code = (
        "import time\n"
        "from twilight_tpu_torch.ops import talco_host, talco_np\n"
        "load = talco_host.load\n"
        "def slow_load(name):\n"
        "    time.sleep(0.3)\n"
        "    return load(name)\n"
        "talco_host.load = slow_load\n"
        "calls = []\n"
        "oracle = talco_np.align_freq\n"
        "def counted(*a, **k):\n"
        "    calls.append(1)\n"
        "    return oracle(*a, **k)\n"
        "talco_np.align_freq = counted\n"
        "from twilight_tpu_torch.cli import main\n"
        f"rc = main(['-t', {prefix + '.nwk'!r}, '-i', {prefix + '.fa'!r},"
        f" '-o', {str(tmp_path / 'o.aln')!r}, '--backend', 'native',"
        " '--cpu', '4'])\n"
        "print('RC', rc, 'ORACLE_CALLS', len(calls),"
        " 'LOADED', talco_host.available())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert "RC 0 ORACLE_CALLS 0 LOADED True" in r.stdout, \
        (r.stdout, r.stderr[-1000:])


def test_main_never_imports_jax(tmp_path):
    prefix = _simulate(tmp_path, n=8, length=60, seed=3)
    code = (
        "import sys\n"
        "from twilight_tpu_torch.cli import main\n"
        f"rc = main(['-t', {prefix + '.nwk'!r}, '-i', {prefix + '.fa'!r},"
        f" '-o', {str(tmp_path / 'o.aln')!r}, '--backend', 'cpu'])\n"
        "print('RC', rc, 'JAX', 'jax' in sys.modules)\n")
    env = dict(os.environ, TWILIGHT_FORCE_DEVICE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert "RC 0 JAX False" in r.stdout, r.stderr[-1000:]


def test_backend_cuda_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "twilight_tpu_torch", "--backend", "cuda",
         "-t", f"{DATA}/prot_16.nwk", "-i", f"{DATA}/prot_16.fa",
         "-o", str(tmp_path / "x.aln")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert not os.path.exists(tmp_path / "x.aln")


def _resolved_backend(monkeypatch, tmp_path, argv):
    """The backend the port's command line hands the batcher factory (the
    factory is replaced by one that records it and stops the run)."""
    seen = []

    def record(option, param):
        seen.append(option.device_backend)
        raise RuntimeError("stopped before the run")

    monkeypatch.setattr(cli, "make_device_kernel", record)
    rc, _ = cli.run(argv + ["-o", str(tmp_path / "x.aln")])
    assert rc == 1 and not os.path.exists(tmp_path / "x.aln")
    return seen


@pytest.mark.parametrize("cores", [1, 8])
def test_backend_auto_takes_the_card(monkeypatch, tmp_path, cores):
    """With a CUDA device, the default backend is cuda for every workload
    (prot_16 is tiny) and every core count: the level gate, not the
    command line, decides per level."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    prot = ["-t", f"{DATA}/prot_16.nwk", "-i", f"{DATA}/prot_16.fa"]
    assert _resolved_backend(monkeypatch, tmp_path, prot) == ["cuda"]
    assert _resolved_backend(monkeypatch, tmp_path,
                             prot + ["--backend", "auto"]) == ["cuda"]


def test_backend_auto_without_card_exits(monkeypatch, tmp_path, capfd):
    """Without a CUDA device the default backend exits 1 and names the
    host backends; it does not carry on on the host. --cpu-only and
    --devices 0 still mean host only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prot = ["-t", f"{DATA}/prot_16.nwk", "-i", f"{DATA}/prot_16.fa"]
    assert _resolved_backend(monkeypatch, tmp_path, prot) == []
    err = capfd.readouterr().err
    for flag in ("--backend native", "--backend cpu", "--cpu-only"):
        assert flag in err
    for host_only in (["--cpu-only"], ["--devices", "0"]):
        out = tmp_path / f"h{len(host_only)}.aln"
        rc, kernel = cli.run(prot + host_only + ["-o", str(out)])
        assert rc == 0 and kernel is None
        assert _md5(out) == PROT16_MD5


# A fresh interpreter in which importing torch raises (a meta-path finder
# refuses it and records each attempt) runs the port's command line as
# `python -m twilight_tpu_torch` does, with the arguments after the code.
_NO_TORCH = r"""
import atexit, importlib.abc, runpy, sys
attempts = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "torch":
            attempts.append(name)
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
atexit.register(lambda: print("TORCH_ATTEMPTS", attempts, file=sys.stderr))
sys.argv = ["twilight_tpu_torch"] + sys.argv[1:]
runpy.run_module("twilight_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _no_torch(argv):
    return subprocess.run([sys.executable, "-c", _NO_TORCH] + argv,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("host_only", [
    ["--backend", "native"], ["--backend", "numpy"], ["--cpu-only"],
    ["--devices", "0"]])
def test_host_only_run_imports_no_torch(tmp_path, host_only):
    out = tmp_path / "p16.aln"
    r = _no_torch(["-t", f"{DATA}/prot_16.nwk", "-i", f"{DATA}/prot_16.fa",
                   "--type", "p", "-o", str(out)] + host_only)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TORCH_ATTEMPTS []" in r.stderr
    assert _md5(out) == PROT16_MD5


@pytest.mark.parametrize("flag", ["-h", "--version"])
def test_help_and_version_import_no_torch(flag):
    r = _no_torch([flag])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "twilight-tpu-torch" in r.stdout
    assert "TORCH_ATTEMPTS []" in r.stderr


def test_backend_cuda_without_torch_fails(tmp_path):
    """The card's backend needs torch: refused, the run exits non-zero
    and writes nothing."""
    out = tmp_path / "x.aln"
    r = _no_torch(["--backend", "cuda", "-t", f"{DATA}/prot_16.nwk", "-i",
                   f"{DATA}/prot_16.fa", "-o", str(out)])
    assert r.returncode != 0
    assert "refused: torch" in r.stderr
    assert not os.path.exists(out)


def test_two_hosts_import_no_torch(tmp_path):
    """Two hosts over one shared temp dir with the host kernel, torch
    refused in both: host 1 writes no output, host 0 the one-process
    run's bytes (the 64 x 200 seed-7 set, -m 16)."""
    prefix = str(tmp_path / "s64")
    assert simulate.main(["-n", "64", "-l", "200", "--seed", "7", "-o",
                          prefix]) == 0
    base = ["-t", prefix + ".nwk", "-i", prefix + ".fa", "-m", "16", "-d",
            str(tmp_path / "shared"), "-k", "--backend", "native",
            "--hosts", "2"]
    outs = [tmp_path / f"h{h}.aln" for h in (0, 1)]
    for host in (1, 0):
        r = _no_torch(base + ["--host-id", str(host), "-o",
                              str(outs[host])])
        assert r.returncode == 0, r.stderr[-2000:]
        assert "TORCH_ATTEMPTS []" in r.stderr
    assert not os.path.exists(outs[1])
    assert _md5(outs[0]) == "fb1205241554f22b5f42ec4947793347"
