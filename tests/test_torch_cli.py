"""End to end through the port's command line (twilight_tpu_torch.cli):
the CPU-tensor batcher reproduces the prot_16 golden and the JAX package's
output on a simulated set, never imports jax, and --backend cuda without a
card fails loudly."""
import hashlib
import os
import subprocess
import sys

import pytest
import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu_torch import cli

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
    """The native host kernel loads lazily, and talco_host marks it checked
    before the library is bound, so a first-level pool thread that asks
    meanwhile runs the NumPy oracle. With the load slowed by 0.3 s and
    the oracle's calls counted, a --backend native run of the port's
    command line (which loads the library on its main thread first) makes
    no oracle call."""
    prefix = _simulate(tmp_path, n=8, length=400, seed=5)
    code = (
        "import time\n"
        "from twilight_tpu.ops import talco_host, talco_np\n"
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
        "print('RC', rc, 'ORACLE_CALLS', len(calls))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert "RC 0 ORACLE_CALLS 0" in r.stdout, (r.stdout, r.stderr[-1000:])


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


def test_multi_host_flags_rejected(tmp_path, capfd):
    rc = cli.main(["--hosts", "2", "-t", f"{DATA}/prot_16.nwk",
                   "-i", f"{DATA}/prot_16.fa", "-o", str(tmp_path / "x")])
    assert rc == 1
    assert "not ported" in capfd.readouterr().err
