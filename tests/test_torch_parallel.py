"""The port's multi-host and multi-device runs (twilight_tpu_torch/parallel/
distributed.py, the multi-device batcher) held to the JAX package's
one-process runs on the same simulated set: subtree assignment, two hosts
as sequential command lines over one shared temp dir, two processes in a
torch.distributed gloo group (the state exchange by all-gather), the
exchange's serialization, the topology errors, and four of eight CPU
devices (the counterpart of tests/test_multichip_e2e.py)."""
import datetime
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from twilight_tpu import cli as tpu_cli
from twilight_tpu.parallel.distributed import (
    assign_subtrees as tpu_assign_subtrees)
from twilight_tpu_torch import cli
from twilight_tpu_torch.parallel import distributed
from twilight_tpu_torch.tools import simulate

from conftest import REPO

torch.set_num_threads(1)
PROC_TIMEOUT_S = 300
RUNNER = """
import datetime, sys
import torch.distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
from twilight_tpu_torch import cli
try:
    rc = cli.main(sys.argv[3:])
finally:
    dist.destroy_process_group()
sys.exit(rc)
"""


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.fixture(scope="module")
def sim64(tmp_path_factory):
    """64 x 200 simulated (seed 7) and the JAX package's one-process
    divide-and-conquer run of it (-m 16: 6 subtrees, 3 a host)."""
    d = tmp_path_factory.mktemp("sim64")
    prefix = str(d / "s64")
    assert simulate.main(["-n", "64", "-l", "200", "--seed", "7",
                          "-o", prefix]) == 0
    args = ["-t", prefix + ".nwk", "-i", prefix + ".fa", "-m", "16"]
    out = str(d / "jax.aln")
    assert tpu_cli.main(args + ["-d", str(d / "jtmp"), "--backend",
                                "native", "-o", out]) == 0
    return args, _md5(out)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
def test_assign_subtrees_equals_jax(n_hosts):
    rng = np.random.default_rng(100 + n_hosts)
    for _ in range(20):
        k = int(rng.integers(1, 12))
        # sizes drawn from a small range, so that ties are common
        sizes = [(f"node_{int(rng.integers(0, 1000))}_{i}",
                  int(rng.integers(1, 6))) for i in range(k)]
        order = list(rng.permutation(k))
        shuffled = [sizes[i] for i in order]
        got = distributed.assign_subtrees(shuffled, n_hosts)
        assert got == tpu_assign_subtrees(shuffled, n_hosts)
        assert got == distributed.assign_subtrees(sizes, n_hosts)
        assert sorted(n for grp in got for n in grp) \
            == sorted(n for n, _ in sizes)


def test_two_sequential_hosts_match_jax(tmp_path, sim64, capfd):
    """Host 1, then host 0, over one shared temp dir (the shared-FS
    exchange): host 1 writes no output; host 0's equals the JAX
    package's one-process run."""
    args, want = sim64
    base = args + ["-d", str(tmp_path / "shared"), "-k", "--hosts", "2",
                   "--backend", "native"]
    out1 = str(tmp_path / "h1.aln")
    assert cli.main(base + ["-o", out1, "--host-id", "1"]) == 0
    assert not os.path.exists(out1)
    out0 = str(tmp_path / "h0.aln")
    assert cli.main(base + ["-o", out0, "--host-id", "0"]) == 0
    err = capfd.readouterr().err
    assert "Host 1/2: 3 subtrees." in err and "Host 0/2: 3 subtrees." in err
    assert "waiting for 6 subtree checkpoints" in err
    assert _md5(out0) == want


@pytest.mark.parametrize("backend", ["native", "cpu-2-devices"])
def test_two_process_gloo_group(tmp_path, sim64, backend):
    """Two processes in a gloo group (rendezvous through a file), no host
    flags: the topology comes from the group, the subtree states travel by
    all-gather, host 0 writes the JAX package's output and host 1 none.
    The cpu case runs each host's subtrees through two CPU queues of the
    batcher with the device forced."""
    args, want = sim64
    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER)
    env = dict(os.environ, PYTHONPATH=REPO)
    flags = ["--backend", "native"]
    if backend != "native":
        env.update(TWILIGHT_FORCE_DEVICE="1", TWILIGHT_NO_STEAL="1",
                   TWILIGHT_TORCH_CPU_DEVICES="2")
        flags = ["--backend", "cpu", "--pair-batch", "4"]
    outs = [str(tmp_path / f"h{r}.aln") for r in range(2)]
    init = "file://" + str(tmp_path / "rendezvous")
    paths = [tmp_path / f"h{r}.log" for r in range(2)]
    procs = []
    for r in range(2):
        with open(paths[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(runner), str(r), init] + args + flags
                + ["-d", str(tmp_path / "shared"), "-k", "-o", outs[r]],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=PROC_TIMEOUT_S)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    logs = [path.read_text() for path in paths]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"host {r}:\n{logs[r][-3000:]}"
        assert f"Host {r}/2: 3 subtrees." in logs[r]
        assert f"Host {r}: exchanging 3 subtree states by all-gather." \
            in logs[r]
        assert "waiting for" not in logs[r]
        if backend != "native":
            by_dev = re.search(r"launches_by_device=\[(\d+), (\d+)\]",
                               logs[r])
            assert by_dev and all(int(x) > 0 for x in by_dev.groups())
    assert not os.path.exists(outs[1])
    assert _md5(outs[0]) == want


def test_collective_state_roundtrip_single_rank(tmp_path):
    """exchange_subtree_states_collective serializes ragged per-subtree
    states through one padded uint8 all-gather over gloo; in a one-rank
    group the gather is an identity, so this pins the (de)serialization.
    The topology comes from the group: one host, not live."""
    local = {
        3: dict(msa_freq=np.arange(12, dtype=np.float32).reshape(2, 6),
                aln_len=2, aln_num=5, aln_weight=1.25),
        17: dict(msa_freq=np.zeros((4, 6), np.float32),
                 aln_len=4, aln_num=1, aln_weight=0.5),
    }
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "rendezvous"), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    try:
        assert distributed.detect_topology_implicit() == (1, 0)
        assert not distributed.distributed_live()
        assert distributed.detect_topology(1, -1) == (1, 0)
        out = distributed.exchange_subtree_states_collective(local)
    finally:
        dist.destroy_process_group()
    assert set(out) == {3, 17}
    for sid, st in local.items():
        np.testing.assert_array_equal(out[sid]["msa_freq"], st["msa_freq"])
        assert out[sid]["msa_freq"].dtype == np.float32
        assert int(out[sid]["aln_len"]) == st["aln_len"]
        assert int(out[sid]["aln_num"]) == st["aln_num"]
        assert float(out[sid]["aln_weight"]) == st["aln_weight"]


@pytest.mark.parametrize("flags,msg", [
    (["--hosts", "2", "-m", "16"], "requires --host-id"),
    (["--hosts", "2", "--host-id", "0"], "need a shared temp dir (-d)"),
    (["--hosts", "2", "--host-id", "2", "-m", "16"], "is not below"),
], ids=["no-host-id-no-group", "no-temp-dir", "host-id-out-of-range"])
def test_topology_errors_exit_1(tmp_path, sim64, capfd, flags, msg):
    args, _ = sim64
    argv = [a for a in args if a not in ("-m", "16")] + flags + [
        "--backend", "native", "-o", str(tmp_path / "x.aln")]
    if "-m" in flags:
        argv += ["-d", str(tmp_path / "shared")]
    assert cli.main(argv) == 1
    assert msg in capfd.readouterr().err
    assert not os.path.exists(tmp_path / "x.aln")


@pytest.fixture(scope="module")
def sim16(tmp_path_factory):
    """16 x 120 simulated (seed 7) and its --backend numpy alignment by
    the port and by the JAX package (tests/test_multichip_e2e.py's set)."""
    d = tmp_path_factory.mktemp("sim16")
    prefix = str(d / "mini")
    assert simulate.main(["-n", "16", "-l", "120", "--seed", "7",
                          "-o", prefix]) == 0
    args = ["-t", prefix + ".nwk", "-i", prefix + ".fa", "--rooted"]
    md5s = []
    for tag, main in (("port", cli.main), ("jax", tpu_cli.main)):
        out = str(d / f"{tag}.aln")
        assert main(args + ["-o", out, "--backend", "numpy"]) == 0
        md5s.append(_md5(out))
    assert md5s[0] == md5s[1]
    return args, md5s[0]


@pytest.fixture
def eight_cpu_devices(monkeypatch):
    monkeypatch.setenv("TWILIGHT_TORCH_CPU_DEVICES", "8")
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")


def test_four_of_eight_cpu_devices(tmp_path, sim16, eight_cpu_devices,
                                   capfd):
    """--devices 4 --device-index 0,2,4,6 of 8 CPU devices: four queues,
    each launching, and the --backend numpy output."""
    args, want = sim16
    out = str(tmp_path / "sel.aln")
    rc, kernel = cli.run(args + ["-o", out, "--backend", "cpu",
                                 "--pair-batch", "2", "--devices", "4",
                                 "--device-index", "0,2,4,6"])
    assert rc == 0
    assert "Maximum available devices: 8. Using 4 devices." \
        in capfd.readouterr().err
    by_dev = kernel.stats["launches_by_device"]
    assert len(by_dev) == 4 and all(n > 0 for n in by_dev)
    assert kernel.stats["pairs_on_device"] == 15
    assert _md5(out) == want


@pytest.mark.parametrize("flags,msg", [
    (["--device-index", "9"], "does not match"),
    (["--devices", "99"], "Invalid number of devices"),
    (["--devices", "2", "--device-index", "1,8"], "device index >="),
], ids=["index-without-count", "too-many", "index-out-of-range"])
def test_invalid_device_selection_exits_1(tmp_path, sim16, eight_cpu_devices,
                                          capfd, flags, msg):
    args, _ = sim16
    with pytest.raises(SystemExit) as ex:
        cli.run(args + ["-o", str(tmp_path / "x.aln"), "--backend", "cpu"]
                + flags)
    assert ex.value.code == 1
    assert msg in capfd.readouterr().err


def test_cpu_device_count_must_be_positive(monkeypatch):
    from twilight_tpu_torch.ops import device_kernel as dk
    monkeypatch.delenv("TWILIGHT_TORCH_CPU_DEVICES", raising=False)
    assert dk.cpu_device_count() == 1
    for bad in ("0", "-2", "two"):
        monkeypatch.setenv("TWILIGHT_TORCH_CPU_DEVICES", bad)
        with pytest.raises(ValueError, match="positive integer"):
            dk.cpu_device_count()
