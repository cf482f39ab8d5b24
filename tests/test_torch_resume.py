"""Checkpoint/resume of divide-and-conquer (--resume) and merge mode (-f)
in the port, each held byte for byte to the JAX package's CLI on the same
inputs: the counterparts of tests/test_checkpoint.py (which needs the
absent RNASim set) on a simulated set, with --backend native and with the
batcher forced onto the kernel's plain version (--backend cpu).

Tolerance: byte equality of the output FASTA everywhere."""
import os

import pytest

from twilight_tpu import cli as tpu_cli
from twilight_tpu_torch import cli
from twilight_tpu_torch.seqio import writer as writer_mod
from twilight_tpu_torch.tools import simulate

from test_torch_pipeline import _merge_dir

N_SUBTREES = 6          # simulate -n 240 -l 300 --seed 3 with -m 60
SMALL_SUBTREES = 4      # simulate -n 24 -l 120 --seed 3 with -m 8


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _set(d, n, length, seed):
    prefix = os.path.join(d, f"s{n}")
    assert simulate.main(["-n", str(n), "-l", str(length), "--seed",
                          str(seed), "-o", prefix]) == 0
    return ["-t", prefix + ".nwk", "-i", prefix + ".fa"]


@pytest.fixture(scope="module")
def native_set(tmp_path_factory):
    """The 240 x 300 set with -m 60, and the JAX CLI's output of it."""
    d = tmp_path_factory.mktemp("resume")
    argv = _set(str(d), 240, 300, 3) + ["-m", "60", "--backend", "native"]
    want = str(d / "jax.aln")
    assert tpu_cli.main(argv + ["-d", str(d / "jax_tmp"), "-o", want]) == 0
    return argv, _read(want)


def _forced(monkeypatch):
    """The batcher on CPU tensors (the kernel's plain version), every
    level sent to it, no host stealing."""
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")


def test_resume_skips_finished_subtrees(tmp_path, capfd, native_set):
    """tests/test_checkpoint.py:14 on the port: a -k run keeps one state
    checkpoint a subtree; the --resume rerun realigns none of them."""
    argv, want = native_set
    temp = str(tmp_path / "ck")
    args = argv + ["-d", temp, "-k"]
    out1 = str(tmp_path / "a.aln")
    assert cli.main(args + ["-o", out1]) == 0
    assert _read(out1) == want
    states = [f for f in os.listdir(temp) if f.endswith(".state.npz")]
    assert len(states) == N_SUBTREES
    capfd.readouterr()
    out2 = str(tmp_path / "b.aln")
    assert cli.main(args + ["-o", out2, "--resume", "--overwrite"]) == 0
    err = capfd.readouterr().err
    assert err.count("Resumed subtree") == N_SUBTREES, err
    assert "Start processing subalignment" not in err
    assert _read(out2) == want


def test_resume_after_merge_crash(tmp_path, capfd, monkeypatch, native_set):
    """tests/test_checkpoint.py:36 on the port: a crash in the
    transitivity expansion (the port's update_and_write_alignment,
    patched through its module: update_and_write_alignments looks it up
    there) under --resume without -k leaves every unexpanded
    subalignment, and the rerun resumes every subtree."""
    argv, want = native_set
    temp = str(tmp_path / "ck")
    out = str(tmp_path / "crash.aln")
    args = argv + ["-d", temp, "--resume", "-o", out]
    real = writer_mod.update_and_write_alignment
    calls = {"n": 0}

    def crashing(database, option, file_name, subtree_idx):
        total = real(database, option, file_name, subtree_idx)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected merge-phase crash")
        return total

    monkeypatch.setattr(writer_mod, "update_and_write_alignment", crashing)
    with pytest.raises(RuntimeError, match="injected"):
        cli.main(args)
    monkeypatch.setattr(writer_mod, "update_and_write_alignment", real)
    assert calls["n"] == 2
    capfd.readouterr()
    subs = [f for f in os.listdir(temp) if ".subalignment.aln" in f
            and ".final" not in f]
    assert len(subs) == N_SUBTREES, subs
    assert not os.path.exists(out)

    assert cli.main(args + ["--overwrite"]) == 0
    err = capfd.readouterr().err
    assert err.count("Resumed subtree") == N_SUBTREES, err
    assert _read(out) == want
    assert not os.path.exists(temp)     # no -k: the temp dir is gone


def test_resume_on_forced_plain_version(tmp_path, capfd, monkeypatch):
    """-n 24 -l 120 -m 8 through the batcher on CPU tensors: both runs
    byte-equal to the JAX CLI's native output, and the resumed run's
    launches are the meta-tree merge's only (its SMALL_SUBTREES - 1
    profile pairs, no leaf launch)."""
    argv = _set(str(tmp_path), 24, 120, 3) + ["-m", "8"]
    want = str(tmp_path / "jax.aln")
    assert tpu_cli.main(argv + ["--backend", "native", "-d",
                                str(tmp_path / "jax_tmp"), "-o", want]) == 0
    _forced(monkeypatch)
    args = argv + ["--backend", "cpu", "-k", "-d", str(tmp_path / "ck")]
    out1, out2 = str(tmp_path / "a.aln"), str(tmp_path / "b.aln")
    rc, first = cli.run(args + ["-o", out1])
    assert rc == 0
    capfd.readouterr()
    rc, again = cli.run(args + ["-o", out2, "--resume", "--overwrite"])
    assert rc == 0
    assert capfd.readouterr().err.count("Resumed subtree") == SMALL_SUBTREES
    assert _read(out1) == _read(out2) == _read(want)
    first, again = first.stats, again.stats
    assert first["pairs"] == 23 and first["leaf_launches"] > 0
    assert again["pairs"] == again["pairs_on_device"] == SMALL_SUBTREES - 1
    assert again["leaf_launches"] == 0
    assert 0 < sum(again["launches_by_device"]) \
        < sum(first["launches_by_device"])


def test_merge_on_forced_plain_version(tmp_path, monkeypatch):
    """Merge mode (-f) over the three MSAs of tests/test_torch_pipeline.py's
    merge case (40 sequences each, written by the JAX CLI), through the
    batcher on CPU tensors, byte-equal to the JAX CLI's -f output with
    --backend native."""
    merge = _merge_dir(tmp_path)
    want = str(tmp_path / "jax.aln")
    assert tpu_cli.main(merge + ["-d", str(tmp_path / "jt"), "-o", want,
                                 "--backend", "native"]) == 0
    _forced(monkeypatch)
    out = str(tmp_path / "port.aln")
    rc, kernel = cli.run(merge + ["-d", str(tmp_path / "pt"), "-o", out,
                                  "--backend", "cpu"])
    assert rc == 0
    assert _read(out) == _read(want)
    st = kernel.stats
    assert st["pairs"] == st["pairs_on_device"] == 2
    assert sum(st["launches_by_device"]) > 0
