"""Cross-level scheduling (TWILIGHT_CROSS_LEVEL=1) in the port, held byte
for byte to the JAX package's CLI: the counterparts of
tests/test_crosslevel.py's deferral-heavy parity (there against the
per-level run) and its run through the sharded batcher (here the port's
batcher on two CPU queues, the kernel's plain version); and one batcher
call that holds pairs of several levels (a cross-level round), each path
held to the host ladder's.

Tolerance: byte equality of the output FASTA and of every path."""
import re

import numpy as np
import pytest

from twilight_tpu import cli as tpu_cli
from twilight_tpu_torch import cli
from twilight_tpu_torch.config import Options, Params
from twilight_tpu_torch.ops import device_kernel as dk

from test_torch_device_kernel import _DB, _prepared
from test_torch_resume import _read, _set


@pytest.fixture(scope="module")
def deferral_set(tmp_path_factory):
    """simulate -n 300 -l 400 --seed 11 with --length-deviation 0.02, and
    the JAX CLI's per-level output of it with --backend native."""
    d = tmp_path_factory.mktemp("xl")
    argv = _set(str(d), 300, 400, 11) + [
        "--length-deviation", "0.02", "--backend", "native", "-C", "4"]
    want = str(d / "jax.aln")
    assert tpu_cli.main(argv + ["-o", want]) == 0
    return argv, _read(want)


@pytest.mark.parametrize("cross_level", [False, True],
                         ids=["per_level", "cross_level"])
def test_deferred_parity_with_jax_per_level(tmp_path, capfd, monkeypatch,
                                            deferral_set, cross_level):
    """The order-sensitive deferral path (65 profiles realigned) with and
    without cross-level rounds, each byte-equal to the JAX per-level run;
    under the flag the task-0 pairs go in rounds, no more of them than
    the per-level run's levels."""
    argv, want = deferral_set
    if cross_level:
        monkeypatch.setenv("TWILIGHT_CROSS_LEVEL", "1")
    else:
        monkeypatch.delenv("TWILIGHT_CROSS_LEVEL", raising=False)
    out = str(tmp_path / "port.aln")
    capfd.readouterr()
    assert cli.main(argv + ["-o", out, "-v"]) == 0
    err = capfd.readouterr().err
    assert _read(out) == want
    assert "Realign profiles that have been deferred" in err
    realigned = int(re.search(r"Total profiles/sequences: (\d+)",
                              err).group(1))
    rounds = len(re.findall(r"^Round \d+, aligned", err, re.M))
    levels = len(re.findall(r"^Level \d+, aligned", err, re.M))
    if cross_level:
        assert 0 < rounds <= levels + realigned and levels == realigned
    else:
        assert rounds == 0 and levels > realigned


def test_crosslevel_two_queues_forced(tmp_path, capfd, monkeypatch):
    """tests/test_crosslevel.py:63 on the port: -n 24 -l 120 --seed 7
    --rooted, cross-level, every level forced through the batcher on two
    CPU queues, byte-equal to the JAX CLI with --backend numpy; both
    queues launch, and every pair resolves on them."""
    argv = _set(str(tmp_path), 24, 120, 7) + ["--rooted"]
    want = str(tmp_path / "ref.aln")
    assert tpu_cli.main(argv + ["-o", want, "--backend", "numpy"]) == 0
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    monkeypatch.setenv("TWILIGHT_CROSS_LEVEL", "1")
    monkeypatch.setenv("TWILIGHT_TORCH_CPU_DEVICES", "2")
    out = str(tmp_path / "port.aln")
    rc, kernel = cli.run(argv + ["-o", out, "--backend", "cpu",
                                 "--pair-batch", "8"])
    assert rc == 0
    assert _read(out) == _read(want)
    st = kernel.stats
    assert len(st["launches_by_device"]) == 2
    assert all(st["launches_by_device"])
    assert st["pairs_on_device"] == st["pairs"] == 23
    assert st["leaf_launches"] > 0


def test_one_call_of_several_levels(monkeypatch):
    """A cross-level round's batcher call: two task-0 leaf pairs (level
    0) beside profile pairs of later levels, one of which the kernel
    answers with error 1 (injected into its launch's output). Leaf and
    freq pairs go to separate launches, the errored pair is final at task
    0 (None, counted in task0_errors, no relaunch), and every other path
    equals the host ladder's."""
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    rng = np.random.default_rng(13)
    opt = Options(device_backend="cpu", type="n", pair_batch=8)
    param = Params.make("n")
    prepared, metas = _prepared(rng, 6, 6, lens=[
        (60, 70), (80, 75), (90, 95), (120, 110), (150, 140), (130, 60)])
    for i in (0, 1):            # two raw sequences: one-hot profiles of
        rl, ql = prepared[i][4]  # their letters, scalar gap scores
        metas[i] = (rl, ql, 1, 1)
        fr, fq = (np.eye(6, dtype=np.float32)[f.argmax(1)]
                  for f in prepared[i][:2])
        prepared[i] = (fr, fq) + prepared[i][2:5] + (
            (np.full(rl, param.gap_open, np.float32),
             np.full(ql, param.gap_open, np.float32)),
            (np.full(rl, param.gap_extend, np.float32),
             np.full(ql, param.gap_extend, np.float32)))
    for i in (3, 4):            # profiles of two and three sequences
        metas[i] = metas[i][:2] + (2, 3)
    batcher = dk.DeviceTalco(opt, param, "cpu")
    real = batcher._launch
    routes = []

    def launch(chunk, padlen, prepared, metas, task, leaf, *args):
        routes.append((leaf, sorted(chunk)))
        ln = real(chunk, padlen, prepared, metas, task, leaf, *args)
        if 5 in chunk:
            _, tail = dk.out_views(ln.host_out, len(chunk), padlen)
            tail[list(chunk).index(5), 1] = 1
        return ln

    monkeypatch.setattr(batcher, "_launch", launch)
    res = batcher(prepared, metas, _DB(), opt, param)
    assert sorted(routes) == [(False, [2, 3, 4, 5]), (True, [0, 1])]
    st = batcher.stats
    assert (st["leaf_launches"], st["task0_errors"], st["pairs_on_device"],
            st["ladder_relaunches"]) == (1, 1, 5, 0)
    assert st["launches_by_device"] == [2]
    assert res[5] is None
    for i in range(5):
        np.testing.assert_array_equal(
            res[i], batcher._host_align(prepared[i], metas[i], 0))
