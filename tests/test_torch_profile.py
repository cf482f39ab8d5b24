"""The port's TWILIGHT_PROFILE lines: the batcher's (one a launch, one a
call, the blocked time above 1 s; the JAX batcher's `[dev]` lines) and
the tree estimator's (k-mer, distance path, NJ/PartTree; the JAX
estimator's `[profile]` lines). Without the variable none is printed."""
import re

import numpy as np
import pytest

from twilight_tpu_torch import cli
from twilight_tpu_torch.ops import device_kernel as dk
from twilight_tpu_torch.tools import simulate
from twilight_tpu_torch.trees import estimate

LAUNCH = re.compile(r"^    \[dev\] launch (short|long) (leaf|freq)( wide)?"
                    r"( q\d)? p(\d+) w(\d+) b(\d+) n(\d+): pack=[\d.]+s "
                    r"launch=[\d.]+s wait=([\d.]+s|-)$", re.M)
CALL = re.compile(r"^    \[dev\] call done: pairs=(\d+) device=(\d+) "
                  r"host-stolen=(\d+) steal_dp=[\d.]+s launches=(\d+) "
                  r"wall=[\d.]+s$", re.M)


@pytest.mark.parametrize("profile", [True, False], ids=["on", "off"])
def test_batcher_lines_one_a_launch_and_a_call(tmp_path, capfd, monkeypatch,
                                               profile):
    """A forced run on two CPU queues (the plain version): under
    TWILIGHT_PROFILE one launch line for each launch, whose pair counts
    add up to the pairs launched, and one call line for each batcher
    call, whose counts add up to the stats line's; without it, no line of
    either kind."""
    prefix = str(tmp_path / "s12")
    assert simulate.main(["-n", "12", "-l", "100", "--seed", "4", "-o",
                          prefix]) == 0
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    monkeypatch.setenv("TWILIGHT_TORCH_CPU_DEVICES", "2")
    if profile:
        monkeypatch.setenv("TWILIGHT_PROFILE", "1")
    else:
        monkeypatch.delenv("TWILIGHT_PROFILE", raising=False)
    calls = []
    real = dk.DeviceTalco.__call__

    def counted(self, prepared, *args, **kw):
        calls.append(len(prepared))
        return real(self, prepared, *args, **kw)

    monkeypatch.setattr(dk.DeviceTalco, "__call__", counted)
    capfd.readouterr()
    rc, kernel = cli.run(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                          "-o", str(tmp_path / "out.aln"), "--backend",
                          "cpu", "--pair-batch", "4"])
    assert rc == 0
    err = capfd.readouterr().err
    st = kernel.stats
    launches, done = LAUNCH.findall(err), CALL.findall(err)
    if not profile:
        assert "[dev]" not in err and not launches and not done
        return
    assert len(launches) == sum(st["launches_by_device"]) > 0
    assert len(done) == len(calls) > 1
    assert [int(c[0]) for c in done] == calls
    assert sum(int(c[1]) for c in done) == st["pairs_on_device"]
    assert sum(int(c[3]) for c in done) == len(launches)
    assert sum(int(ln[7]) for ln in launches) == st["pairs_on_device"]
    assert {ln[3] for ln in launches} == {" q0", " q1"}
    assert sum(ln[1] == "leaf" for ln in launches) == st["leaf_launches"]
    assert all(ln[6] == "4" and ln[8] != "-" for ln in launches)


def test_blocked_line_above_one_second(capfd):
    """The round's blocked time on launches is printed above 1 s only."""
    batcher = dk.DeviceTalco.__new__(dk.DeviceTalco)
    batcher.batch = 8
    launches = [dk._Launch([0, 1], None, None, None, 2048)
                for _ in range(3)]
    for ln, wait in zip(launches, (0.4, None, 0.5)):
        ln.wait_s = wait
    batcher._print_round(launches, [("short freq", 4096)] * 3)
    err = capfd.readouterr().err
    assert len(LAUNCH.findall(err)) == 3 and "wait=-" in err
    assert "blocked" not in err
    launches[1].wait_s = 0.2
    batcher._print_round(launches, [("short freq", 4096)] * 3)
    assert "    [dev] blocked 1.1s on launches" in capfd.readouterr().err


@pytest.mark.parametrize("aligned", [False, True], ids=["kmer", "msa"])
def test_estimator_lines(capfd, monkeypatch, aligned):
    """build_guide_tree's k-mer time (unaligned input), distance path and
    NJ/PartTree time under TWILIGHT_PROFILE, and none without it."""
    rng = np.random.default_rng(2)
    base = rng.choice(list("ACGT"), 120)
    seqs = []
    for _ in range(12):
        s = base.copy()
        s[rng.random(120) < 0.1] = "-" if aligned else "A"
        seqs.append("".join(s))
    names = [f"S{i}" for i in range(12)]
    monkeypatch.setenv("TWILIGHT_PROFILE", "1")
    estimate.build_guide_tree(names, seqs, aligned=aligned)
    err = capfd.readouterr().err
    lines = re.findall(r"^  \[profile\] (.*)$", err, re.M)
    want = ([] if aligned else ["k-mer profiles"]) \
        + ["distance matrix: host path", "NJ/PartTree"]
    assert [ln.split(":")[0] if ln.startswith(("k-mer", "NJ")) else ln
            for ln in lines] == want
    monkeypatch.delenv("TWILIGHT_PROFILE")
    estimate.build_guide_tree(names, seqs, aligned=aligned)
    assert "[profile]" not in capfd.readouterr().err
