"""The port's host ladder (twilight_tpu_torch/ops/ladder.py) against the
JAX package's (`twilight_tpu/pipeline/aligner._run_talco_with_retries`):
on pairs whose first attempt ends in error 1 (a query insertion that
costs more than the X-drop) or error 2 (flat scores, so the band outgrows
the starting width), at tasks 0, 1 and 2, with sides below and above
10000 sequences, both give the same path, the same fallback flag and the
same ladder state at every attempt, and `gap_char_zero` is the JAX
package's rule. On real pairs the width is capped at the shorter side
after a step; a scripted host kernel (errors 2, 1, 2, then a path) on
sides of 30000 columns holds the uncapped steps too."""
import numpy as np
import pytest

from twilight_tpu import config as tpu_config
from twilight_tpu.ops import talco_host as tpu_talco_host
from twilight_tpu.pipeline import aligner as tpu_aligner
from twilight_tpu_torch.config import Options, Params
from twilight_tpu_torch.ops import ladder, talco_host

EYE = np.eye(6, dtype=np.float32)


def _insertion_pair(rng):
    """1200 related columns with 1500 random ones inserted into the query:
    the gaps cost more than the starting X-drop of 5000 (error 1)."""
    base = rng.integers(0, 4, 1216)
    q = base.copy()
    mut = rng.random(len(q)) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    q = np.concatenate([q[:600], rng.integers(0, 4, 1500), q[600:1200]])
    return EYE[base[:1200]], EYE[q], -50.0, -5.0, False


def _flat_pair(rng):
    """Two unrelated 4200-column sequences under an all-zero matrix and
    gap scores near 0: every cell of an anti-diagonal stays within the
    X-drop, so the band outgrows the starting width of 4096 (error 2)."""
    return (EYE[rng.integers(0, 4, 4200)], EYE[rng.integers(0, 4, 4197)],
            -0.01, -0.001, True)


def _scripted_pair(rng):
    """Sides of 30000 and 28000 columns for a scripted host kernel, which
    reads none of them."""
    return (np.zeros((30000, 6), np.float32),
            np.zeros((28000, 6), np.float32), -50.0, -5.0, False)


def _kernel(real, seen, script):
    """The host kernel `real`, or the errors of `script` and then a path,
    each attempt's (error, flen, xdrop) appended to `seen`."""
    def align(tp, *args):
        if script is None:
            aln, err = real(tp, *args)
        else:
            err = script[min(len(seen), len(script) - 1)]
            aln = (np.arange(9, dtype=np.int8) % 3 if err == 0
                   else np.zeros(0, np.int8))
        seen.append((err, tp.flen, tp.xdrop))
        return aln, err
    return align


PAIRS = {"error1": _insertion_pair, "error2": _flat_pair,
         "scripted": _scripted_pair}


@pytest.mark.parametrize("kind,task,num", [
    ("error1", 0, (10000, 3)), ("error1", 0, (10001, 2)),
    ("error1", 1, (2, 3)), ("error1", 1, (2, 10001)),
    ("error1", 2, (2, 3)), ("error1", 2, (10001, 10001)),
    ("error2", 0, (1, 1)), ("error2", 1, (10001, 3)), ("error2", 2, (1, 1)),
    ("scripted", 1, (2, 3)), ("scripted", 2, (10001, 2)),
])
def test_host_ladder_equals_jax_ladder(kind, task, num, monkeypatch):
    rng = np.random.default_rng(task * 7 + num[0] % 5)
    fr, fq, go, ge, flat = PAIRS[kind](rng)
    fr, fq = fr * np.float32(num[0]), fq * np.float32(num[1])
    lens = (len(fr), len(fq))
    gap_op = (np.full(lens[0], go, np.float32),
              np.full(lens[1], go, np.float32))
    gap_ex = (np.full(lens[0], ge, np.float32),
              np.full(lens[1], ge, np.float32))
    param, want_param = Params.make("n"), tpu_config.Params.make("n")
    if flat:
        param.scoring_matrix = np.zeros_like(param.scoring_matrix)
        want_param.scoring_matrix = np.zeros_like(want_param.scoring_matrix)
    rn, qn = num
    # twilight_tpu/pipeline/aligner.py:176
    want_zero = task == 1 or task == 2 or rn > 10000 or qn > 10000
    zero = ladder.gap_char_zero(task, rn, qn)
    assert zero == want_zero

    script = [2, 1, 2, 0] if kind == "scripted" else None
    seen, want_seen = [], []
    for mod, log in ((talco_host, seen), (tpu_talco_host, want_seen)):
        monkeypatch.setattr(mod, "align_freq",
                            _kernel(mod.align_freq, log, script))
        if script:
            monkeypatch.setattr(mod, "available", lambda: True)
    fnum = (float(rn), float(qn))
    got, got_fallback = ladder.run_talco_with_retries(
        fr, fq, gap_op, gap_ex, fnum, lens, param, zero, task,
        Options(device_backend="native"))
    want, want_fallback = tpu_aligner._run_talco_with_retries(
        fr, fq, gap_op, gap_ex, fnum, lens, want_param, want_zero, task,
        tpu_config.Options(device_backend="native"))
    assert seen == want_seen
    assert seen[0][0] == (1 if kind == "error1" else 2)
    assert got_fallback == want_fallback == (task == 0)
    if task == 0:
        assert got is None and want is None and len(seen) == 1
    else:
        assert len(seen) > 1 and seen[-1][0] == 0
        np.testing.assert_array_equal(got, want)
    if script:
        # uncapped: 4096 -> 9830 (error 2), X-drop 5000 -> 10000 and
        # width 80000 capped at 28000 (error 1), then 28000 again
        assert [s[1:] for s in seen] == [(4096, 5000), (9830, 5000),
                                        (28000, 10000), (28000, 10000)]
