"""A profile off by one column where the program's native level prep
makes it (`helpers.prepare_level_native`, the main path of level prep):
the DP aligns what the rows do not hold, and the judge's profile check
reads it, so `correct` comes out false."""
import json

from conftest import cpu_testing

from msabench import run


def test_shifted_native_profile_is_not_correct(bench_copy, capsys,
                                                monkeypatch):
    from twilight_tpu_torch.pipeline import helpers
    prep = helpers.prepare_level_native

    def wrong(pairs, *args):
        out = prep(pairs, *args)
        for i, ((ref, _), p) in enumerate(zip(pairs, out)):
            n = p[4][0]          # the reference's compacted length
            if ref.aln_num > 1 and n > 1:
                fr = p[0].copy()
                fr[1:n] = fr[:n - 1].copy()
                out[i] = (fr, *p[1:])
        return out
    monkeypatch.setattr(helpers, "prepare_level_native", wrong)
    extra = {"env": {"TWILIGHT_FORCE_DEVICE": "1", "TWILIGHT_NO_STEAL": "1"}}
    rc = run.main(["--workload", "nt.tiny", "--seed", "99", "--seconds",
                   "0.5", "--trace", "0"],
                  testing=cpu_testing(bench_copy, **extra))
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["profile_residual"]["value"] > \
        res["checks"]["profile_residual"]["limit"]
