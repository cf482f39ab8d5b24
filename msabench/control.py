"""The readings the limits of `correct` were set from (PERF.md):
`python3 -m msabench.control --workload <cell> --seeds <a,b,...>
--seconds <s>`.

In one process, after one set-up, it runs a window of the cell a seed
and reads each compared number twice: once for the program (the lower
readings), and once for the control, the plain reference computed in
bfloat16, the precision below the configuration's float32, put in the
program's place for the same sampled pairs (the upper readings), judged
by the same comparison as the program (`judge.judge` with the control's
answers): its paths and DP cells, the profiles and gap scores it works
out from the written rows, and, for a leaf pair or a merge, its own path
in place of what the file spells. The benchmark's own runs never run it.
One JSON line a seed, then a summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import judge
from .run import Bench, NoCard


def main(argv=None, testing=None) -> int:
    p = argparse.ArgumentParser(prog="msabench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    program, control = {}, {}
    with tempfile.TemporaryDirectory(prefix="msabench-control-") as work:
        try:
            b = Bench(args.workload, work, testing)
        except NoCard as e:
            print(f"msabench.control: {e}", file=sys.stderr)
            return 2
        try:
            b.setup(seeds[0])
            for seed in seeds:
                win = b.window(seed, args.seconds, False)
                _, jobs = judge.jobs_of(b, win)
                both = judge.reference_paths(
                    jobs + [{**j, "bf16": True} for j in jobs])
                refs, low = both[:len(jobs)], both[len(jobs):]
                checks, info = judge.judge(b, win, refs)
                ctl = {k: v for k, (v, _) in
                       judge.judge(b, win, refs, low)[0].items()}
                line = {"seed": seed, "alignments": len(win.align_s),
                        "msa_s": sum(win.align_s) / len(win.align_s),
                        "program": {k: v for k, (v, _) in checks.items()},
                        "control": ctl, "judged": info}
                print(json.dumps(line), flush=True)
                for k, (v, _) in checks.items():
                    program.setdefault(k, []).append(v)
                for k, v in ctl.items():
                    control.setdefault(k, []).append(v)
        finally:
            b.close()
    print(json.dumps({
        "lower": {k: max(v) for k, v in program.items()},
        "upper": {k: min(v) for k, v in control.items()},
        "seeds": seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
