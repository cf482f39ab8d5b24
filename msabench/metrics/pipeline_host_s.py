"""pipeline_host_s: seconds an alignment spends in `cli.run` outside the
calls into the DP batcher, averaged over the window's alignments."""
from msabench.metrics_util import batcher_seconds


def read(rec):
    per = batcher_seconds(rec)
    if not per:
        return None
    return sum(t - b for t, b in zip(rec["align_s"], per)) / len(per)
