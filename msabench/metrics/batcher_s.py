"""batcher_s: seconds an alignment spends in calls into the DP batcher
(pack, launch, wait and host stealing together), the union of the seam's
spans, averaged over the window's alignments."""
from msabench.metrics_util import batcher_seconds


def read(rec):
    per = batcher_seconds(rec)
    return sum(per) / len(per) if per else None
