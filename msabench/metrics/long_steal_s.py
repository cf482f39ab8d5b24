"""long_steal_s: seconds of host DP an alignment spends on the long pairs
its batcher's host stole (the program's `batcher.steal_long` span, self
time), averaged over the window's alignments. The stealers run on
several threads at once, so this is thread-seconds, not wall time. None
where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "batcher.steal_long")
