"""wait_batcher_s: seconds an alignment's run thread spends waiting for
the batcher's results (the program's `level.wait` span), averaged over
the window's alignments. None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "level.wait")
