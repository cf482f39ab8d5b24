"""batcher_event_wait_s: seconds an alignment's batcher thread is blocked
on its launches' events (the program's `batcher.wait` span), averaged
over the window's alignments. None where the program wrote no span
totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "batcher.wait")
