"""batcher_pack_s: seconds an alignment's batcher spends packing its
launches (the program's `batcher.pack` span), averaged over the window's
alignments. None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "batcher.pack")
