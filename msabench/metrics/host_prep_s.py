"""host_prep_s: seconds an alignment's run thread spends preparing its
levels' pairs (profiles, consensus, gappy columns, gap scores: the
program's `level.prep` span), averaged over the window's alignments.
None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "level.prep")
