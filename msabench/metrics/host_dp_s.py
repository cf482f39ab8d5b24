"""host_dp_s: seconds an alignment's run thread spends in host DP (levels
the gate keeps on the host, and the post phase's ladder re-checks: the
program's `level.dp_host` span), averaged over the window's alignments.
None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "level.dp_host")
