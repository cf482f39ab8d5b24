"""host_other_s: seconds an alignment's run thread spends in no named
leaf span (the self time of the program's `run`, `level`, `deferred`,
`subtree` and `merge` spans), averaged over the window's alignments.
None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "run", "level", "deferred", "subtree", "merge")
