"""host_post_s: seconds an alignment's run thread spends after the DP:
each pair's splice-back, profile merge and path (`level.post`, less its
host DP) and the root's update (`root_update`), averaged over the
window's alignments. None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "level.post", "root_update")
