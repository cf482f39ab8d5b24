"""host_setup_s: seconds an alignment's run thread spends on set-up: the
flags, scores and batcher (`run.setup`), the partition (`tree.partition`),
the reroot and weights (`tree.subtree`) and the schedule (`schedule`),
self time averaged over the window's alignments. None where the program
wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "run.setup", "tree.partition", "tree.subtree",
                        "schedule")
