"""host_io_s: seconds an alignment's run thread spends reading the tree
and the sequences and writing files (the program's `io.tree`, `io.read`,
`io.write` and `subtree.store` spans, self time), averaged over the
window's alignments. None where the program wrote no span totals."""
from msabench.span_totals import span_seconds


def read(rec):
    return span_seconds(rec, "io.tree", "io.read", "io.write",
                        "subtree.store")
