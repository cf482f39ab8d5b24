"""Arithmetic of the readers of the program's span totals: the integers
`span_ns.<name>` (a span's self time, summed over a run) that the port's
tracer (`twilight_tpu_torch.trace`) leaves in the batcher's stats of a
traced run, which the window sums over its alignments."""


def span_seconds(rec, *names):
    """Seconds an alignment of the spans `names` together, averaged over
    the window's alignments; None where a name has no total (a program
    without the tracer, or an untraced run)."""
    st = rec["stats"]
    keys = [f"span_ns.{n}" for n in names]
    if not rec["align_s"] or any(k not in st for k in keys):
        return None
    return sum(st[k] for k in keys) / 1e9 / len(rec["align_s"])
