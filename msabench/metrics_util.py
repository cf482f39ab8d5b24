"""Arithmetic the metric readers share."""


def batcher_seconds(rec) -> list:
    """Per timed alignment, the seconds covered by its calls into the
    batcher (the union of the seam's spans: calls may overlap)."""
    by_k = {}
    for k, a, b in rec["batcher_spans"]:
        by_k.setdefault(k, []).append((a, b))
    out = []
    for k in range(len(rec["align_s"])):
        total, end = 0.0, None
        for a, b in sorted(by_k.get(k, [])):
            if end is None or a >= end:
                total, end = total + b - a, b
            elif b > end:
                total, end = total + b - end, b
        out.append(total)
    return out
