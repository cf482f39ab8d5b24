"""msa_s: wall seconds per alignment, the window's time in completed
`cli.run` calls over their count (host clock)."""


def read(rec):
    times = rec["align_s"]
    return sum(times) / len(times) if times else None
