"""peak_rss_gib: the process's peak resident host memory (ru_maxrss) at
the window's close, in GiB: set-up, warm-up and window, no reference."""


def read(rec):
    return rec["peak_rss_bytes"] / 2 ** 30
