"""device_idle_share: % of the traced window (the timed cli.run calls) in
which the card ran no kernel, copy or memset."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
