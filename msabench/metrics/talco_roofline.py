"""talco_roofline: % of the TALCO kernel's roofline: the least time the
H100 could take for the collected launches' DP cells and bytes
(roofline.bound_s) over the device time of every kernel in the traced
window. None without a trace or a kernel in it."""
from msabench.roofline import bound_s


def read(rec):
    tr = rec["trace"]
    if not tr or tr["kernel_s"] <= 0 or rec["ops"] <= 0:
        return None
    return 100.0 * bound_s(rec["ops"], rec["bytes"]) / tr["kernel_s"]
