"""delta_scan: the chained delta path's dirty-row rescan, which the hopper
backend replaces by fused_delta. Its least work is not counted, so no
roofline share reads it; its device time still counts as the hand
kernels' and not as the torch ops'.
"""

SYMBOL = "delta_scan_kernel"


def least_s(dep, flavour: str):
    return None, None
