"""bitmask_join: the block join into a small index-less PK table; no TPC-W
join takes it. Its least work is not counted, so no roofline share reads
it; its device time still counts as the hand kernels' and not as the
torch ops'.
"""

SYMBOL = "bitmask_join_kernel"


def least_s(dep, flavour: str):
    return None, None
