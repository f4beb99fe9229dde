"""fused_delta: the whole delta beat in one launch: its work depends on
which admission panes changed and which rows each table's batch dirtied,
which no public call of the program reports. Its least work is not
counted, so no roofline share reads it; its device time still counts as
the hand kernels' and not as the torch ops'.
"""

SYMBOL = "fused_delta_kernel"


def least_s(dep, flavour: str):
    return None, None
