"""The gather/segment-sum kernel's share of its roofline (its fused
k-hop form over a kernel plan, and its sorted-sum form under COO)."""
from ._roofline import share


def read(rec):
    return share(rec, "gather")
