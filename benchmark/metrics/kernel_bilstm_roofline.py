"""The BiLSTM recurrence kernels' share of their roofline (forward and
backward together)."""
from ._roofline import share


def read(rec):
    return share(rec, "bilstm")
