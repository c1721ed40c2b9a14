"""The fused-round kernel's share of its roofline in the cells of TABLE
optical depth with nonthermal electrons: read as ``fused_round_roofline``
reads it, the least time from the configuration's own ``least_time``
(its CHEB_NT rate, Maxwell-Juttner draw and 26 table rows a cell)."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("fused_round_roofline").read(rec)
