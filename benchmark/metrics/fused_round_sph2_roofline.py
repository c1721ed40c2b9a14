"""The fused-round kernel's share of its roofline in the spherical
fireball's cell (``packed_sph2``): read as ``fused_round_roofline`` reads
it, the least time from the configuration's own ``least_time`` (the sph2
round's geometry counts, 11 table rows a cell)."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("fused_round_roofline").read(rec)
