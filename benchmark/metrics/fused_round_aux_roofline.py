"""The fused-round kernel's share of its roofline in the cell of TABLE
optical depth with nonthermal electrons on an AMR cell list: read as
``fused_round_roofline`` reads it, the least time from the configuration's
own ``least_time``, which counts the window's physics once whatever
computes it (one TABLE rate evaluation a photon and a scattering, though
the program evaluates the rate in the glue's aux planes; one
Maxwell-Juttner trial a scattering; 10 table rows a cell)."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("fused_round_roofline").read(rec)
