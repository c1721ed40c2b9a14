"""The fused-round kernel's device time a traced frame window in the cell
of TABLE optical depth with nonthermal electrons on an AMR cell list, where
the kernel reads the rate from per-lane aux planes (``packed_cyl2+aux+nt``):
read as ``fused_round.kernel_ms`` reads it, by the kernel's name in the
profiler's trace."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("fused_round.kernel_ms").read(rec)
