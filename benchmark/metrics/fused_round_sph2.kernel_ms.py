"""The fused-round kernel's device time a traced frame window in the
spherical fireball's cell (``packed_sph2``): read as
``fused_round.kernel_ms`` reads it, by the kernel's name in the profiler's
trace."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("fused_round.kernel_ms").read(rec)
