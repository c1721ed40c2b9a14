"""The fused-round kernel's device time a traced frame window, by its
name in the profiler's trace."""


def read(rec):
    if rec.trace is None or not rec.trace.fused_kernels:
        return None
    return rec.trace.fused_s * 1e3 / rec.trace.windows
