"""Device kernels other than the fused-round kernel a traced frame window
launches: the glue's (lookup, lane planes, partition, compaction,
write-back), counted in the profiler's trace."""


def read(rec):
    if rec.trace is None:
        return None
    return rec.trace.other_kernels / rec.trace.windows
