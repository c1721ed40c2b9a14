"""The fused-round kernel's share of its roofline: the least time the
traced windows' photons need (the configuration's ``least_time``, a lower
bound) over the kernel's device time in them."""


def read(rec):
    if rec.trace is None or not rec.trace.fused_kernels or rec.trace.fused_s <= 0:
        return None
    least = sum(rec.config.least_time(rec.spec, rec.n_photons, n, rec.n_cells_held)[0]
                for n in rec.trace_n_scatt)
    return 100.0 * least / rec.trace.fused_s
