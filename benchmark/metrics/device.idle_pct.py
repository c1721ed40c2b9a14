"""The share of the traced windows' wall in which no operation ran on
the device: 1 - (union of its busy intervals) / wall."""


def read(rec):
    if rec.trace is None or rec.trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.wall_s)
