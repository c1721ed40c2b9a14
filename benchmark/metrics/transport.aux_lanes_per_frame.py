"""Lanes the aux planes are computed for a traced frame window: the
program's counter ``transport.aux_lanes`` (each kernel call's padded lane
count on the carried path in TABLE mode) over the ``transport.frame`` spans
recorded.  None where the program records no spans or has no such
counter."""


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    lanes = s["counters"].get("transport.aux_lanes")
    return None if lanes is None else lanes / s["frames"]


def read(rec):
    return value(summary())
