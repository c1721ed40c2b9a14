"""Lanes the carried lookup searches a traced frame window (the index
search of the lanes that left their cached cell): the program's counter
``grid.search_lanes`` over the ``transport.frame`` spans recorded.  None
where the program records no spans."""


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    return s["counters"].get("grid.search_lanes", 0) / s["frames"]


def read(rec):
    return value(summary())
