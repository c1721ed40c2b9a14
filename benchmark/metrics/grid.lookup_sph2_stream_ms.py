"""The cell lookup's stream milliseconds a traced frame window in the
spherical fireball's cell, where the direct lookup searches the log-spaced
radial axis: read as ``grid.lookup_stream_ms`` reads it, from the program's
``grid.lookup`` spans.  None where the program records no spans."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("grid.lookup_stream_ms").read(rec)
