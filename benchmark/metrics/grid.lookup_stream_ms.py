"""The cell lookup's stream milliseconds a traced frame window: the time
the card's stream took between the CUDA events at the ends of the
program's ``grid.lookup`` spans (``find_cell_direct`` / ``find_cell_rows``,
the last lookup of each chunk included), over the ``transport.frame``
spans recorded.  Not the device's busy time: the stream also idles inside
a span while the host queues its work, and in these host-bound frames
that is most of it, so the number follows the host's time under the
profiler (which slows the host) more than the lookup's device work.
None where the program records no spans (no ``mcrat_tpu_torch.telemetry``,
or no traced window on the card)."""


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    ms = s["spans"].get("grid.lookup", {}).get("stream_ms")
    return None if ms is None else ms / s["frames"]


def read(rec):
    return value(summary())
