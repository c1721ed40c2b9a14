"""The host's milliseconds a traced frame window blocked on the device:
the program's spans around its syncs (``transport.loop_test``, the
active-row count a kernel call; ``grid.miss_count``, the carried lookup's
missed lanes; ``transport.fetch``, a chunk's batched fetch), host clock,
over the ``transport.frame`` spans recorded.  None where the program
records no spans."""

WAITS = ("transport.loop_test", "grid.miss_count", "transport.fetch")


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    return sum(s["spans"].get(n, {}).get("host_ms", 0.0) for n in WAITS) / s["frames"]


def read(rec):
    return value(summary())
