"""The glue's stream milliseconds a traced frame window: the time the
card's stream took between the CUDA events at the ends of the program's
``transport.frame`` spans, less that of the ``fused_round.call`` spans
inside them, over the frames recorded.  Not the device's busy time: the
stream idles inside a span while the host queues its work, so in these
host-bound frames the number is close to the traced window less the
kernel calls, and follows the host's time under the profiler (which
slows the host).  None where the program records no spans."""


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    frame = s["spans"].get("transport.frame", {}).get("stream_ms")
    if frame is None:
        return None
    kernel = s["spans"].get("fused_round.call", {}).get("stream_ms") or 0.0
    return (frame - kernel) / s["frames"]


def read(rec):
    return value(summary())
