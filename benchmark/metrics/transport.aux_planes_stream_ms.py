"""The aux planes' stream milliseconds a traced frame window: the time the
card's stream took between the CUDA events at the ends of the program's
``transport.aux_planes`` spans (before each kernel call on the carried
path in TABLE mode, every lane's cell rows gathered, its bilinear
sigma_hat, the subgroups' sigmas, the biased total and the thermal
probability), over the ``transport.frame`` spans recorded.  Stream time,
as the other ``_stream_ms`` metrics: the device work the spans queued and
the device's idle time inside them.  None where the program records no
such span (no ``mcrat_tpu_torch.telemetry``, no traced window on the card,
or no aux planes in the frames traced)."""


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    ms = s["spans"].get("transport.aux_planes", {}).get("stream_ms")
    return None if ms is None else ms / s["frames"]


def read(rec):
    return value(summary())
