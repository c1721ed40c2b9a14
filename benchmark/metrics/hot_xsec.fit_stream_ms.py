"""The stream milliseconds a traced frame window of the hot cross sections'
per-frame fit in ``transport.select_variant``: the program's
``hot_xsec.cheb_cells`` span (the Chebyshev rows of every cell) and
``hot_xsec.nt_constants`` span (the subgroup-1 fit and the nonthermal
constants), over the ``transport.frame`` spans recorded.  Stream time, as
the other ``_stream_ms`` metrics: the device work the spans queued and the
device's idle time inside them.  None where the program records no such
span (no ``mcrat_tpu_torch.telemetry``, no traced window on the card, or a
program without these spans)."""

SPANS = ("hot_xsec.cheb_cells", "hot_xsec.nt_constants")


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    ms = [s["spans"].get(name, {}).get("stream_ms") for name in SPANS]
    if all(m is None for m in ms):
        return None
    return sum(m or 0.0 for m in ms) / s["frames"]


def read(rec):
    return value(summary())
