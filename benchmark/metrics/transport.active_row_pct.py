"""The share of the 128-lane rows the glue lays out for the kernel that
still hold an active lane, over the traced windows' kernel calls (the
program's counter ``transport.kernel_calls``): 100 x the counter
``transport.rows_active`` over ``transport.rows_total``, each summed over
those calls.  100 less it is the share of the lookup's and lane planes'
work spent on finished rows.  None where the program records no spans or
no kernel call."""


def summary():
    try:
        from mcrat_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.summary()


def value(s):
    if not s or not s.get("frames"):
        return None
    c = s["counters"]
    if not c.get("transport.kernel_calls") or not c.get("transport.rows_total"):
        return None
    return 100.0 * c.get("transport.rows_active", 0) / c["transport.rows_total"]


def read(rec):
    return value(summary())
