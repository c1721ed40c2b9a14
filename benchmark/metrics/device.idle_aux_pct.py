"""The share of the traced windows' wall in which no operation ran on the
device, in the cell of TABLE optical depth with nonthermal electrons on an
AMR cell list: read as ``device.idle_pct`` reads it."""
from benchmark import spec


def read(rec):
    return spec.metric_reader("device.idle_pct").read(rec)
