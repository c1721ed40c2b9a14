"""The 90th percentile of the measured window's frame-window walls
(host clock, each ending in a synchronize), linear interpolation."""
import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec.walls) * 1e3, 90))
