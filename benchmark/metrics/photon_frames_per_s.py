"""Photons advanced through a frame window, summed over the measured
window's windows, over its seconds (host clock)."""


def read(rec):
    return rec.n_photons * len(rec.walls) / rec.window_s
