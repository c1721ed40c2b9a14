"""Hydro-frame decimation (port of ``mcrat_tpu.io.decimate``).

Every reference reader keeps the cells in a radial/angular band around the
live photons, with an alpha-growth retry loop (FLASH: Src/mclib_flash.c:
284-328; PLUTO: Src/mclib_pluto.c:1264-1310; Chombo: Src/mclib_pluto.c:
634-706); this is that logic once, in numpy.
"""
from __future__ import annotations

import numpy as np

from .. import geometry as geo
from ..config import Config, Dims
from ..constants import C_LIGHT

# theta padding: 2 degrees on each side (reference: mclib_flash.c:80-82)
THETA_PAD = 2.0 * 0.017453292519943295


def decimation_mask(cfg: Config, r0, r1, r2, dr0, dr1, dr2, fps: float, r_inj: float,
                    ph_inj_switch: bool, min_r: float, max_r: float, min_theta: float,
                    max_theta: float, cyclosynchrotron: bool = False) -> np.ndarray:
    """Boolean keep-mask over the raw cell list.

    Injection mode (``ph_inj_switch``): keep cells whose spherical centre
    radius exceeds 0.95 r_inj (reference: mclib_flash.c:318-322).  Scattering
    mode: keep cells whose corner extent meets [min_r - f c/fps, max_r +
    f c/fps] x [min_theta - 2 deg, max_theta + 2 deg], growing f until the
    selection is not empty (f starts at 3 with cyclo-synchrotron on, which
    emits into a wider shell: elem_factor, mclib_flash.c:279-283).
    """
    if ph_inj_switch:
        rc, _ = geo.hydro_to_spherical(cfg, r0, r1, r2 if cfg.dims is Dims.THREE else 0.0)
        return np.asarray(rc) > 0.95 * r_inj

    if cfg.dims is Dims.THREE:
        a0, a1, a2 = np.abs(r0), np.abs(r1), np.abs(r2)
        r_in, t_in = geo.hydro_to_spherical(cfg, a0 - dr0 / 2, a1 - dr1 / 2, a2 - dr2 / 2)
        r_out, t_out = geo.hydro_to_spherical(cfg, a0 + dr0 / 2, a1 + dr1 / 2, a2 + dr2 / 2)
    else:
        r_in, t_in = geo.hydro_to_spherical(cfg, r0 - dr0 / 2, r1 - dr1 / 2, 0.0)
        r_out, t_out = geo.hydro_to_spherical(cfg, r0 + dr0 / 2, r1 + dr1 / 2, 0.0)
    r_in, t_in, r_out, t_out = map(np.asarray, (r_in, t_in, r_out, t_out))

    t_lo = min_theta - THETA_PAD
    t_hi = max_theta + THETA_PAD
    factor = 2 if cyclosynchrotron else 0
    for _ in range(200):
        factor += 1
        pad = factor * C_LIGHT / fps
        mask = ((min_r - pad) <= r_out) & (r_in <= (max_r + pad)) & (t_out >= t_lo) & (
            t_in <= t_hi)
        if mask.any():
            return mask
    raise RuntimeError("decimation produced no cells: photon bounds outside grid?")
