"""RIKEN legacy hydro frames, Fortran unformatted binaries (port of
``mcrat_tpu.io.riken``).

The 2-D path of Src/mclib_riken.c (readHydro2D, :55-418): the
frame consists of per-variable files ``{prefix}u0{N}-{frame:04d}small.data``
(u01 = density, u02 = radial velocity, u03 = polar velocity, u08 = pressure)
each with a Fortran record header (1 float) + six int32 slice indexes
(phi/theta/r min-max, 1-based) + two floats, followed by float32 data with r
fastest; the spherical grid comes from comma-separated text files
``grid-x1.data`` (r) and ``grid-x2.data`` (theta).

The 3-D variant (``read_riken_3d``) re-designs read_hydro (:419-944): five
variable files (u01 dens, u02 v_r, u03 v_theta, u04 v_phi, u08 pres) with the
same Fortran headers but phi-slowest 3-D data, a 7-segment remapped radial
grid (``grid0{s}-x1.data``, getIndexesForRadialRemapping :1123-1249 — segment
s starts at global radial index 420*s, 3780 radii total), analytic radial cell
widths from the recurrence r_i = r_{i-1} (1 + (pi/560)/(1 + r_{i-1}/r_ref))
(:737-744), and the special frame schedule (increment 10 and fps -> 1 beyond
frame 3000, Src/mcrat.c:551-562) as ``riken_frame_schedule``.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..constants import C_LIGHT
from ..grid import HydroFrameHost, frame_from_numpy
from .decimate import decimation_mask


def riken_frame_prefix(prefix: str, var: int, frame: int) -> str:
    """{prefix}u0{var}-{frame:04d}small.data (reference: mclib_riken.c:79-87)."""
    return f"{prefix}u0{var}-{frame:04d}small.data"


def _read_riken_var(path: str):
    """One variable file -> (slice indexes, float32 data)."""
    with open(path, "rb") as f:
        raw = f.read()
    head = np.frombuffer(raw, dtype=np.int32, count=7, offset=0)
    # head[0] is the Fortran record marker; next six are 1-based indexes:
    # phi_min, phi_max, theta_min, theta_max, r_min, r_max
    idx = head[1:7].astype(np.int64) - 1
    # two floats follow the indexes (reference: mclib_riken.c:126-127)
    data_off = 4 * (7 + 2)
    t_lo, t_hi, r_lo, r_hi = idx[2], idx[3], idx[4], idx[5]
    elem = int((r_hi + 1 - r_lo) * (t_hi + 1 - t_lo))
    data = np.frombuffer(raw, dtype=np.float32, count=elem, offset=data_off)
    return (t_lo, t_hi, r_lo, r_hi), np.asarray(data, dtype=np.float64)


def _read_grid_axis(path: str) -> np.ndarray:
    """A comma- or space-separated text grid file as float64."""
    with open(path) as f:
        return np.array([float(x) for x in f.read().replace(",", " ").split()])


def read_riken_2d(
    cfg: Config,
    prefix: str,
    frame: int,
    fps: float,
    r_inj: float,
    ph_inj_switch: bool,
    min_r: float = 0.0,
    max_r: float = np.inf,
    min_theta: float = 0.0,
    max_theta: float = np.pi,
) -> HydroFrameHost:
    (t_lo, t_hi, r_lo, r_hi), dens = _read_riken_var(riken_frame_prefix(prefix, 1, frame))
    _, vel_r = _read_riken_var(riken_frame_prefix(prefix, 2, frame))
    _, vel_t = _read_riken_var(riken_frame_prefix(prefix, 3, frame))
    _, pres = _read_riken_var(riken_frame_prefix(prefix, 8, frame))

    r_all = _read_grid_axis(f"{prefix}grid-x1.data")
    t_all = _read_grid_axis(f"{prefix}grid-x2.data")
    r = r_all[r_lo : r_hi + 1]
    th = t_all[t_lo : t_hi + 1]
    dr = np.gradient(r)
    dth = np.gradient(th)

    nt, nr = len(th), len(r)
    # data layout: r fastest within each theta row (reference: mclib_riken.c:204-210)
    R = np.tile(r, nt)
    TH = np.repeat(th, nr)
    DR = np.tile(dr, nt)
    DTH = np.repeat(dth, nr)

    arr = dict(
        r0=R * cfg.hydro_l_scale,
        r1=TH,
        dr0=DR * cfg.hydro_l_scale,
        dr1=DTH,
        v0=vel_r,
        v1=vel_t,
        dens=dens * cfg.hydro_d_scale,
        pres=pres * cfg.hydro_p_scale,
    )
    keep = decimation_mask(
        cfg,
        arr["r0"], arr["r1"], 0.0, arr["dr0"], arr["dr1"], 0.0,
        fps, r_inj, ph_inj_switch, min_r, max_r, min_theta, max_theta,
        cyclosynchrotron=cfg.cyclosynchrotron,
    )
    arr = {k: v[keep] for k, v in arr.items()}
    return frame_from_numpy(cfg, arr)


# 3-D grid shape and remapping constants (reference: Src/mclib_riken.c:3-5,
# :665-744 — R_DIM=1260, THETA_DIM=PHI_DIM=280, 7 radial remappings that
# overlap by 840 cells so each segment starts 420 global indexes after the
# previous one, 3780 distinct radii in total).
R_DIM_3D = 1260
THETA_DIM_3D = 280
PHI_DIM_3D = 280
N_RADII_3D = 3780
REMAP_STRIDE_3D = 420
ANGULAR_RES_3D = np.pi / 560.0
# frame ranges served by each radial remapping segment (mclib_riken.c:668-716)
_SEGMENT_LAST_FRAME = (1300, 2000, 10000, 20000, 35000, 50000, 60000)


def riken_frame_prefix_3d(prefix: str, var: int, frame: int) -> str:
    """{prefix}u0{var}-{frame:05d}small.data — the 3-D name uses 5-digit frame
    numbers (modifyRikenHydroName, mclib_riken.c:10-53, 3-D branch)."""
    return f"{prefix}u0{var}-{frame:05d}small.data"


def riken_radial_segment(frame: int) -> int:
    """Which grid0{s}-x1.data remapping file serves this frame
    (mclib_riken.c:668-716)."""
    for s, last in enumerate(_SEGMENT_LAST_FRAME):
        if frame <= last:
            return s
    raise ValueError(f"RIKEN frame {frame} beyond last remapping segment")


def riken_radial_edges(r_in: float = 1e10, r_ref: float = 2e13) -> np.ndarray:
    """All 3781 radii of the remapped RIKEN 3-D grid from the recurrence
    r_i = r_{i-1} (1 + (pi/560)/(1 + r_{i-1}/r_ref)) (mclib_riken.c:735-744).
    Segment s's grid file holds these from global index 420*s."""
    edges = np.empty(N_RADII_3D + 1)
    edges[0] = r_in
    for i in range(1, N_RADII_3D + 1):
        edges[i] = edges[i - 1] * (1.0 + ANGULAR_RES_3D / (1.0 + edges[i - 1] / r_ref))
    return edges


def riken_radial_widths(r_in: float = 1e10, r_ref: float = 2e13) -> np.ndarray:
    """Radial cell widths dr over all 3780 remapped radii
    (mclib_riken.c:735-744; the reference leaves dr[3779] uninitialized — here
    the recurrence is extended one extra step so the last width is defined)."""
    return np.diff(riken_radial_edges(r_in, r_ref))


def _read_riken_var_3d(path: str):
    """One 3-D variable file -> (slice indexes, float64 data, phi slowest)."""
    with open(path, "rb") as f:
        raw = f.read()
    head = np.frombuffer(raw, dtype=np.int32, count=7, offset=0)
    idx = head[1:7].astype(np.int64) - 1  # 1-based -> 0-based
    p_lo, p_hi, t_lo, t_hi, r_lo, r_hi = idx
    data_off = 4 * (7 + 2)  # record marker + 6 indexes + two floats
    elem = int((r_hi + 1 - r_lo) * (t_hi + 1 - t_lo) * (p_hi + 1 - p_lo))
    data = np.frombuffer(raw, dtype=np.float32, count=elem, offset=data_off)
    return (p_lo, p_hi, t_lo, t_hi, r_lo, r_hi), np.asarray(data, dtype=np.float64)


def read_riken_3d(
    cfg: Config,
    prefix: str,
    frame: int,
    fps: float,
    r_inj: float,
    ph_inj_switch: bool,
    min_r: float = 0.0,
    max_r: float = np.inf,
    jet_axis: str = "y",
) -> HydroFrameHost:
    """Read one 3-D RIKEN frame into a spherical (r, theta, phi) cell list.

    Re-design of read_hydro (mclib_riken.c:419-944).  Selection grows an
    elem_factor shell around the photons (or r_inj) in radius only, exactly as
    the reference (:803-844).  The RIKEN runs put the jet along the +y axis
    (photonInjection3D measures theta' = acos(y/r), :965); with
    ``jet_axis='y'`` the frame's spherical-theta cache holds that theta' so
    injection wedges and angle bins match the reference geometry.
    """
    idx, dens = _read_riken_var_3d(riken_frame_prefix_3d(prefix, 1, frame))
    _, vel_r = _read_riken_var_3d(riken_frame_prefix_3d(prefix, 2, frame))
    _, vel_t = _read_riken_var_3d(riken_frame_prefix_3d(prefix, 3, frame))
    _, vel_p = _read_riken_var_3d(riken_frame_prefix_3d(prefix, 4, frame))
    _, pres = _read_riken_var_3d(riken_frame_prefix_3d(prefix, 8, frame))
    p_lo, p_hi, t_lo, t_hi, r_lo, r_hi = idx

    seg = riken_radial_segment(frame)
    r_all = _read_grid_axis(f"{prefix}grid0{seg}-x1.data")
    t_all = _read_grid_axis(f"{prefix}grid-x2.data")
    ph_all = _read_grid_axis(f"{prefix}grid-x3.data")
    r = r_all[r_lo : r_hi + 1]
    th = t_all[t_lo : t_hi + 1]
    phi = ph_all[p_lo : p_hi + 1]
    dr_all = riken_radial_widths()
    dr = dr_all[seg * REMAP_STRIDE_3D + r_lo : seg * REMAP_STRIDE_3D + r_hi + 1]

    # r-only shell selection with the growing elem_factor (mclib_riken.c:803-844)
    lo = r_inj if ph_inj_switch else min_r
    hi = r_inj if ph_inj_switch else max_r
    elem_factor = 0
    keep_r = np.zeros(0, dtype=bool)
    while not keep_r.any():
        elem_factor += 1
        width = elem_factor * C_LIGHT / fps
        keep_r = (r > lo - width) & (r < hi + width)

    nr, nt, np_ = len(r), len(th), len(phi)
    # phi slowest, theta, r fastest (mclib_riken.c:880)
    shape = (np_, nt, nr)
    keep = np.broadcast_to(keep_r[None, None, :], shape).ravel()
    R = np.broadcast_to(r[None, None, :], shape).ravel()[keep]
    TH = np.broadcast_to(th[None, :, None], shape).ravel()[keep]
    PHI = np.broadcast_to(phi[:, None, None], shape).ravel()[keep]
    DR = np.broadcast_to(dr[None, None, :], shape).ravel()[keep]

    arr = dict(
        r0=R * cfg.hydro_l_scale,
        r1=TH,
        r2=PHI,
        dr0=DR * cfg.hydro_l_scale,
        dr1=np.full(keep.sum(), ANGULAR_RES_3D),
        dr2=np.full(keep.sum(), ANGULAR_RES_3D),
        v0=vel_r[keep],
        v1=vel_t[keep],
        v2=vel_p[keep],
        dens=dens[keep] * cfg.hydro_d_scale,
        # RIKEN pressure files carry p/c^2; hydro_p_scale restores cgs so the
        # shared temp = (3p/a)^(1/4) matches mclib_riken.c:885 exactly
        pres=pres[keep] * cfg.hydro_p_scale,
    )
    host = frame_from_numpy(cfg, arr)
    if jet_axis == "y":
        # theta' about +y: y = r sin(theta) sin(phi)  (mclib_riken.c:965);
        # the jet_axis field tells inject_photons to measure its wedge from
        # this cache instead of recomputing theta about z
        host.theta = np.arccos(np.clip(np.sin(TH) * np.sin(PHI), -1.0, 1.0))
        host.jet_axis = "y"
    return host


def riken_frame_schedule(frame: int, base_fps: float):
    """(frame increment, fps) for RIKEN 3-D runs: beyond frame 3000 files come
    every 10 frames at 1 fps (reference: Src/mcrat.c:551-562, 612-624)."""
    if frame >= 3000:
        return 10, 1.0
    return 1, base_fps
