"""The comparison that decides ``correct``: one frame window of the program
against the reference's window from the same inputs, each side drawing its
own random numbers.

Which random numbers a photon draws depends on how a side schedules its
work (lanes, chunks, partitions, compactions), so two sound implementations
of the transport agree in distribution, not photon for photon.  The
numbers compared, none of which depends on the schedule:

- ``photons_off``: live photons that break a guarantee of the transport on
  the program's side (``guarantees``): weight or type changed, fewer
  scatterings than before, frame time left, a lab momentum off the light
  cone, a move farther than light goes in the window, an unscattered
  photon not moved straight on at c or its momentum changed, a value not
  finite, a cell that does not hold the photon;
- ``stat_z_max``: the largest |z| of the paired statistics (``FEATURES``):
  for each photon and each feature the program's value less the
  reference's, z = mean / (standard deviation / sqrt(N)).  A sound program
  reads a standard normal in each; a fault of a few per mille in a mean
  reads tens at a million photons;
- ``scatter_count_off``: the program's own count of the window's
  scatterings (``FrameResult.n_scatt``, which the roofline reads) against
  the sum over its photons.
"""
from __future__ import annotations

import math

import torch

C_LIGHT = 2.99792458e10
NULL_TYPE = 5
POOL_TYPE = 2
COMPTONIZED_TYPE = 1
# tolerances of the guarantees, each far above float32 rounding over a
# window's rounds and far below what a fault moves
REL_WEIGHT = 1e-6  # of the weight
REL_T_REM = 1e-6  # of the window's time
REL_NULL = 1e-4  # |p| against p0
REL_MOVE = 1e-2  # of the distance light goes in the window
REL_MOMENTUM = 1e-5  # of p0, an unscattered photon's momentum
FEATURES = ("scatterings", "scattered", "log_e_lab", "log_e_lab_sq", "log_e_comoving", "mu",
            "dz", "dr", "q", "u", "v", "pol2")


def live(before: dict):
    return (before["weight"] > 0) & (before["ptype"] != NULL_TYPE)


def _f64(x):
    return x.to(torch.float64)


def guarantees(before: dict, after: dict, dt_max: float, holds) -> torch.Tensor:
    """(N,) bool: the live photons of ``after`` that break a guarantee.
    ``before`` is the window's input population, ``holds(pos, cell)`` the
    reference's test of which photons' cell holds their position."""
    light = C_LIGHT * dt_max
    p0b, pb, posb = _f64(before["p"][:, 0]), _f64(before["p"]), _f64(before["pos"])
    p, pos = _f64(after["p"]), _f64(after["pos"])
    dns = _f64(after["num_scatt"]) - _f64(before["num_scatt"])
    wb = _f64(before["weight"])
    pool = before["ptype"] == POOL_TYPE
    bad = (_f64(after["weight"]) - wb).abs() > REL_WEIGHT * wb.abs()
    bad |= (after["ptype"] != before["ptype"]) & ~(pool & (after["ptype"] == COMPTONIZED_TYPE))
    bad |= (dns < 0) | (dns != dns.round())
    bad |= _f64(after["t_rem"]).abs() > REL_T_REM * dt_max
    norm = torch.linalg.vector_norm(p[:, 1:], dim=1)
    bad |= ~(p[:, 0] > 0) | ((norm - p[:, 0]).abs() > REL_NULL * p[:, 0])
    move = pos - posb
    bad |= ~pool & (torch.linalg.vector_norm(move, dim=1) > light * (1 + REL_MOVE))
    straight = pos - (posb + light * pb[:, 1:] / p0b[:, None])
    still = (dns == 0) & ~pool
    bad |= still & (torch.linalg.vector_norm(straight, dim=1) > REL_MOVE * light)
    bad |= still & ((p - pb).abs().amax(dim=1) > REL_MOMENTUM * p0b)
    s = _f64(after["s"])
    bad |= ~holds(after["pos"], after["cell"])
    bad |= ~torch.isfinite(torch.cat([p, pos, s, _f64(after["comv_p"])], dim=1)).all(dim=1)
    return bad & live(before)


def features(before: dict, after: dict, dt_max: float, log_e_centre: float) -> dict:
    """Each photon's value of every statistic in ``FEATURES``, float64."""
    light = C_LIGHT * dt_max
    p, c, pos, posb = _f64(after["p"]), _f64(after["comv_p"]), _f64(after["pos"]), \
        _f64(before["pos"])
    s = _f64(after["s"])
    dns = _f64(after["num_scatt"]) - _f64(before["num_scatt"])
    log_e = torch.log(p[:, 0])
    r, rb = torch.hypot(pos[:, 0], pos[:, 1]), torch.hypot(posb[:, 0], posb[:, 1])
    return dict(scatterings=dns, scattered=(dns > 0).to(torch.float64), log_e_lab=log_e,
                log_e_lab_sq=(log_e - log_e_centre) ** 2, log_e_comoving=torch.log(c[:, 0]),
                mu=p[:, 3] / p[:, 0], dz=(pos[:, 2] - posb[:, 2]) / light, dr=(r - rb) / light,
                q=s[:, 1], u=s[:, 2], v=s[:, 3], pol2=s[:, 1] ** 2 + s[:, 2] ** 2)


def paired_z(a, b) -> float:
    """z of the mean of a - b over its standard error; inf where a value is
    not finite or the difference is constant and not 0."""
    d = a - b
    if not bool(torch.isfinite(d).all()):
        return math.inf
    n = d.numel()
    if n < 2:
        return 0.0
    mean, sd = float(d.mean()), float(d.std())
    if sd == 0.0:
        return 0.0 if mean == 0.0 else math.inf
    return abs(mean) / (sd / math.sqrt(n))


def stat_z(before: dict, prog: dict, ref: dict, dt_max: float) -> dict:
    """|z| of every statistic, paired photon by photon over the live
    photons; ``log_e_lab_sq`` is centred on the reference's mean."""
    keep = live(before)

    def sub(d):
        return {k: v[keep] for k, v in d.items()}

    before, prog, ref = sub(before), sub(prog), sub(ref)
    centre = float(torch.log(_f64(ref["p"][:, 0])).mean()) if bool(keep.any()) else 0.0
    fp, fr = (features(before, x, dt_max, centre) for x in (prog, ref))
    return {k: paired_z(fp[k], fr[k]) for k in FEATURES}


def compare(before: dict, prog: dict, ref: dict, prog_n_scatt: int, dt_max: float,
            holds) -> dict:
    """The compared numbers of one window (see the module's docstring), and
    under ``z`` each statistic's |z|.  ``before``, ``prog`` and ``ref`` map
    the photon fields, and the last two ``t_rem``, to tensors on one
    device."""
    z = stat_z(before, prog, ref, dt_max)
    n_scatt = int((_f64(prog["num_scatt"]) - _f64(before["num_scatt"]))[live(before)]
                  .sum().round())
    return dict(photons_off=int(guarantees(before, prog, dt_max, holds).sum()),
                stat_z_max=max(z.values()),
                scatter_count_off=abs(int(prog_n_scatt) - n_scatt), z=z)
