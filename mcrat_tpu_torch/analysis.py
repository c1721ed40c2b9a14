"""Observables from photon dumps: spectra, light curves, polarization (the
port's numpy copy of ``mcrat_tpu.analysis``).

The reference ends at per-frame photon dumps and leaves light curves,
spectra and polarization to the external ProcessMCRaT package (reference:
README.md:98, Doc/mcrat_doc.tex:37); these are the same reductions in-repo.
Every function takes a merged-frame dict of either dump format
(:func:`mcrat_tpu_torch.io.photons_h5.read_frame`) or raw arrays.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .constants import C_LIGHT, ERG_TO_KEV


def _detector_mask(data: Dict[str, np.ndarray], theta_min: float, theta_max: float):
    """Photons whose propagation direction points into [theta_min, theta_max]
    (radians from the jet axis) — the standard viewing-angle cut."""
    p = np.stack([data["P1"], data["P2"], data["P3"]], axis=-1)
    pn = np.linalg.norm(p, axis=-1)
    mu = p[:, 2] / np.maximum(pn, 1e-300)
    theta = np.arccos(np.clip(mu, -1, 1))
    return (theta >= theta_min) & (theta < theta_max) & (data["P0"] > 0) & (data["PW"] > 0)


def spectrum(
    data: Dict[str, np.ndarray],
    theta_min: float,
    theta_max: float,
    e_bins_kev: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted energy spectrum dN/dE for a viewing-angle band.

    Returns (bin_centers_keV, dN_dE, poisson_err).
    """
    m = _detector_mask(data, theta_min, theta_max)
    e_kev = data["P0"][m] * C_LIGHT * ERG_TO_KEV  # E = p0 c
    w = data["PW"][m]
    if e_bins_kev is None:
        e_bins_kev = np.geomspace(max(e_kev.min(), 1e-6), e_kev.max(), 60)
    hist, edges = np.histogram(e_kev, bins=e_bins_kev, weights=w)
    counts, _ = np.histogram(e_kev, bins=e_bins_kev)
    widths = np.diff(edges)
    centers = np.sqrt(edges[:-1] * edges[1:])
    dnde = hist / widths
    err = np.where(counts > 0, dnde / np.sqrt(np.maximum(counts, 1)), 0.0)
    return centers, dnde, err


def peak_energy_kev(data, theta_min, theta_max) -> float:
    """nu-F-nu peak energy of the band spectrum [keV]."""
    c, dnde, _ = spectrum(data, theta_min, theta_max)
    nufnu = dnde * c * c
    return float(c[np.argmax(nufnu)])


def polarization(
    data: Dict[str, np.ndarray], theta_min: float, theta_max: float
) -> Tuple[float, float, float]:
    """Weighted (Pi, Q/I, U/I) for a viewing-angle band.

    The net polarization degree Pi = sqrt(<Q>^2 + <U>^2) with weighted Stokes
    averages — the quantity compared against Lundman, Peer & Ryde (2014) in
    the reference's validation (Doc/mcrat_doc.tex:553-566).
    """
    m = _detector_mask(data, theta_min, theta_max)
    w = data["PW"][m]
    wsum = w.sum()
    if wsum <= 0:
        return 0.0, 0.0, 0.0
    q = float(np.sum(data["S1"][m] * w) / wsum)
    u = float(np.sum(data["S2"][m] * w) / wsum)
    return float(np.hypot(q, u)), q, u


def light_curve(
    frames: Dict[int, Dict[str, np.ndarray]],
    fps: float,
    theta_min: float,
    theta_max: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bolometric luminosity per frame for a viewing band.

    ``frames`` maps frame number -> merged data dict.  Uses the equal-arrival
    convention L_iso(t) ~ sum(w E)/dt per frame window (quick-look; full
    time-of-arrival binning lives in downstream analysis).
    """
    ts, ls = [], []
    for fr in sorted(frames):
        data = frames[fr]
        m = _detector_mask(data, theta_min, theta_max)
        e = np.sum(data["P0"][m] * C_LIGHT * data["PW"][m])
        ts.append(fr / fps)
        ls.append(e * fps)
    return np.asarray(ts), np.asarray(ls)


def light_curve_toa(
    data: Dict[str, np.ndarray],
    frame: int,
    fps: float,
    theta_min: float,
    theta_max: float,
    t_bins: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Time-of-arrival light curve from ONE late merged frame.

    Each photon's arrival time at a distant detector is its lab time minus its
    projected distance along its own propagation direction,

        t_obs = frame/fps - (r . p_hat) / c,

    the detector convention implied by the reference's output datasets
    (positions + four-momenta per frame, Doc/mcrat_doc.tex:362-384) and used by
    the downstream ProcessMCRaT light curves.  Luminosity per bin is
    sum(w E)/dt.  Returns (bin_centers_s, L_iso_erg_per_s).
    """
    m = _detector_mask(data, theta_min, theta_max)
    p = np.stack([data["P1"][m], data["P2"][m], data["P3"][m]], axis=-1)
    pos = np.stack([data["R0"][m], data["R1"][m], data["R2"][m]], axis=-1)
    pn = np.maximum(np.linalg.norm(p, axis=-1), 1e-300)
    proj = np.sum(pos * p, axis=-1) / pn
    t_obs = frame / fps - proj / C_LIGHT
    w_e = data["PW"][m] * data["P0"][m] * C_LIGHT  # photon energy E = p0 c [erg]
    if t_bins is None:
        lo, hi = t_obs.min(), t_obs.max()
        pad = max((hi - lo) * 1e-6, 1e-12)
        t_bins = np.linspace(lo, hi + pad, 51)
    hist, edges = np.histogram(t_obs, bins=t_bins, weights=w_e)
    widths = np.diff(edges)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, hist / widths


def scatterings_histogram(data, bins=50):
    """Distribution of per-photon scattering counts (weighted)."""
    ns = data["NS"]
    w = data["PW"]
    edges = np.arange(0, max(int(ns.max()) + 2, bins))
    hist, _ = np.histogram(ns, bins=edges, weights=w)
    return edges[:-1], hist
