"""A dry run of the sharded frame (port of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` builds an ``n``-shard mesh in this process, shards a
16k-40k photon population of the 2-D spherical outflow over it and runs the
chunked sharded frame through the fused-round kernel (its plain twin on the
CPU) twice, with small logical blocks and at the main path's shape, with
compaction; checks: weight conserved, photons scattered, and the mean
energy and the spectrum's terciles against the XLA engine's frame of the
same population on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import transport as tr
from ..config import Config, Dims, Geometry, SimType, Spectrum
from ..device import resolve_device
from ..grid import build_rectilinear_index
from ..models.analytic import synthetic_spherical_frame
from ..ops.prng import Key
from .mesh import fetch_global, make_mesh, pad_capacity, sharded_transport_frame


def _problem(device, nr=48, ntheta=6, n_min=16384, n_max=40000):
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW)
    host, (r_edges, t_edges) = synthetic_spherical_frame(
        cfg, r_min=5e12, r_max=4e13, nr=nr, ntheta=ntheta, theta_max=np.pi / 3)
    idx = build_rectilinear_index(r_edges, t_edges, device=device)
    arrays, _ = tr.inject_photons(
        host, r_inj=1e13, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6, fps=5.0,
        rng=np.random.default_rng(0))
    return cfg, host.to_device(device), idx, arrays


def _spectrum(ph: tr.Photons):
    alive = ph.alive.numpy()
    return ph.p[:, 0].numpy()[alive].astype(np.float64), ph.weight.numpy()[alive]


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the sharded frame on an ``n_devices``-shard mesh of ``device``
    (default: the card; shard ``i`` on card ``i`` modulo the cards, so one
    card may hold several shards; ``"cpu"``: every shard on the CPU, the
    kernel's plain twin), and check it (RuntimeError when a check fails).
    Returns the run's numbers."""
    device = resolve_device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    mesh = make_mesh(devices=devices)
    cfg, frame, idx, arrays = _problem(device)
    cap = pad_capacity(len(arrays["weight"]), n_devices, factor=1.25)
    photons, _ = tr.photons_from_arrays(arrays, capacity=cap, device=device)
    w_in = float(photons.weight.double().sum())

    # the XLA engine on one device, the same population
    ref = tr.transport_frame(cfg, photons, frame, idx, 0.3, fused=False, key=Key.from_seed(1))
    e_x, w_x = _spectrum(fetch_global(ref.photons))
    m_x = float((e_x * w_x).sum() / w_x.sum())
    edges = np.quantile(np.log(e_x), [1.0 / 3.0, 2.0 / 3.0])

    def fractions(e, w):
        b = np.digitize(np.log(e), edges)
        return np.array([w[b == i].sum() for i in range(3)]) / w.sum()

    f_x = fractions(e_x, w_x)
    out = dict(n_devices=n_devices, n_photons=len(arrays["weight"]), xla_mean_energy=m_x,
               xla_terciles=f_x.tolist())
    # small logical blocks (8 rows), then the main path's (128 rows)
    for tag, s_rows, seed in (("small_blocks", 8, 0), ("main_shape", 128, 2)):
        mesh.launches.clear()
        res = sharded_transport_frame(cfg, mesh, photons, frame, idx, 0.3,
                                      torch.Generator().manual_seed(seed), chunk_rounds=4,
                                      fused=True, s_rows=s_rows)
        got = fetch_global(res.photons)
        w_out = float(got.weight.double().sum())
        _check(abs(w_out - w_in) <= 1e-6 * max(w_in, 1.0), (tag, "weight", w_out, w_in))
        _check(res.n_scatt > 0 and res.n_rounds > 4, (tag, res.n_scatt, res.n_rounds))
        e_f, w_f = _spectrum(got)
        m_f = float((e_f * w_f).sum() / w_f.sum())
        f_f = fractions(e_f, w_f)
        # mean comoving-boosted lab energy within 8 %, spectrum terciles
        # within 3 percentage points (the JAX dry run's limits)
        _check(abs(m_f - m_x) <= 0.08 * abs(m_x), (tag, "mean energy", m_f, m_x))
        _check(np.abs(f_f - f_x).max() <= 0.03, (tag, "terciles", f_f, f_x))
        if device.type == "cuda":
            _check(all(mesh.launches[i] > 0 for i in range(n_devices)),
                   (tag, "launches by shard", mesh.launches))
        out[tag] = dict(n_scatt=res.n_scatt, n_rounds=res.n_rounds, mean_energy=m_f,
                        terciles=f_f.tolist(), engine=res.engine,
                        launches=[mesh.launches[i] for i in range(n_devices)])
    return out
