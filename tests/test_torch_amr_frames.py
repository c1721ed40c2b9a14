"""Whole AMR frames through the port (CPU, plain twin) in distribution.

``transport.transport_frame`` on the small AMR frame of test_torch_amr_cases
(a ``BinnedIndex``: the carried path, 8-round chunks with compaction)
against the JAX package's XLA engine (``transport_frame(fused=False)``,
``transport_rounds`` over the same index) on the same photons: the two draw
different random numbers, so mean lab energy, mean scatterings and mean
Stokes Q of the live photons must agree within 4 sigma (the standard
errors of the two means).  DIRECT on the Gamma = 100 outflow (dt = 0.05 s,
as the flagship tests); TABLE (T' = 5e8 K) and bench.py's power law on the
same frame, through aux planes.  Weight is conserved exactly and every
photon finishes its window.

Then the port alone: the AMR frame against the same outflow on the
flagship's rectilinear grid (test_torch_transport_frame's 32 x 64 cut),
each with its own injection, within 4 sigma: the cell list changes the
lookup and the kernel's stalls, not the physics.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.grid import frame_from_numpy
from mcrat_tpu.models.analytic import apply_simulation_type, make_grid_2d
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_amr_cases import (
    CFG, amr_hosts, assert_within_4_sigma, inject, jax_index, numpy_photons, port_index,
    port_photons, stats, xsec_tables)
from test_torch_geometry_cases import table_cfg

torch.set_num_threads(1)


def _port_frame(tcfg, tph, tframe, tidx, xsec, seed=1):
    launches = fr.fused_rounds.launches
    res = tt.transport_frame(tcfg, tph, tframe, tidx, 0.05, torch.Generator().manual_seed(seed),
                             fused=True, chunk_rounds=8, s_rows=8, xsec_table=xsec)
    assert fr.fused_rounds.launches == launches  # CPU: the twin, never the kernel
    assert res.n_rounds > 8  # several chunks
    alive = res.photons.alive
    assert (res.t_rem[alive] <= 0).all()
    assert torch.equal(res.photons.weight, tph.weight)
    return res


@pytest.mark.parametrize("mode", ["direct", "table", "powerlaw"])
def test_amr_frame_matches_xla(mode, tmp_path):
    cfg = CFG if mode == "direct" else table_cfg(CFG, None if mode == "table" else mode)
    jhost, thost = amr_hosts(cfg, temp=None if mode == "direct" else 5e8)
    jtab = xsec = None
    if mode != "direct":
        jtab, xsec = xsec_tables(cfg, tmp_path)
    photons = inject(jhost, seed=11, capacity=4096)
    jidx = jax_index(jhost)
    res_x = jt.transport_frame(cfg, photons, jhost.to_device(dtype=jnp.float32), jidx,
                               jnp.float32(0.05), make_key(1), xsec_table=jtab, fused=False)
    tcfg = convert.config_from_reference(cfg)
    tph = port_photons(photons)
    res_t = _port_frame(tcfg, tph, thost.to_device("cpu"), port_index(jidx), xsec)
    a = stats(numpy_photons(res_x.photons), res_x.n_scatt)
    b = stats(numpy_photons(res_t.photons), res_t.n_scatt)
    assert b["w"] == pytest.approx(a["w"], rel=1e-6)
    assert b["ns"] > 0.5 and b["n"] == a["n"]
    assert_within_4_sigma(a, b)
    # the carried cells are the cells the photons are in
    cell = res_t.photons.cell[res_t.photons.alive]
    assert (cell >= 0).float().mean() > 0.9


def test_amr_frame_matches_rectilinear_frame():
    jhost, thost = amr_hosts()
    tcfg = convert.config_from_reference(CFG)
    edges = (np.linspace(0.0, 3.2e11, 33), np.linspace(1.8e12, 2.9e12, 65))
    rect = frame_from_numpy(CFG, make_grid_2d(CFG, *edges))
    apply_simulation_type(rect)
    out = []
    for host, index in ((jhost, port_index(jax_index(jhost))),
                        (rect, convert.index_from_edges(*edges, device="cpu"))):
        photons = inject(host, seed=13, capacity=4096)
        tph = port_photons(photons)
        tframe = convert.frame_from_numpy_fields(CFG, vars(host)).to_device("cpu")
        res = _port_frame(tcfg, tph, tframe, index, None)
        out.append(stats(numpy_photons(res.photons), res.n_scatt))
    amr, flagship = out
    assert amr["n"] > 1000 and flagship["n"] > 1000
    assert_within_4_sigma(amr, flagship)
