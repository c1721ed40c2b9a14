"""The port's aux planes (the carried AMR path's TABLE mode) against the JAX
glue's.

``transport.aux_planes`` against the formula of ``aux_planes`` in
mcrat_tpu/transport.py:811-849 (a closure of ``transport_rounds_fused``,
evaluated here with the JAX package's own ``hot_xsec.interp_thermal`` and
``interp_nonthermal`` and its packed frame): the biased total tau
coefficient tau0 + N_GAMMA tau_norm (tau0 = n_e sigma_T sigma_hat, tau_norm
= tau0 in thermal cells, else subgroup 1's tau) and the thermal probability
tau0 / total, per lane, at the lane's comoving energy in the lane's cell.
In float64, to the rtol 1e-9 that test_torch_hot_xsec holds
``interp_thermal`` to, on the small AMR frame with cell temperatures spread
over 1e5-5e9 K, every fifth cell free of thermal electrons, comoving
energies over 1e-4-30 (past the table's edge, where both recompute the
integral) and a thermal, a power-law and a broken power-law population.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu.constants import M_P, THOM_X_SECT
from mcrat_tpu.grid import PCOL
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt

from test_torch_amr_cases import CFG, amr_hosts
from test_torch_geometry_cases import table_cfg

torch.set_num_threads(1)


def _jax_aux(cfg, tab, frame, cell, e):
    """mcrat_tpu/transport.py:821-849 on the packed rows of ``cell``."""
    rows = frame.packed[:, cell]
    tiny = jnp.finfo(jnp.float32).tiny
    sig = jhx.interp_thermal(tab, e, rows[PCOL["temp"]])
    tau0 = rows[PCOL["dens_lab"]] * (1.0 / M_P) * THOM_X_SECT * sig
    if tab.nonthermal is None:
        return np.stack([np.asarray(tau0), np.ones(len(e))])
    sig_sub = jhx.interp_nonthermal(tab, e)
    n_nt_lab = rows[PCOL["nonthermal_dens"]] * rows[PCOL["gamma"]]
    tau_i = n_nt_lab[:, None] * tab.subgroup_frac[None, :] * THOM_X_SECT * sig_sub
    tau_norm = jnp.where(tau0 > 0, tau0, tau_i[:, 0])
    total = tau0 + cfg.n_gamma * tau_norm
    return np.stack([np.asarray(total), np.asarray(tau0 / jnp.maximum(total, tiny))])


@pytest.mark.parametrize("dist", [None, "powerlaw", "broken"])
def test_aux_planes_match_jax(dist, tmp_path):
    cfg = table_cfg(CFG, dist)
    jhost, thost = amr_hosts(cfg, gamma=2.0)
    n_cell = thost.num_elements
    frac = (np.arange(n_cell) * 0.6180339887) % 1.0
    empty = np.arange(n_cell) % 5 == 0
    for host in (jhost, thost):
        host.temp = 10.0 ** (5.0 + frac * np.log10(5e4))
        if dist:
            host.dens_lab = np.where(empty, 0.0, host.dens_lab)
    path = str(tmp_path / "xsec.npz")
    tab = jhx.load_or_build(cfg, path, dtype="float64")
    nt = None if tab.nonthermal is None else np.asarray(tab.nonthermal)
    sub = None if tab.subgroup_frac is None else np.asarray(tab.subgroup_frac)
    xsec = convert.xsec_table_from_numpy(tab.log_e, tab.log_t, tab.thermal, nt, sub)
    rs = np.random.default_rng(9)
    n = 4000
    cell = rs.integers(0, n_cell, n)
    e = 10.0 ** rs.uniform(-4.0, 1.5, n)
    want = _jax_aux(cfg, tab, jhost.to_device(dtype=jnp.float64), jnp.asarray(cell),
                    jnp.asarray(e))
    got = tt.aux_planes(convert.config_from_reference(cfg), xsec,
                        thost.to_device("cpu", dtype=torch.float64),
                        torch.from_numpy(cell.astype(np.int32)), torch.from_numpy(e))
    assert got.shape == (2, n) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)
    if dist:
        # thermal-free cells fall back to subgroup 1: p_th = 0, total > 0
        on_empty = empty[cell]
        assert (got[1].numpy()[on_empty] == 0).all() and (got[0].numpy()[on_empty] > 0).all()
        assert (got[1].numpy()[~on_empty] < 1).all()
    else:
        assert (got[1] == 1).all()
