"""The port's carried AMR glue against JAX's, lane for lane.

``transport.transport_rounds_fused`` on a ``BinnedIndex`` frame (the twin
on CPU tensors: cached-cell pin and index search before every call, the
active-first partition before every call, aux planes and stall-on-scatter
in TABLE mode) against ``mcrat_tpu.transport.transport_rounds_fused(...,
interpret=True)`` on the same photons, frame and index, as
test_torch_fused_round's flagship glue test holds the direct branch: both
draw the same counter stream, so the scatter counts of >= 99.9 % of the
photons, their cells, types and weights are identical, positions agree to
1e-4 of their norm and the mean energies to 1e-3.

DIRECT on the small AMR cut of the flagship outflow (Gamma = 100); TABLE
(T' = 5e8 K, thermal, and bench.py's power law) on the same cut at
Gamma = 2 and 1e-3 of the density, where free paths are a sizeable
fraction of a cell and lanes both scatter and change cells within a call.
Every 5th photon is a CS pool photon.  On the hot frames JAX's float32
Klein-Nishina form stands in for the port's repaired one (fault F6,
``monkeypatch``).  The aux planes are interpolated by each package
(``hot_xsec.interp_thermal``: equal to 1e-9, test_torch_hot_xsec).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import PhotonType
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_amr_cases import (
    CFG, amr_hosts, inject, jax_index, numpy_photons, port_index, port_photons, torch_t,
    xsec_tables)
from test_torch_geometry_cases import jax_f32_fano, jax_f32_kn, table_cfg

torch.set_num_threads(1)

S_ROWS = 8


@pytest.mark.parametrize("mode", ["direct", "table", "powerlaw"])
def test_carried_glue_matches_jax_fused_transport(mode, tmp_path, monkeypatch):
    cfg = CFG if mode == "direct" else table_cfg(CFG, None if mode == "table" else mode)
    monkeypatch.setattr(fr, "_fano_normalized", jax_f32_fano)
    if mode == "direct":
        jhost, thost = amr_hosts(cfg)
        jtab = xsec = None
    else:
        monkeypatch.setattr(fr, "_kn_cross_section", jax_f32_kn)
        jhost, thost = amr_hosts(cfg, gamma=2.0, temp=5e8, thin=1e-3)
        jtab, xsec = xsec_tables(cfg, tmp_path)
    photons = inject(jhost, seed=7)
    ptype = np.asarray(photons.ptype).copy()
    ptype[::5] = int(PhotonType.CS_POOL)
    photons = photons.replace(ptype=jnp.asarray(ptype))
    jidx = jax_index(jhost)
    jframe = jhost.to_device(dtype=jnp.float32)
    dt = 0.05 if mode == "direct" else 1.0
    t_rem = jt.frame_time(photons, jnp.float32(dt))
    key = make_key(1)
    res = jt.transport_rounds_fused(cfg, photons, jframe, jidx, t_rem, key, xsec_table=jtab,
                                    max_rounds=8, inner_rounds=2, s_rows=S_ROWS, interpret=True)
    base_seed = int(jax.random.randint(key, (), jnp.iinfo(jnp.int32).min,
                                       jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    tcfg = convert.config_from_reference(cfg)
    tframe, tidx = thost.to_device("cpu"), port_index(jidx)
    setup = tt.select_variant(tcfg, tframe, tidx, xsec)
    assert setup.variant == "packed_cyl2" and setup.aux is xsec
    launches = (fr.fused_rounds.launches, fr.fused_rounds_reference.launches)
    tres = tt.transport_rounds_fused(tcfg, port_photons(photons), tframe, tidx, torch_t(t_rem),
                                     base_seed=base_seed, setup=setup, max_rounds=8,
                                     inner_rounds=2, s_rows=S_ROWS)
    # CPU tensors: the twin, never the kernel, once per call of 2 rounds
    assert fr.fused_rounds.launches == launches[0]
    assert fr.fused_rounds_reference.launches == launches[1] + 4
    a, b = numpy_photons(res.photons), numpy_photons(tres.photons)
    assert tres.n_rounds == int(res.n_rounds) == 8
    n = len(a["weight"])
    same = a["num_scatt"] == b["num_scatt"]
    assert same.sum() >= 0.999 * n, n - same.sum()
    assert (a["cell"] == b["cell"]).sum() >= 0.999 * n
    np.testing.assert_array_equal(a["cell"][same], b["cell"][same])
    assert (b["cell"] >= 0).sum() > 0.9 * n
    for k in ("ptype", "weight"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (b["ptype"] == int(PhotonType.COMPTONIZED)).any()  # pool promotion ran
    assert int(tres.n_scatt) == pytest.approx(int(res.n_scatt), rel=1e-3)
    assert int(tres.n_scatt) > 500
    dpos = np.linalg.norm(a["pos"] - b["pos"], axis=1)
    assert (dpos[same] <= 1e-4 * np.linalg.norm(a["pos"], axis=1)[same]).all()
    for k in ("p", "comv_p"):
        assert b[k][same, 0].mean() == pytest.approx(a[k][same, 0].mean(), rel=1e-3)
    for col in (1, 2):
        assert abs(b["s"][:, col].mean() - a["s"][:, col].mean()) < 0.01
    np.testing.assert_array_equal(tres.t_rem.numpy() > 0, np.asarray(res.t_rem) > 0)
