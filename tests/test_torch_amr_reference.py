"""The JAX package's carried AMR path against its own XLA engine.

A prerequisite check of the reference, in tests only (nothing in mcrat_tpu
changes): until now no test ran transport on a ``BinnedIndex`` frame.
``mcrat_tpu.transport.transport_rounds_fused(..., interpret=True)`` (the
carried protocol: cached-cell pin, index search, aux planes and
stall-on-scatter in TABLE mode) against ``transport_rounds`` (the XLA loop
over the same index) on the same photons, whole frames: mean lab energy,
mean scatterings and mean Stokes Q within 4 sigma.

DIRECT on the Gamma = 100 AMR outflow; TABLE (T' = 5e8 K) on it; and TABLE
on the ``gradient`` frame (Gamma 2 -> 10 along the jet axis, 1e-3 of the
density, free paths of a few cells), where a photon meets a new fluid
velocity in every cell it enters.  That case settles the stale comoving
energy of the aux planes: they are interpolated at the comoving energy of
the lane's last round, boosted into the cell it left, and hold for every
round of the call until the lane scatters or leaves; ``transport_rounds``
interpolates at the stored comoving energy too, stale for the first round
in a new cell only.  The two agree within 4 sigma, so no fault is recorded.
"""
import jax.numpy as jnp
import pytest

from mcrat_tpu import transport as jt
from mcrat_tpu.ops.rng import make_key

from test_torch_amr_cases import (
    CFG, amr_hosts, assert_within_4_sigma, inject, jax_index, numpy_photons, stats, xsec_tables)
from test_torch_geometry_cases import table_cfg


@pytest.mark.parametrize("case", ["direct", "table", "table_gradient"])
def test_jax_fused_carried_path_matches_transport_rounds(case, tmp_path):
    cfg = CFG if case == "direct" else table_cfg(CFG)
    if case == "table_gradient":
        jhost, _ = amr_hosts(cfg, temp=5e8, gradient=True, thin=1e-3)
        dt = 1.0
    else:
        jhost, _ = amr_hosts(cfg, temp=None if case == "direct" else 5e8)
        dt = 0.05
    tab = xsec_tables(cfg, tmp_path)[0] if case != "direct" else None
    photons = inject(jhost, seed=17, capacity=4096)
    jidx = jax_index(jhost)
    frame = jhost.to_device(dtype=jnp.float32)
    t_rem = jt.frame_time(photons, jnp.float32(dt))
    fused = jt.transport_rounds_fused(cfg, photons, frame, jidx, t_rem, make_key(2),
                                      xsec_table=tab, inner_rounds=4, s_rows=8, interpret=True)
    xla = jt.transport_rounds(cfg, photons, frame, jidx, t_rem, make_key(3), xsec_table=tab)
    assert bool(fused.all_done) and bool(xla.all_done)
    a = stats(numpy_photons(fused.photons), fused.n_scatt)
    b = stats(numpy_photons(xla.photons), xla.n_scatt)
    assert a["w"] == pytest.approx(b["w"], rel=1e-6)
    assert a["ns"] > 0.5
    assert_within_4_sigma(a, b)
