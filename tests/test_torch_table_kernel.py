"""The fused-round twin in TABLE mode (Chebyshev sigma_hat rows, K3) against
the JAX kernel, lane for lane.

``pallas_round.fused_rounds(..., cheb_base=..., interpret=True)`` and the
port's ``fused_rounds`` (the plain twin on CPU tensors) get the same float32
rows: the variant's table with the port's ``hot_xsec.thermal_cheb_cells``
rows appended (computed in float64 from JAX's float64 table, rounded once).
The frames are ``test_torch_geometry_cases.frame_case``'s thinned Gamma = 2
frames at T' = 5e8 K, where sigma_hat is measurably below Thomson, on
ultra_cyl2 (4 + 16 rows), packed_sph2 (16 + 16) and ultra_cart3 (5 + 16),
Stokes on and off.  Their electron-frame energies reach the band of fault F6,
so the port's repaired Klein-Nishina form is replaced by JAX's float32 form
(``monkeypatch``) and both accept the same scatterings.

Tolerances as test_torch_geometry_kernel_3d: NS and out-flags identical on
>= 99.9 % of live lanes; non-Stokes planes to rtol 1e-4 / atol 1e-6,
positions to 1e-4 of their norm; Stokes within 5e-3 on >= 99.5 %.
"""
import pytest
import torch

from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_geometry_cases import check_twin_against_jax_kernel, jax_f32_kn, xsec_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def xsec():
    return xsec_tables()


@pytest.mark.parametrize("stokes_on", [True, False], ids=["stokes", "nostokes"])
@pytest.mark.parametrize("variant", ["ultra_cyl2", "packed_sph2", "ultra_cart3"])
def test_table_twin_matches_jax_kernel_lane_for_lane(variant, stokes_on, xsec, monkeypatch):
    monkeypatch.setattr(fr, "_kn_cross_section", jax_f32_kn)
    three_d = variant == "ultra_cart3"
    check_twin_against_jax_kernel(
        variant, temp=5e8, stokes_on=stokes_on, xsec=xsec, inner_rounds=1 if three_d else 2,
        min_stalled=50, min_scatt=300)
