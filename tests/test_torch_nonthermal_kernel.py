"""The fused-round twin with nonthermal electrons (K4, TABLE mode) against
the JAX kernel, lane for lane.

``pallas_round.fused_rounds(..., cheb_base=16, nonthermal=True, nt_sub1=...)``
in interpret mode and the port's twin get the same float32 rows (the packed
table, nonthermal density from the equipartition B field, plus the port's
Chebyshev rows) and the same global subgroup-1 fit
(``hot_xsec._sub1_cheb_static``), on the thinned Gamma = 2 frames of
packed_cyl2 and packed_sph2 at T' = 5e8 K, for bench.py's power law and a
broken power law (gamma 1-1000, break at 10), Stokes on and off.  The
port's repaired Klein-Nishina form is replaced by JAX's float32 form
(``monkeypatch``, fault F6).

NS and out-flags must be identical on >= 99.9 % of live lanes (the
population draw, the subgroup slice and the inverse-CDF gamma included).  A
lane whose electron was nonthermal scattered off gamma up to 1e3, and the
boosts into and out of its rest frame amplify float32 ulps ~gamma^2 times
(XLA-CPU's exp/log differ from torch's by ulps): the non-Stokes planes agree
to rtol 1e-4 / atol 1e-6 on >= 95 % of the agreeing lanes and to rtol 0.1 on
all (measured: 97.6 % and 4.6e-2); positions to 1e-4 of their norm; Stokes
within 5e-3 on >= 99.5 %.
"""
import pytest
import torch

from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_geometry_cases import check_twin_against_jax_kernel, jax_f32_kn, xsec_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["powerlaw", "broken"])
def dist_xsec(request):
    return request.param, xsec_tables(request.param)


@pytest.mark.parametrize("stokes_on", [True, False], ids=["stokes", "nostokes"])
@pytest.mark.parametrize("variant", ["packed_cyl2", "packed_sph2"])
def test_nonthermal_twin_matches_jax_kernel_lane_for_lane(variant, stokes_on, dist_xsec,
                                                           monkeypatch):
    monkeypatch.setattr(fr, "_kn_cross_section", jax_f32_kn)
    dist, xsec = dist_xsec
    tf = check_twin_against_jax_kernel(
        variant, temp=5e8, stokes_on=stokes_on, xsec=xsec, dist=dist, min_stalled=50,
        min_scatt=300, frac_close=0.95, rtol_all=0.1)
    assert tf.any()
