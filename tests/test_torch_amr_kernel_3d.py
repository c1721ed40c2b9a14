"""The fused-round twin with aux planes (K5, the carried AMR path's TABLE
mode) against the JAX kernel, lane for lane: the 3-D packed variants (one round per call, as test_torch_geometry_kernel_3d).

``pallas_round.fused_rounds(..., aux=..., nonthermal=..., interpret=True)``
and the port's ``fused_rounds`` (the plain twin on CPU tensors) get the same
float32 packed rows and the same aux planes (``transport.aux_planes`` of the
port: the biased total tau coefficient and the thermal probability at each
lane's comoving energy), with the variant and setup the port selects
for a ``BinnedIndex`` over the frame's cells.  The frames are
``test_torch_geometry_cases.frame_case``'s thinned Gamma = 2 frames at
T' = 5e8 K; AUX with thermal electrons, AUX_NT with bench.py's power law.
Both families stall a lane after it scatters as well as when it leaves its
cell.  The port's repaired Klein-Nishina form is replaced by JAX's float32
form (``monkeypatch``, fault F6).

Tolerances as test_torch_table_kernel (AUX) and test_torch_nonthermal_kernel
(AUX_NT): NS and out-flags identical on >= 99.9 % of live lanes; non-Stokes
planes to rtol 1e-4 / atol 1e-6 (AUX_NT: on >= 95 % of the agreeing lanes
and to rtol 0.1 on all: a nonthermal electron's boosts amplify ulps ~gamma^2
times), positions to 1e-4 of their norm; Stokes within 5e-3 on >= 99.5 %.
"""
import pytest
import torch

from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_geometry_cases import check_twin_against_jax_kernel, jax_f32_kn, xsec_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def xsec():
    """The power law's tables: the thermal table serves AUX as well."""
    return xsec_tables("powerlaw")


def check(variant, family, stokes_on, xsec, **kw):
    nt = family == "aux_nt"
    tf = check_twin_against_jax_kernel(
        variant, temp=5e8, stokes_on=stokes_on, xsec=xsec, dist="powerlaw" if nt else None,
        aux=True, min_stalled=50, min_scatt=300,
        **(dict(frac_close=0.95, rtol_all=0.1) if nt else {}), **kw)
    assert tf.any()


@pytest.mark.parametrize("family", ["aux", "aux_nt"])
@pytest.mark.parametrize("variant", ["packed_cart3", "packed_sph3", "packed_pol3"])
def test_aux_twin_matches_jax_kernel_lane_for_lane(variant, family, xsec, monkeypatch):
    monkeypatch.setattr(fr, "_kn_cross_section", jax_f32_kn)
    check(variant, family, True, xsec, inner_rounds=1)
