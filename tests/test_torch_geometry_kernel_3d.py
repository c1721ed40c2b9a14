"""The fused-round twin's 3-D variants against the JAX kernel.

For each variant a Gamma = 2 frame at one uniform temperature is built by
mcrat_tpu (``test_torch_geometry_cases.frame_case``, density thinned so that
lanes both scatter and leave their cells), an injected population is laid
out in three logical blocks (one idle), and the port's ``fused_rounds``
(the plain twin on CPU tensors) is held lane for lane against
``pallas_round.fused_rounds(..., interpret=True)`` given JAX's own flags,
cell rows and domain vector.  Both draw the same counter stream, so:

* scatter count and out-flags are identical on >= 99.9 % of live lanes;
* on those lanes every non-Stokes plane agrees to rtol 1e-4 / atol 1e-6
  (XLA-CPU contracts FMAs and approximates sqrt/rsqrt; at Gamma = 2 the
  float32 conditioning keeps that within 1e-4, see test_torch_fused_round);
* Stokes q/u/v agree within 5e-3 on >= 99.5 % of them (rotation angles from
  cosines carry ~sqrt(eps) each);
* idle-block lanes are untouched and pool lanes stay put.

Every frame has a nonzero fluid velocity, so fault F1 (the JAX kernel's
Stokes chain where beta_f = 0) does not enter.  The 3-D spherical frame is
hot (5e8 K), so its electron-frame energies reach the band of fault F6: the
port's repaired Klein-Nishina form is replaced there by JAX's float32 form
(``monkeypatch``) so that both accept the same scatterings.
"""
import pytest
import torch

from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_geometry_cases import check_twin_against_jax_kernel, jax_f32_kn

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["ultra_cart3", "packed_cart3", "packed_sph3", "packed_pol3"])
def test_variant_twin_matches_jax_kernel_lane_for_lane(variant, monkeypatch):
    # one round per call: the 3-D fluid velocity is per cell, so a second
    # round adds no geometry; the 3-D spherical frame is hot (Maxwell-Juttner
    # electrons)
    monkeypatch.setattr(fr, "_kn_cross_section", jax_f32_kn)
    check_twin_against_jax_kernel(variant, temp=5e8 if variant == "packed_sph3" else 1e5,
                                  inner_rounds=1, min_stalled=50)
