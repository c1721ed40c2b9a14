"""Fault F6, repaired in the port: the Klein-Nishina total cross section.

The float32 closed form of ``mcrat_tpu/ops/pallas_round.py::_kn_cross_section``
(and of ``ops/compton.py``) cancels catastrophically just above its
e = 1e-3 switch: its ~2/e^2 terms sum to ~1, and float32 loses up to 0.25
there.  The port evaluates the closed form in float64 and rounds once, in the
twin (``fused_round._kn_cross_section``) and the kernel alike.

* The port's float32 result is within 1e-6 of the float64 closed form on
  [1e-3, 1e3] (one float32 rounding is <= 6e-8 of sigma <= 1); JAX's float32
  form is more than 0.1 off on [1e-3, 3e-3), which pins the fault.
* A spherical frame at T' = 8e6 K, whose comoving photons sit at
  e ~ 3-5e-3, scatters through the port (twin, float32) as often per photon
  as through JAX's XLA engine in float64, within 4 sigma of the Monte Carlo
  error (the two draw different random numbers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import Config, Dims, Geometry, SimType, Spectrum
from mcrat_tpu.grid import build_rectilinear_index
from mcrat_tpu.models.analytic import synthetic_spherical_frame
from mcrat_tpu.ops import compton as jcompton
from mcrat_tpu.ops import pallas_round as pr
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import compton as tcompton
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)

E = np.geomspace(1e-3, 1e3, 100_001).astype(np.float32)


def _f64_reference(e):
    return np.asarray(jcompton.kn_cross_section(jnp.asarray(e, jnp.float64)))


def test_port_kn_cross_section_within_1e6_of_float64():
    got = fr._kn_cross_section(torch.from_numpy(E)).numpy()
    assert got.dtype == np.float32
    ref = _f64_reference(E)
    assert np.abs(got.astype(np.float64) - ref).max() < 1e-6
    # the port's float64 host function is the same closed form (float64 keeps
    # ~1e-10 of its cancellation at the switch: XLA's and numpy's log1p differ)
    np.testing.assert_allclose(tcompton.kn_cross_section(E), ref, rtol=0, atol=1e-9)
    # below the switch the reference's 1 - 2 e is kept as it is
    low = np.float32([1e-6, 1e-4, 9.99e-4])
    np.testing.assert_array_equal(fr._kn_cross_section(torch.from_numpy(low)).numpy(),
                                  np.float32(1.0) - np.float32(2.0) * low)


def test_jax_float32_kn_cross_section_carries_f6():
    band = E[E < 3e-3]
    jax32 = np.asarray(pr._kn_cross_section(jnp.asarray(band, jnp.float32)), np.float64)
    assert np.abs(jax32 - _f64_reference(band)).max() > 0.1


def test_f6_frame_scatterings_match_float64_engine():
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32")
    host, edges = synthetic_spherical_frame(cfg, r_min=5e12, r_max=4e13, nr=48, ntheta=6,
                                            theta_max=np.pi / 3)
    host.temp = np.full(host.num_elements, 8e6)  # theta = 1.35e-3, photons at e ~ 4e-3
    host.dens = host.dens * 30.0  # a few scatterings per photon
    host.dens_lab = host.dens_lab * 30.0
    arrays, _ = jt.inject_photons(host, r_inj=1e13, ph_weight=1e50, min_photons=3000,
                                  max_photons=6000, spect=Spectrum.BLACKBODY, theta_min=0.0,
                                  theta_max=np.pi / 6, fps=5.0, rng=np.random.default_rng(3))
    ph64, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jnp.float64)
    t_rem = jt.frame_time(ph64, jnp.float64(0.3))
    res = jt.transport_rounds(dataclass_f64(cfg), ph64, host.to_device(dtype=jnp.float64),
                              build_rectilinear_index(*edges, dtype="float64"), t_rem,
                              make_key(4), max_rounds=24)
    tph = convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(ph64).items()}, device="cpu")
    tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu")
    tidx = convert.index_from_edges(*edges, device="cpu")
    tcfg = convert.config_from_reference(cfg)
    tres = tt.transport_rounds_fused(
        tcfg, tph, tframe, tidx, torch.full((tph.capacity,), 0.3), base_seed=99,
        setup=tt.select_variant(tcfg, tframe, tidx), max_rounds=24, inner_rounds=2, s_rows=8)
    a = np.asarray(res.photons.num_scatt)[np.asarray(res.photons.alive)]
    b = tres.photons.num_scatt[tres.photons.alive].double().numpy()
    # comoving photons in the F6 band, and a few scatterings each
    e_comv = np.asarray(ph64.comv_p)[:, 0]
    assert np.median(e_comv) == pytest.approx(3.5e-3, rel=0.5)
    assert 1.0 < a.mean() < 20.0
    sigma = np.sqrt(a.var() / len(a) + b.var() / len(b))
    assert abs(a.mean() - b.mean()) < 4 * sigma, (a.mean(), b.mean(), sigma)


def dataclass_f64(cfg):
    import dataclasses

    return dataclasses.replace(cfg, dtype="float64")
