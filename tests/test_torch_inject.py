"""Photon injection and packing of the port against mcrat_tpu.

With the same ``np.random.default_rng(seed)`` both packages draw the same
photons, on 2-D cylindrical and spherical frames and on 3-D cartesian,
spherical and polar ones: identical counts, cells, types and weights, float64 arrays within
rtol 1e-12; ``photons_from_arrays`` then packs identical float32 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import Config, Dims, Geometry, SimType, Spectrum
from mcrat_tpu.grid import frame_from_numpy as jframe
from mcrat_tpu.models import analytic as jan
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.config import Spectrum as TSpectrum
from mcrat_tpu_torch.grid import frame_from_numpy as tframe
from mcrat_tpu_torch.models import analytic as tan
from test_torch_geometry_cases import frame_case

torch.set_num_threads(1)


# 3-D frames of tests/test_torch_geometry_cases.py (Gamma = 2 outflows)
CASES_3D = dict(cartesian_3d="ultra_cart3", spherical_3d="packed_sph3", polar_3d="packed_pol3")


def _hosts(kind):
    if kind in CASES_3D:
        _, jhost, _, inj = frame_case(CASES_3D[kind])
        _, thost, _, _ = frame_case(CASES_3D[kind], port=True)
        return jhost, thost, inj
    if kind == "spherical":
        cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                     simulation_type=SimType.SPHERICAL_OUTFLOW)
        jhost, _ = jan.synthetic_spherical_frame(cfg, 5e12, 4e13, nr=48, ntheta=6,
                                                 theta_max=np.pi / 3)
        thost, _ = tan.synthetic_spherical_frame(convert.config_from_reference(cfg), 5e12, 4e13,
                                                 nr=48, ntheta=6, theta_max=np.pi / 3)
        return jhost, thost, dict(r_inj=1e13, theta_max=np.pi / 6)
    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW)
    grid = jan.make_grid_2d(cfg, np.linspace(0.0, 3.2e11, 33), np.linspace(1.8e12, 2.9e12, 65))
    jhost, thost = jframe(cfg, grid), tframe(convert.config_from_reference(cfg), grid)
    jan.apply_simulation_type(jhost)
    tan.apply_simulation_type(thost)
    return jhost, thost, dict(r_inj=2e12, theta_max=np.pi / 30)


@pytest.mark.parametrize("kind,spect,seed", [
    ("cylindrical", Spectrum.BLACKBODY, 7),
    ("cylindrical", Spectrum.WIEN, 8),
    ("spherical", Spectrum.BLACKBODY, 3),
    ("cartesian_3d", Spectrum.BLACKBODY, 4),
    ("spherical_3d", Spectrum.WIEN, 5),
    ("polar_3d", Spectrum.BLACKBODY, 6),
])
def test_inject_photons_identical_to_jax(kind, spect, seed):
    jhost, thost, kw = _hosts(kind)
    common = dict(ph_weight=1e50, min_photons=1500, max_photons=4000, spect=spect,
                  theta_min=0.0, fps=5.0, **kw)
    ja, jw = jt.inject_photons(jhost, rng=np.random.default_rng(seed), **common)
    ta, tw = tt.inject_photons(thost, rng=np.random.default_rng(seed),
                               **{**common, "spect": TSpectrum(spect.value)})
    assert tw == jw
    assert len(ta["weight"]) == len(ja["weight"]) > 0
    for k in ("cell", "ptype", "weight", "num_scatt"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    for k in ("p", "comv_p", "pos", "s"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-12, atol=0, err_msg=k)

    jph, jmeta = jt.photons_from_arrays(ja, capacity=len(ja["weight"]) + 100, dtype=jnp.float32)
    tph, tmeta = tt.photons_from_arrays(ta, capacity=len(ta["weight"]) + 100,
                                        device="cpu")
    assert tmeta == jmeta
    got = convert.photons_to_numpy(tph)
    for k, v in vars(jph).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tph.alive.numpy(), np.asarray(jph.alive))
    np.testing.assert_array_equal(tt.frame_time(tph, 0.05).numpy(),
                                  np.asarray(jt.frame_time(jph, jnp.float32(0.05))))


def test_photon_conversion_roundtrip():
    jhost, _, kw = _hosts("cylindrical")
    ja, _ = jt.inject_photons(jhost, ph_weight=1e50, min_photons=100, max_photons=400,
                              spect=Spectrum.BLACKBODY, theta_min=0.0, fps=5.0,
                              rng=np.random.default_rng(0), **kw)
    jph, _ = jt.photons_from_arrays(ja, capacity=None, dtype=jnp.float32)
    arrays = {k: np.asarray(v) for k, v in vars(jph).items()}
    back = convert.photons_to_numpy(convert.photons_from_numpy(arrays, device="cpu"))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
