"""The port's FLASH reader and decimation against mcrat_tpu's.

``io.flash.read_flash`` (h5py, imported inside it) and its vectorized core
``cells_from_blocks`` must give the JAX package's ``read_flash`` frame,
field for field (float64, to rtol 1e-15: the same numpy arithmetic), on an
HDF5 file of leaf and non-leaf blocks at two refinement levels, in
injection mode (cells beyond 0.95 r_inj) and in scattering mode (the band
around the photons, grown until it holds cells); ``io.decimate.
decimation_mask`` the JAX package's mask in 2-D and 3-D, injection and
scattering mode, with and without cyclo-synchrotron's wider start.
"""
import numpy as np
import pytest

from mcrat_tpu.config import Config, Dims, Geometry, HydroSim
from mcrat_tpu.io import decimate as jdec
from mcrat_tpu.io import flash as jflash
from mcrat_tpu_torch import convert
from mcrat_tpu_torch.io import decimate as tdec
from mcrat_tpu_torch.io import flash as tflash
from mcrat_tpu_torch.models import analytic as tan

FIELDS = ("r0", "r1", "r2", "dr0", "dr1", "dr2", "r", "theta", "v0", "v1", "v2", "dens",
          "dens_lab", "pres", "temp", "gamma", "domain")


@pytest.fixture
def flash_file(tmp_path):
    """Two refinement levels of 8x8-cell blocks over [0, 64] x [100, 164]
    (code units), and one parent block that is not a leaf."""
    import h5py

    rng = np.random.default_rng(2)
    coords, bsz = tan.amr_blocks_2d([(0.0, 32.0, 4, 8), (32.0, 64.0, 2, 4)], 100.0, 164.0)
    coords = np.concatenate([[[16.0, 132.0]], coords])
    bsz = np.concatenate([[[32.0, 64.0]], bsz])
    nblk = len(coords)
    node = np.ones((nblk, 1), np.int32)
    node[0] = 2
    path = tmp_path / "flash_hdf5_chk_0007"
    with h5py.File(path, "w") as f:
        f["coordinates"] = coords
        f["block size"] = bsz
        f["node type"] = node
        for name in ("velx", "vely"):
            f[name] = rng.uniform(-0.3, 0.3, (nblk, 64))
        f["dens"] = rng.uniform(1e-8, 1e-6, (nblk, 64))
        f["pres"] = rng.uniform(1e5, 1e7, (nblk, 64))
    return str(path), nblk


def _cfg(geometry=Geometry.CYLINDRICAL, dims=Dims.TWO, **kw):
    return Config(sim_switch=HydroSim.FLASH, dims=dims, geometry=geometry, hydro_l_scale=1e10,
                  hydro_d_scale=2.0, **kw)


def _assert_same_frame(thost, jhost):
    assert thost.num_elements == jhost.num_elements > 0
    for name in FIELDS:
        np.testing.assert_allclose(getattr(thost, name), np.asarray(getattr(jhost, name)),
                                   rtol=1e-15, atol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["injection", "scattering"])
def test_read_flash_matches_jax(flash_file, mode):
    path, nblk = flash_file
    cfg = _cfg()
    kw = (dict(fps=5.0, r_inj=1.5e12, ph_inj_switch=True) if mode == "injection" else
          dict(fps=5.0, r_inj=0.0, ph_inj_switch=False, min_r=1.2e12, max_r=1.3e12,
               min_theta=0.05, max_theta=0.2))
    jhost = jflash.read_flash(cfg, path, **kw)
    thost = tflash.read_flash(convert.config_from_reference(cfg), path, **kw)
    _assert_same_frame(thost, jhost)
    # decimation cut the frame: fewer cells than the leaf blocks hold
    assert thost.num_elements < (nblk - 1) * 64


def test_cells_from_blocks_without_decimation_matches_jax(flash_file):
    """Every leaf cell: JAX's read_flash in scattering mode with the whole
    sky keeps them all."""
    import h5py

    path, nblk = flash_file
    cfg = _cfg()
    jhost = jflash.read_flash(cfg, path, fps=5.0, r_inj=0.0, ph_inj_switch=False)
    with h5py.File(path, "r") as f:
        data = {k: np.asarray(f[k]) for k in f}
    thost = tflash.cells_from_blocks(
        convert.config_from_reference(cfg), data["coordinates"], data["block size"],
        {k: data[k] for k in tflash.FIELDS}, node_type=data["node type"])
    _assert_same_frame(thost, jhost)
    assert thost.num_elements == (nblk - 1) * 64
    # cell sizes: block / 8 in code units, times the length scale
    assert set(np.unique(thost.dr0)) == {1e10, 2e10}


@pytest.mark.parametrize("dims,geometry", [(Dims.TWO, Geometry.SPHERICAL),
                                           (Dims.TWO, Geometry.CYLINDRICAL),
                                           (Dims.THREE, Geometry.CARTESIAN)])
@pytest.mark.parametrize("cyclo", [False, True])
def test_decimation_mask_matches_jax(dims, geometry, cyclo):
    cfg = Config(dims=dims, geometry=geometry)
    tcfg = convert.config_from_reference(cfg)
    rs = np.random.default_rng(7)
    n = 5000
    if geometry is Geometry.SPHERICAL:
        r0, r1, r2 = rs.uniform(1e12, 1e13, n), rs.uniform(0.0, np.pi / 2, n), np.zeros(n)
        d0, d1, d2 = np.full(n, 5e10), np.full(n, 0.01), np.zeros(n)
    elif dims is Dims.THREE:  # the jet along z
        r0, r1, r2 = rs.uniform(-3e12, 3e12, n), rs.uniform(-3e12, 3e12, n), rs.uniform(
            1e12, 1e13, n)
        d0, d1, d2 = np.full(n, 2e10), np.full(n, 2e10), np.full(n, 4e10)
    else:
        r0, r1, r2 = rs.uniform(0.0, 3e12, n), rs.uniform(1e12, 1e13, n), np.zeros(n)
        d0, d1, d2 = np.full(n, 2e10), np.full(n, 4e10), np.zeros(n)
    cases = [dict(fps=10.0, r_inj=4e12, ph_inj_switch=True, min_r=0.0, max_r=np.inf,
                  min_theta=0.0, max_theta=np.pi),
             dict(fps=10.0, r_inj=0.0, ph_inj_switch=False, min_r=5e12, max_r=5.2e12,
                  min_theta=0.1, max_theta=0.3),
             # a band that holds no cell at first: the pad grows until it does
             dict(fps=0.2, r_inj=0.0, ph_inj_switch=False, min_r=3e13, max_r=3.1e13,
                  min_theta=0.0, max_theta=0.1)]
    for kw in cases:
        want = jdec.decimation_mask(cfg, r0, r1, r2, d0, d1, d2, cyclosynchrotron=cyclo, **kw)
        got = tdec.decimation_mask(tcfg, r0, r1, r2, d0, d1, d2, cyclosynchrotron=cyclo, **kw)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.any() and not got.all()
