"""AMR cell-list frames for the port's tests (a helper module: no tests).

The frame is a small cut of the ``amr_cyl2`` main path: the flagship's 2-D
cylindrical outflow domain (r0 in [0, 3.2e11], r1 in [1.8e12, 2.9e12])
tiled by FLASH leaf blocks of 8 x 8 cells on three refinement levels,
5,376 cells in all.  The port builds the cell list with
``io.flash.cells_from_blocks`` (held against JAX's ``read_flash`` in
test_torch_amr_flash); JAX gets the same cell arrays through its own
``frame_from_numpy``, and each package applies its own outflow model.  Both
index the list with a ``BinnedIndex`` (identical arrays,
test_torch_amr_index).

``gradient`` replaces the uniform flow by one whose Lorentz factor grows
along the jet axis, 2 -> 10 over the domain: photons then meet a new fluid
velocity in every cell they enter.
"""
import jax.numpy as jnp
import numpy as np
import torch

from mcrat_tpu import grid as jgrid
from mcrat_tpu import transport as jt
from mcrat_tpu.config import Config, Dims, Geometry, SimType, Spectrum
from mcrat_tpu.models import analytic as jan
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch.io import flash as tflash
from mcrat_tpu_torch.models import analytic as tan
from mcrat_tpu_torch.ops import cyclosynch as tcs

# three refinement levels, coarser outward: (r0_lo, r0_hi, blocks along r0, along r1)
BANDS = [(0.0, 1.28e11, 4, 16), (1.28e11, 2.56e11, 2, 8), (2.56e11, 3.2e11, 1, 4)]
R1 = (1.8e12, 2.9e12)
CFG = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
INJ = dict(r_inj=2e12, theta_max=np.pi / 30)


def block_fields(nblk):
    return dict(velx=np.zeros((nblk, 64)), vely=np.zeros((nblk, 64)),
                dens=np.ones((nblk, 64)), pres=np.ones((nblk, 64)))


def _set_gradient(host):
    """Gamma 2 -> 10 along the jet axis (r1), flow parallel to it."""
    frac = (host.r1 - R1[0]) / (R1[1] - R1[0])
    host.gamma = 2.0 + 8.0 * frac
    host.v0 = np.zeros(host.num_elements)
    host.v1 = np.sqrt(1.0 - host.gamma ** -2)
    host.dens_lab = host.dens * host.gamma


def amr_hosts(cfg=CFG, gamma=100.0, temp=None, gradient=False, thin=1.0):
    """(JAX host, port host) of the small AMR outflow: Lorentz factor
    ``gamma`` (or the ``gradient`` flow), T' = ``temp`` (default the
    model's 1e5 K), densities scaled by ``thin``; with a nonthermal ``cfg``
    the nonthermal density from the equipartition B field (bench.py:292)."""
    tcfg = convert.config_from_reference(cfg)
    coords, bsz = tan.amr_blocks_2d(BANDS, *R1)
    thost = tflash.cells_from_blocks(tcfg, coords, bsz, block_fields(len(coords)))
    jhost = jgrid.frame_from_numpy(cfg, {k: getattr(thost, k) for k in (
        "r0", "r1", "dr0", "dr1", "v0", "v1", "dens", "pres")})
    for host, an in ((jhost, jan), (thost, tan)):
        an.cylindrical_prep(host, gamma_infinity=gamma)
        if gradient:
            _set_gradient(host)
        if temp is not None:
            host.temp = np.full(host.num_elements, float(temp))
        host.dens = host.dens * thin
        host.dens_lab = host.dens_lab * thin
    if cfg.nonthermal_e_dist.value != "off":
        thost.nonthermal_dens = tcs.nonthermal_electron_dens(tcfg, thost)
        jhost.nonthermal_dens = thost.nonthermal_dens.copy()
    return jhost, thost


def jax_index(jhost):
    return jgrid.build_binned_index(jhost)


def port_index(jidx):
    """The port's BinnedIndex from JAX's arrays (the port builds the same,
    test_torch_amr_index)."""
    return convert.binned_index_from_numpy(
        np.asarray(jidx.cell_ids), np.asarray(jidx.bin_start), np.asarray(jidx.bin_count),
        np.asarray(jidx.grid_min), np.asarray(jidx.inv_bin), jidx.dims, jidx.max_slab,
        device="cpu")


def inject(jhost, seed, n_min=1500, n_max=4000, capacity=None):
    """JAX photons (float32) injected into ``jhost``."""
    arrays, _ = jt.inject_photons(jhost, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
                                  spect=Spectrum.BLACKBODY, theta_min=0.0, fps=5.0,
                                  rng=np.random.default_rng(seed), **INJ)
    photons, _ = jt.photons_from_arrays(arrays, capacity=capacity, dtype=jnp.float32)
    return photons


def port_photons(photons):
    return convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()},
                                      device="cpu")


def xsec_tables(cfg, tmp_dir):
    """(JAX float32 table, the port's table) of a TABLE ``cfg``: JAX builds
    and caches the float64 arrays (as bench.py loads them, float32 on the
    device); the port gets the float64 arrays."""
    path = str(tmp_dir / "xsec.npz")
    tab64 = jhx.load_or_build(cfg, path, dtype="float64")
    tab32 = jhx.load_or_build(cfg, path, dtype="float32")
    frac = None if tab64.subgroup_frac is None else np.asarray(tab64.subgroup_frac)
    nt = None if tab64.nonthermal is None else np.asarray(tab64.nonthermal)
    return tab32, convert.xsec_table_from_numpy(tab64.log_e, tab64.log_t, tab64.thermal, nt,
                                                frac)


def stats(d, n_scatt=0):
    """Weight, mean lab energy, mean scatterings, mean Stokes Q and their
    standard errors over the live photons of a dict of numpy arrays."""
    alive = (d["weight"] > 0) & (d["ptype"] != 5)
    e = d["p"][alive, 0].astype(np.float64)
    ns = d["num_scatt"][alive].astype(np.float64)
    q = d["s"][alive, 1].astype(np.float64)
    n = alive.sum()
    return dict(w=float(d["weight"].sum()), n=int(n), n_scatt=int(n_scatt),
                e=e.mean(), se_e=e.std() / np.sqrt(n), ns=ns.mean(), se_ns=ns.std() / np.sqrt(n),
                q=q.mean(), se_q=q.std() / np.sqrt(n))


def assert_within_4_sigma(a, b, keys=("e", "ns", "q")):
    """Means of two independent runs agree within 4 sigma (1/sqrt(N))."""
    for k in keys:
        sigma = np.hypot(a["se_" + k], b["se_" + k])
        assert abs(a[k] - b[k]) <= 4.0 * sigma + 1e-12, (k, a[k], b[k], sigma)


def numpy_photons(ph):
    if isinstance(ph, jt.Photons):
        return {k: np.asarray(v) for k, v in vars(ph).items()}
    return convert.photons_to_numpy(ph)


def torch_t(t_rem):
    return torch.from_numpy(np.array(t_rem))
