"""The port's BinnedIndex, its search and the carried-cell lookup against
mcrat_tpu's, exactly.

``grid.build_binned_index`` (numpy counting sort) must give the JAX
package's ``cell_ids``, ``bin_start``, ``bin_count``, ``dims``,
``max_slab``, ``grid_min`` and ``inv_bin``; ``BinnedIndex.find`` (torch, in
lane chunks) and ``find_cell_rows`` (cached-cell pin, then the search of
the lanes that left) the JAX package's cell indices, on random points and
on points placed on cell and block seams and level boundaries, where the
AABB test (``in_block``, ``<=``) holds for two cells and the neighbour
order and first hit decide.  Three cell lists: the small AMR frame of
test_torch_amr_cases (three levels of FLASH blocks), a 2-D spherical grid
and a 3-D cartesian grid taken as unstructured lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import grid as jgrid
from mcrat_tpu.config import Config, Dims, Geometry, SimType
from mcrat_tpu.io import hydro as jhydro
from mcrat_tpu.models import analytic as jan
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import geometry as tgeo
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch.io import hydro as thydro

from test_torch_amr_cases import CFG, amr_hosts
from test_torch_geometry_cases import make_grid_3d

torch.set_num_threads(1)

KINDS = ["amr_cyl2", "sph2_cells", "cart3_cells"]


def _hosts(kind):
    """(cfg, JAX host, port host, per-axis seam coordinates)."""
    if kind == "amr_cyl2":
        jhost, thost = amr_hosts()
        seams = (np.arange(0, 41) * 8e9, 1.8e12 + np.arange(0, 65) * (1.1e12 / 64), [0.0])
        return CFG, jhost, thost, seams
    if kind == "sph2_cells":
        cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                     simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32")
        jhost, edges = jan.synthetic_spherical_frame(cfg, 5e11, 4e12, nr=48, ntheta=6,
                                                     theta_max=np.pi / 3)
        seams = (edges[0], edges[1], [0.0])
    else:
        cfg = Config(dims=Dims.THREE, geometry=Geometry.CARTESIAN,
                     simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
        edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 17),
                 np.geomspace(1.8e12, 2.9e12, 33))
        jhost = jgrid.frame_from_numpy(cfg, make_grid_3d(*edges))
        jan.apply_simulation_type(jhost)
        seams = edges
    return cfg, jhost, convert.frame_from_numpy_fields(cfg, vars(jhost)), seams


def _points(jhost, seams, n=6000, seed=3):
    """float32 hydro coordinates: uniform over the domain padded by 5 %, and
    a third with one coordinate on a seam."""
    rs = np.random.default_rng(seed)
    cols = []
    for lo, hi in np.asarray(jhost.domain):
        pad = 0.05 * (hi - lo)
        cols.append(rs.uniform(lo - pad, hi + pad, n))
    three_d = jhost.cfg.dims is Dims.THREE
    for axis in range(3 if three_d else 2):
        sl = slice(axis * n // 6, (axis + 1) * n // 6)
        cols[axis][sl] = rs.choice(np.asarray(seams[axis]), sl.stop - sl.start)
    if not three_d:
        cols[2][:] = 0.0
    return [c.astype(np.float32) for c in cols]


@pytest.mark.parametrize("kind", KINDS)
def test_build_binned_index_identical_to_jax(kind):
    cfg, jhost, thost, _ = _hosts(kind)
    jidx = jgrid.build_binned_index(jhost)
    tidx = tgrid.build_binned_index(thost, device="cpu")
    for name in ("cell_ids", "bin_start", "bin_count", "grid_min", "inv_bin"):
        np.testing.assert_array_equal(getattr(tidx, name).numpy(), np.asarray(getattr(jidx, name)),
                                      err_msg=name)
    assert tidx.dims == jidx.dims and tidx.max_slab == jidx.max_slab
    assert tidx.cell_ids.dtype == torch.int32 and tidx.grid_min.dtype == torch.float32
    assert tidx.max_slab > 1 and np.prod(tidx.dims) > 16
    # the same index through the numpy bridge
    conv = convert.binned_index_from_numpy(jidx.cell_ids, jidx.bin_start, jidx.bin_count,
                                           jidx.grid_min, jidx.inv_bin, jidx.dims,
                                           jidx.max_slab, device="cpu")
    for name in ("cell_ids", "bin_start", "bin_count", "grid_min", "inv_bin"):
        assert torch.equal(getattr(conv, name), getattr(tidx, name)), name


@pytest.mark.parametrize("kind", KINDS)
def test_find_identical_to_jax(kind, monkeypatch):
    cfg, jhost, thost, seams = _hosts(kind)
    jidx = jgrid.build_binned_index(jhost)
    tidx = tgrid.build_binned_index(thost, device="cpu")
    r0, r1, r2 = _points(jhost, seams)
    want = np.asarray(jidx.find(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(r2),
                                jhost.to_device(dtype=jnp.float32), None))
    tframe = thost.to_device("cpu")
    args = [torch.from_numpy(a) for a in (r0, r1, r2)]
    got = tidx.find(*args, tframe).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).mean() > 0.5 and (got < 0).any()
    # in lane chunks of 1024 (a budget of 1024 lanes' slabs): the same cells
    monkeypatch.setattr(tgrid, "SEARCH_BUDGET_BYTES",
                        1024 * tgrid._SEARCH_BYTES_PER_CANDIDATE * tidx.max_slab)
    np.testing.assert_array_equal(tidx.find(*args, tframe).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_find_special_lanes_identical_to_jax(kind):
    """Lanes with one coordinate at NaN, +-inf or +-1e30 (the others inside
    the domain) and lanes on the index's outer bin edges and one bin beyond:
    the port's plain search (the CUDA kernel's yardstick) gives JAX's cells,
    and NaN and inf lanes find none."""
    cfg, jhost, thost, _ = _hosts(kind)
    jidx = jgrid.build_binned_index(jhost)
    tidx = tgrid.build_binned_index(thost, device="cpu")
    rs = np.random.default_rng(11)
    axes = 3 if cfg.dims is Dims.THREE else 2
    n = 1200
    cols = []
    for axis in range(3):
        lo, hi = np.asarray(jhost.domain)[axis]
        col = rs.uniform(lo, hi, n)
        width = 1.0 / float(tidx.inv_bin[axis])
        edges = float(tidx.grid_min[axis]) + width * np.arange(-1, tidx.dims[axis] + 2)
        col[n // 2:] = rs.choice(edges, n - n // 2)
        if axis < axes:
            sl = slice(axis * n // 6, (axis + 1) * n // 6)
            col[sl] = rs.choice([np.nan, np.inf, -np.inf, 1e30, -1e30], sl.stop - sl.start)
        cols.append(col.astype(np.float32) if axis < axes else np.zeros(n, np.float32))
    want = np.asarray(jidx.find(*(jnp.asarray(c) for c in cols),
                                jhost.to_device(dtype=jnp.float32), None))
    got = tidx.find(*(torch.from_numpy(c) for c in cols), thost.to_device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    bad = np.zeros(n, bool)
    for c in cols[:axes]:
        bad |= ~np.isfinite(c)
    assert bad.sum() > n // 10 and (got[bad] == -1).all()
    assert (got >= 0).sum() > n // 4


@pytest.mark.parametrize("kind", ["amr_cyl2", "cart3_cells"])
def test_find_cell_rows_identical_to_jax(kind):
    """Cached cells right, wrong and unknown (-1): the pin keeps the right
    ones, the search finds the rest; JAX's carried rows equal the packed
    rows of the cell on every in-grid lane (so the port carries the cell
    alone)."""
    cfg, jhost, thost, seams = _hosts(kind)
    tcfg = convert.config_from_reference(cfg)
    jidx = jgrid.build_binned_index(jhost)
    tidx = tgrid.build_binned_index(thost, device="cpu")
    jframe, tframe = jhost.to_device(dtype=jnp.float32), thost.to_device("cpu")
    h = _points(jhost, seams, seed=4)
    rs = np.random.default_rng(5)
    phi = rs.uniform(0.0, 2 * np.pi, len(h[0]))
    pos = np.stack(tgeo.hydro_to_mcrat(tcfg, *(h[:2] + [h[2] if kind == "cart3_cells" else phi])),
                   axis=1).astype(np.float32)
    right = tidx.find(*[torch.from_numpy(a) for a in h], tframe).numpy()
    cached = np.where(rs.random(len(right)) < 0.5, right,
                      rs.integers(-1, thost.num_elements, len(right))).astype(np.int32)
    jcell, jrow, jin = jgrid.find_cell_rows(cfg, jidx, jframe, jnp.asarray(pos),
                                            jnp.asarray(cached),
                                            jgrid.gather_rows(jframe, jnp.asarray(cached)))
    tcell, tin = tgrid.find_cell_rows(tcfg, tidx, tframe, torch.from_numpy(pos),
                                      torch.from_numpy(cached))
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert tcell.dtype == torch.int32 and tin.any() and (~tin).any()
    ing = np.asarray(jin)
    packed = tgrid.gather_rows(tframe, tcell).numpy()
    np.testing.assert_array_equal(np.asarray(jrow)[:, ing], packed[:, ing])


def test_build_index_dispatch():
    """io.hydro.build_index: rectilinear with edges, binned without, as JAX's."""
    cfg, jhost, thost, _ = _hosts("cart3_cells")
    edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 17),
             np.geomspace(1.8e12, 2.9e12, 33))
    tcfg = convert.config_from_reference(cfg)
    rect = thydro.build_index(tcfg, thost, edges, device="cpu")
    jrect = jhydro.build_index(cfg, jhost, edges)
    assert isinstance(rect, tgrid.RectilinearIndex) and rect.uniform == jrect.uniform
    np.testing.assert_array_equal(rect.edges2.numpy(), np.asarray(jrect.edges2))
    binned = thydro.build_index(tcfg, thost, device="cpu")
    jbinned = jhydro.build_index(cfg, jhost)
    assert isinstance(binned, tgrid.BinnedIndex) and binned.dims == jbinned.dims
    np.testing.assert_array_equal(binned.cell_ids.numpy(), np.asarray(jbinned.cell_ids))
