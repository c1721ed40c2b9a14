"""Geometry, host frames and cell lookup of the port against mcrat_tpu.

The same numpy inputs (seeded) go through both packages: geometry transforms
agree in float64 to rtol 1e-12 on numpy and on torch inputs, the device
tables equal the JAX frame's ``packed_slim``, and ``find_cell_direct``
returns identical cell indices on float32 positions, edge and out-of-domain
points included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import geometry as jgeo
from mcrat_tpu import grid as jgrid
from mcrat_tpu.config import Config, Dims, Geometry, SimType
from mcrat_tpu.models import analytic as jan
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import geometry as tgeo
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch.models import analytic as tan

torch.set_num_threads(1)

GEOMETRIES = [
    (Dims.TWO, Geometry.CARTESIAN),
    (Dims.TWO, Geometry.CYLINDRICAL),
    (Dims.TWO, Geometry.SPHERICAL),
    (Dims.TWO_POINT_FIVE, Geometry.CYLINDRICAL),
    (Dims.TWO_POINT_FIVE, Geometry.SPHERICAL),
    (Dims.THREE, Geometry.CARTESIAN),
    (Dims.THREE, Geometry.SPHERICAL),
    (Dims.THREE, Geometry.POLAR),
]


def _inputs(seed=0, n=2000):
    rs = np.random.default_rng(seed)
    xyz = rs.normal(size=(3, n)) * 1e12
    hyd = np.stack([rs.uniform(1e10, 1e12, n), rs.uniform(0.01, 3.1, n), rs.uniform(0.0, 6.2, n)])
    vec = rs.uniform(-0.5, 0.5, (3, n))
    size = rs.uniform(1e8, 1e10, (3, n))
    return xyz, hyd, vec, size


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=1e-12, atol=0)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("dims,geom", GEOMETRIES, ids=lambda v: v.name)
def test_geometry_matches_jax(dims, geom, as_tensor):
    cfg = Config(dims=dims, geometry=geom)
    tcfg = convert.config_from_reference(cfg)
    xyz, hyd, vec, size = _inputs()

    def conv(a):
        return torch.from_numpy(a) if as_tensor else a

    def out(vals):
        return [v.numpy() if torch.is_tensor(v) else v for v in vals]

    for name in ("mcrat_to_hydro", "hydro_to_spherical", "hydro_to_mcrat"):
        src = xyz if name == "mcrat_to_hydro" else hyd
        want = getattr(jgeo, name)(cfg, *src)
        got = out(getattr(tgeo, name)(tcfg, *[conv(a) for a in src]))
        for w, g in zip(want, got):
            _close(g, w)
    want = jgeo.hydro_vector_to_cartesian(cfg, *vec, *hyd)
    got = out(tgeo.hydro_vector_to_cartesian(tcfg, *[conv(a) for a in (*vec, *hyd)]))
    for w, g in zip(want, got):
        _close(g, w)
    _close(out([tgeo.element_volume(tcfg, *[conv(a) for a in (*hyd, *size)])])[0],
           jgeo.element_volume(cfg, *hyd, *size))
    probe = hyd + size * 0.3 * np.sign(np.random.default_rng(1).normal(size=hyd.shape))
    for use_r2 in (False, True):
        want = jgeo.in_block(*probe, *hyd, *size, use_r2=use_r2)
        got = tgeo.in_block(*[conv(a) for a in (*probe, *hyd, *size)], use_r2=use_r2)
        np.testing.assert_array_equal(np.asarray(got), want)


def _frames(prep):
    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
    tcfg = convert.config_from_reference(cfg)
    r0e = np.linspace(0.0, 3.2e11, 33)
    r1e = np.linspace(1.8e12, 2.9e12, 65)
    jhost = jgrid.frame_from_numpy(cfg, jan.make_grid_2d(cfg, r0e, r1e))
    thost = tgrid.frame_from_numpy(tcfg, tan.make_grid_2d(tcfg, r0e, r1e))
    getattr(jan, prep)(jhost)
    getattr(tan, prep)(thost)
    return cfg, jhost, thost, (r0e, r1e)


@pytest.mark.parametrize("prep", ["cylindrical_prep", "spherical_prep",
                                  "structured_fireball_prep"])
def test_host_frame_and_device_tables_match_jax(prep):
    cfg, jhost, thost, _ = _frames(prep)
    for f in ("r0", "r1", "dr0", "dr1", "r", "theta", "v0", "v1", "v2", "dens",
              "dens_lab", "pres", "temp", "gamma", "domain"):
        np.testing.assert_allclose(getattr(thost, f), getattr(jhost, f), rtol=1e-12, atol=0,
                                   err_msg=f)
    np.testing.assert_allclose(thost.volumes(), jhost.volumes(), rtol=1e-12)
    jdev = jhost.to_device(dtype=jnp.float32)
    tdev = thost.to_device("cpu", torch.float32)
    np.testing.assert_array_equal(tdev.packed_slim.numpy(), np.asarray(jdev.packed_slim))
    np.testing.assert_array_equal(tdev.phys.numpy(), np.asarray(jdev.packed_slim)[4:8])
    np.testing.assert_array_equal(tdev.domain.numpy(), np.asarray(jdev.domain))
    # the converter carries the JAX host frame's fields across unchanged
    conv = convert.frame_from_numpy_fields(cfg, vars(jhost)).to_device("cpu")
    np.testing.assert_array_equal(conv.phys.numpy(), tdev.phys.numpy())


def _positions(edges, three_d, seed=3, n=10_000):
    """f32 positions: random inside and around the domain, exactly on cell
    edges (azimuth 0, so the hydro radius is exact), and far outside."""
    rs = np.random.default_rng(seed)
    e0, e1 = edges[0], edges[1]
    span0, span1 = e0[-1] - e0[0], e1[-1] - e1[0]
    if three_d:
        e2 = edges[2]
        span2 = e2[-1] - e2[0]
        pts = np.stack([rs.uniform(e0[0] - 0.1 * span0, e0[-1] + 0.1 * span0, n),
                        rs.uniform(e1[0] - 0.1 * span1, e1[-1] + 0.1 * span1, n),
                        rs.uniform(e2[0] - 0.1 * span2, e2[-1] + 0.1 * span2, n)], axis=1)
        on = np.stack([rs.choice(e0, 500), rs.choice(e1, 500), rs.choice(e2, 500)], axis=1)
    else:
        rad = rs.uniform(0.0, e0[-1] + 0.1 * span0, n)
        phi = rs.uniform(0.0, 2 * np.pi, n)
        pts = np.stack([rad * np.cos(phi), rad * np.sin(phi),
                        rs.uniform(e1[0] - 0.1 * span1, e1[-1] + 0.1 * span1, n)], axis=1)
        on = np.stack([rs.choice(e0, 500), np.zeros(500), rs.choice(e1, 500)], axis=1)
    far = rs.normal(size=(200, 3)) * 1e15
    return np.concatenate([pts, on, far]).astype(np.float32)


def _angular_positions(cfg, edges, seed=3, n=10_000):
    """f32 positions for spherical/polar grids: random hydro coordinates in
    and around the domain, points on the jet axis, and far outside."""
    rs = np.random.default_rng(seed)
    lo = [e[0] - 0.1 * (e[-1] - e[0]) for e in edges]
    hi = [e[-1] + 0.1 * (e[-1] - e[0]) for e in edges]
    h = [rs.uniform(max(a, 0.0), b, n) for a, b in zip(lo, hi)]
    if cfg.dims is not Dims.THREE:
        h.append(rs.uniform(0.0, 2 * np.pi, n))  # the photon azimuth
    if cfg.geometry is Geometry.SPHERICAL:
        h[1] = np.clip(h[1], 0.0, np.pi)
    pts = np.stack(tgeo.hydro_to_mcrat(convert.config_from_reference(cfg), *h[:3]), axis=1)
    axis = np.stack([np.zeros(300), np.zeros(300), rs.uniform(lo[0], hi[0], 300)], axis=1)
    far = rs.normal(size=(200, 3)) * 1e15
    return np.concatenate([pts, axis, far]).astype(np.float32)


def _near_faces(cfg, edges, pos, ulps=4):
    """Lanes whose float64 hydro coordinates lie within ``ulps`` float32
    ulps of a cell face on some axis, measured in the float32 quantity the
    lookup rounds: the radius or azimuth itself, and cos(theta) = z/r for a
    spherical theta (arccos magnifies one ulp of z/r near the jet axis)."""
    h = tgeo.mcrat_to_hydro(convert.config_from_reference(cfg), *pos.astype(np.float64).T)
    eps = np.finfo(np.float32).eps
    near = np.zeros(len(pos), bool)
    for axis, (coord, e) in enumerate(zip(h, edges)):
        coord = np.asarray(coord)
        if axis == 1 and cfg.geometry is Geometry.SPHERICAL:
            coord, e = np.cos(coord), np.cos(e)
        gap = np.min(np.abs(coord[:, None] - e[None, :]), axis=1)
        near |= gap <= ulps * eps * max(np.abs(e).max(), 1.0)
    return near


ANGULAR = {
    "spherical_2d_log": (Dims.TWO, Geometry.SPHERICAL,
                         (np.geomspace(1e12, 9e13, 97), np.linspace(0.0, 0.31416, 17))),
    "spherical_3d": (Dims.THREE, Geometry.SPHERICAL,
                     (np.geomspace(1e12, 2e13, 49), np.linspace(1e-3, np.pi / 3, 13),
                      np.linspace(0.0, 2 * np.pi, 9))),
    "polar_3d": (Dims.THREE, Geometry.POLAR,
                 (np.linspace(1e10, 3.2e11, 17), np.linspace(0.0, 2 * np.pi, 9),
                  np.linspace(1.8e12, 2.9e12, 33))),
}


@pytest.mark.parametrize("kind", ["uniform_2d", "nonuniform_2d", "uniform_3d", *ANGULAR])
def test_find_cell_direct_identical_to_jax(kind):
    """Cells and in_grid identical to JAX's; on angular grids (float32
    arccos/atan2, which XLA-CPU and torch evaluate differently) a handful may
    differ, every one within a few float32 ulps of a cell face."""
    if kind in ANGULAR:
        dims, geom, edges = ANGULAR[kind]
        cfg = Config(dims=dims, geometry=geom, dtype="float32")
        arrays = (jan.make_grid_2d(cfg, *edges) if dims is Dims.TWO
                  else _grid_3d_arrays(edges))
    elif kind == "uniform_3d":
        cfg = Config(dims=Dims.THREE, geometry=Geometry.CARTESIAN, dtype="float32")
        edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 9),
                 np.linspace(1.8e12, 2.9e12, 33))
        arrays = _grid_3d_arrays(edges)
    else:
        cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL, dtype="float32")
        r1e = (np.linspace(1.8e12, 2.9e12, 65) if kind == "uniform_2d"
               else np.geomspace(1.8e12, 2.9e12, 65))
        edges = (np.linspace(0.0, 3.2e11, 33), r1e)
        arrays = jan.make_grid_2d(cfg, *edges)
    tcfg = convert.config_from_reference(cfg)
    jhost = jgrid.frame_from_numpy(cfg, arrays)
    thost = tgrid.frame_from_numpy(tcfg, arrays)
    jidx = jgrid.build_rectilinear_index(*edges, dtype="float32")
    tidx = convert.index_from_edges(*edges, device="cpu")
    assert tidx.uniform == jidx.uniform and tidx.three_d == jidx.three_d
    for a in ("lo", "inv_d", "edges0", "edges1", "edges2"):
        np.testing.assert_array_equal(getattr(tidx, a).numpy(), np.asarray(getattr(jidx, a)))
    pos = (_angular_positions(cfg, edges) if kind in ANGULAR
           else _positions(edges, kind == "uniform_3d"))
    jcell, jin = jax.jit(
        lambda p: jgrid.find_cell_direct(cfg, jidx, jhost.to_device(dtype=jnp.float32), p)
    )(jnp.asarray(pos))
    tcell, tin = tgrid.find_cell_direct(tcfg, tidx, thost.to_device("cpu"), torch.from_numpy(pos))
    differ = (tcell.numpy() != np.asarray(jcell)) | (tin.numpy() != np.asarray(jin))
    if kind in ANGULAR:
        assert differ.sum() <= 5, differ.sum()
        assert _near_faces(cfg, edges, pos[differ]).all()
    else:
        assert not differ.any()
    assert 0.3 < float(tin.float().mean()) < 0.99  # both inside and outside probed


def _grid_3d_arrays(edges):
    c = [0.5 * (e[:-1] + e[1:]) for e in edges]
    d = [np.diff(e) for e in edges]
    grids = np.meshgrid(*c, indexing="ij")
    sizes = np.meshgrid(*d, indexing="ij")
    n = grids[0].size
    return dict(r0=grids[0].ravel(), r1=grids[1].ravel(), r2=grids[2].ravel(),
                dr0=sizes[0].ravel(), dr1=sizes[1].ravel(), dr2=sizes[2].ravel(),
                v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n),
                dens=np.ones(n), pres=np.ones(n))
