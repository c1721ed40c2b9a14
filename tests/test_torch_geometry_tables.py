"""Cell tables, fluid velocity and kernel-variant selection of the port
against mcrat_tpu, for every (dims x geometry) frame.

The same frame is built by both packages' own host frames and models (and,
once more, carried across from the JAX host frame by ``convert``): the
port's ``packed`` (16 or 24 rows), ``packed_slim`` and ultra ``phys`` tables
equal what the JAX frame and glue hand their kernel, exactly, row for row.
``fluid_beta_from_rows`` agrees in float64 to rtol 1e-12.  The variant the
port selects is the one the JAX glue's flags select
(mcrat_tpu/transport.py:692-757), without the TPU's index-bit size limits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry_cases import VARIANT_CASES, frame_case, to_port
from mcrat_tpu import grid as jgrid
from mcrat_tpu.config import Config, Dims, Geometry
from mcrat_tpu.constants import M_P
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)

HOST_FIELDS = ("r0", "r1", "r2", "dr0", "dr1", "dr2", "r", "theta", "v0", "v1", "v2",
               "dens", "dens_lab", "pres", "temp", "gamma", "domain")


@pytest.mark.parametrize("name", ["ultra_cyl2"] + VARIANT_CASES)
def test_cell_tables_match_jax(name):
    cfg, jhost, edges, _ = frame_case(name)
    _, thost, tedges, _ = frame_case(name, port=True)
    for a, b in zip(edges, tedges):
        np.testing.assert_array_equal(a, b)
    for f in HOST_FIELDS:
        np.testing.assert_allclose(getattr(thost, f), getattr(jhost, f), rtol=1e-12, atol=0,
                                   err_msg=f)
    jdev = jhost.to_device(dtype=jnp.float32)
    jpacked = np.asarray(jdev.packed)
    tcfg = convert.config_from_reference(cfg)
    assert jpacked.shape[0] == tgrid.packed_width(tcfg) == (
        24 if name == "packed_sph3" else 16)
    # the port's own frame, and the JAX frame carried across by convert
    tframe_conv, tidx, _ = to_port(cfg, jhost, edges)
    for tdev in (thost.to_device("cpu"), tframe_conv):
        np.testing.assert_array_equal(tdev.packed.numpy(), jpacked)
        np.testing.assert_array_equal(tdev.domain.numpy(), np.asarray(jdev.domain))
        if jdev.packed_slim is None:
            assert tdev.packed_slim is None
        else:
            np.testing.assert_array_equal(tdev.packed_slim.numpy(), np.asarray(jdev.packed_slim))
        if cfg.dims is Dims.THREE and cfg.geometry is Geometry.CARTESIAN:
            # the JAX glue's ultra 3-D table (mcrat_tpu/transport.py:764-769)
            p = jdev.packed
            want = jnp.stack([p[jgrid.PCOL["v0"]], p[jgrid.PCOL["v1"]], p[jgrid.PCOL["v2"]],
                              p[jgrid.PCOL["dens_lab"]] * (1.0 / M_P), p[jgrid.PCOL["temp"]]])
            np.testing.assert_array_equal(tdev.phys.numpy(), np.asarray(want))
        elif jdev.packed_slim is not None:
            np.testing.assert_array_equal(tdev.phys.numpy(), np.asarray(jdev.packed_slim)[4:8])
        else:
            assert tdev.phys is None
    setup = tt.select_variant(tcfg, tframe_conv, tidx)
    assert setup.variant == name
    assert setup.table.shape[0] == fr.VARIANTS[name].width
    assert (setup.cheb_base, setup.nt, setup.aux) == (0, None, None)  # DIRECT
    assert tt.unsupported_reason(tcfg, tframe_conv, tidx) is None


def test_row_layout_matches_jax():
    assert tgrid.PCOL == jgrid.PCOL and tgrid.PCOL_SLIM == jgrid.PCOL_SLIM
    assert tgrid.PACKED_WIDTH == jgrid.PACKED_WIDTH
    for dims, geom in [(Dims.TWO, Geometry.SPHERICAL), (Dims.THREE, Geometry.SPHERICAL),
                       (Dims.THREE, Geometry.POLAR), (Dims.TWO_POINT_FIVE, Geometry.CARTESIAN)]:
        cfg = Config(dims=dims, geometry=geom)
        assert tgrid.packed_width(convert.config_from_reference(cfg)) == jgrid.packed_width(cfg)


@pytest.mark.parametrize("dims,geom", [
    (Dims.TWO, Geometry.CYLINDRICAL), (Dims.TWO_POINT_FIVE, Geometry.CARTESIAN),
    (Dims.TWO, Geometry.SPHERICAL), (Dims.TWO_POINT_FIVE, Geometry.SPHERICAL),
    (Dims.THREE, Geometry.POLAR),
], ids=lambda v: v.name)
def test_fluid_beta_from_rows_matches_jax(dims, geom):
    cfg = Config(dims=dims, geometry=geom)
    rs = np.random.default_rng(4)
    n = 3000
    rows = rs.uniform(-0.5, 0.5, (24, n))
    th = rs.uniform(0.0, np.pi, n)
    rows[jgrid.PCOL["sin1"]], rows[jgrid.PCOL["cos1"]] = np.sin(th), np.cos(th)
    x, y = rs.normal(size=(2, n)) * 1e12
    x[:50] = y[:50] = 0.0  # on the axis: azimuth taken as 0
    want = np.asarray(jgrid.fluid_beta_from_rows(cfg, jnp.asarray(rows), jnp.asarray(x),
                                                 jnp.asarray(y)))
    got = tgrid.fluid_beta_from_rows(convert.config_from_reference(cfg), torch.from_numpy(rows),
                                     torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_grid_scalars_are_the_jax_glue_scalars():
    """The ultra grid scalars equal the JAX glue's float32 geometry vector
    (mcrat_tpu/transport.py:796-809)."""
    for name in ("ultra_sph2", "ultra_cart3"):
        cfg, host, edges, _ = frame_case(name)
        tframe, tidx, _ = to_port(cfg, host, edges)
        g = tt.grid_scalars(tframe, tidx)
        jidx = jgrid.build_rectilinear_index(*edges, dtype="float32")
        parts = []
        for a, e in enumerate((jidx.edges0, jidx.edges1, jidx.edges2)[:len(edges)]):
            parts += [jidx.lo[a], e[1] - e[0]]
        want = np.concatenate([np.asarray(host.to_device(dtype=jnp.float32).domain,
                                          np.float32).reshape(-1),
                               np.asarray(jnp.stack(parts), np.float32)])
        got = [g.dom0, g.dom1, g.dom2, g.dom3, g.dom4, g.dom5, g.lo0, g.d0, g.lo1, g.d1,
               g.lo2, g.d2][:len(want)]
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
        assert (g.n1, g.n2) == (len(edges[1]) - 1, len(edges[2]) - 1 if len(edges) == 3 else 1)
