"""Fault F8: a BinnedIndex must find every cell of a deeply refined AMR frame.

The frame is one coarse FLASH block of 8 x 8 cells beside 32 x 32 fine
blocks (``models.analytic.amr_blocks_2d`` + ``io.flash.cells_from_blocks``):
a coarse-to-fine cell ratio of 32 and 65,600 cells.  Bins are floored at the
coarse cell, so one bin holds 1,024 fine cells.  The JAX package caps
``max_slab`` at 512 and never tests the cells past it: 32,768 cell centres
find no cell there (the fault, documented here from its index arrays and
its search on a sample).  The port searches every
cell of a bin, so each centre finds its own cell.  Below the old cap (a cell
ratio of 16, 256 cells a bin) the two indices are identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import grid as jgrid
from mcrat_tpu.config import Config, Dims, Geometry, SimType
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch.io import flash as tflash
from mcrat_tpu_torch.models import analytic as tan

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
SIDE = 1e11  # the coarse block's side [cm]
R1_LO = 1.8e12


def _hosts(ratio):
    """(JAX host, port host) of one coarse block beside ``ratio`` x
    ``ratio`` fine blocks of the same total size."""
    bands = [(0.0, SIDE, 1, 1), (SIDE, 2 * SIDE, ratio, ratio)]
    coords, bsz = tan.amr_blocks_2d(bands, R1_LO, R1_LO + SIDE)
    n = len(coords)
    fields = dict(velx=np.zeros((n, 64)), vely=np.zeros((n, 64)), dens=np.ones((n, 64)),
                  pres=np.ones((n, 64)))
    thost = tflash.cells_from_blocks(convert.config_from_reference(CFG), coords, bsz, fields)
    jhost = jgrid.frame_from_numpy(CFG, {k: getattr(thost, k) for k in (
        "r0", "r1", "dr0", "dr1", "v0", "v1", "dens", "pres")})
    return jhost, thost


def _centres(host):
    return [np.asarray(a, dtype=np.float32) for a in (host.r0, host.r1, np.zeros_like(host.r0))]


def _jax_find(jidx, jhost, pts, chunk=8192):
    """JAX's search of ``pts``, in fixed-size chunks (one compile)."""
    frame = jhost.to_device(dtype=jnp.float32)
    n = len(pts[0])
    out = []
    for a in range(0, n, chunk):
        part = [np.zeros(chunk, np.float32) for _ in pts]
        for p, src in zip(part, pts):
            p[:min(chunk, n - a)] = src[a:a + chunk]
        got = np.asarray(jidx.find(*(jnp.asarray(p) for p in part), frame, None))
        out.append(got[:min(chunk, n - a)])
    return np.concatenate(out)


def test_every_cell_centre_finds_its_cell_at_cell_ratio_32():
    jhost, thost = _hosts(32)
    assert thost.num_elements == 65_600
    tidx = tgrid.build_binned_index(thost, device="cpu")
    jidx = jgrid.build_binned_index(jhost)
    counts = tidx.bin_count.numpy()
    assert counts.max() == 1024
    assert tidx.max_slab == 1024 and jidx.max_slab == 512
    # the bins themselves are JAX's
    np.testing.assert_array_equal(tidx.cell_ids.numpy(), np.asarray(jidx.cell_ids))
    np.testing.assert_array_equal(tidx.bin_count.numpy(), np.asarray(jidx.bin_count))
    pts = _centres(thost)
    got = tidx.find(*(torch.from_numpy(p) for p in pts), thost.to_device("cpu")).numpy()
    np.testing.assert_array_equal(got, np.arange(thost.num_elements))
    # the reference loses every cell past the 512th of its bin: 32,768 of
    # them by its index arrays, and its search agrees on a sample of 8,192
    cell_ids = np.asarray(jidx.cell_ids)
    slot = np.empty(len(cell_ids), np.int64)
    slot[cell_ids] = np.arange(len(cell_ids)) - np.repeat(
        np.asarray(jidx.bin_start), np.asarray(jidx.bin_count))
    lost = slot >= jidx.max_slab
    assert int(lost.sum()) == 32_768
    pick = np.random.default_rng(9).choice(thost.num_elements, 8192, replace=False)
    want = _jax_find(jidx, jhost, [p[pick] for p in pts])
    np.testing.assert_array_equal(want < 0, lost[pick])
    np.testing.assert_array_equal(want[~lost[pick]], pick[~lost[pick]])


@pytest.mark.parametrize("budget_lanes,n", [(None, 4000), (1, 200), (300, 4000)])
def test_find_in_budget_chunks_at_cell_ratio_32(budget_lanes, n, monkeypatch):
    """The lane chunks shrink as max_slab grows, down to one lane; the cells
    found do not depend on them."""
    _, thost = _hosts(32)
    tidx = tgrid.build_binned_index(thost, device="cpu")
    if budget_lanes is not None:
        monkeypatch.setattr(tgrid, "SEARCH_BUDGET_BYTES",
                            budget_lanes * tgrid._SEARCH_BYTES_PER_CANDIDATE * tidx.max_slab)
    rs = np.random.default_rng(8)
    pick = rs.choice(thost.num_elements, n, replace=False)
    pts = [torch.from_numpy(p[pick]) for p in _centres(thost)]
    got = tidx.find(*pts, thost.to_device("cpu")).numpy()
    np.testing.assert_array_equal(got, pick)


def test_identical_to_jax_below_the_old_cap():
    """Cell ratio 16: 256 cells a bin, JAX does not truncate, and the
    port's index arrays and max_slab are JAX's; both find every centre."""
    jhost, thost = _hosts(16)
    tidx = tgrid.build_binned_index(thost, device="cpu")
    jidx = jgrid.build_binned_index(jhost)
    for name in ("cell_ids", "bin_start", "bin_count", "grid_min", "inv_bin"):
        np.testing.assert_array_equal(getattr(tidx, name).numpy(), np.asarray(getattr(jidx, name)),
                                      err_msg=name)
    assert tidx.dims == jidx.dims and tidx.max_slab == jidx.max_slab == 256
    pts = _centres(thost)
    got = tidx.find(*(torch.from_numpy(p) for p in pts), thost.to_device("cpu")).numpy()
    np.testing.assert_array_equal(got, np.arange(thost.num_elements))
    np.testing.assert_array_equal(_jax_find(jidx, jhost, pts), got)
