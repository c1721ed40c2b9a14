"""The carried AMR lookup's kernel (``csrc/binned_search.cu``) against its
plain path, torch ops throughout: ``grid.find_cell_rows_reference`` (the pin
and ``grid.BinnedIndex.find``'s search) with the clamp and
``transport.lane_flags``, in cells, clamped cells, in-grid flags, flag words
and the count of lanes searched.

Tests marked ``card`` run the kernel and skip without a CUDA card; on one,
from the repository's root (this file imports no JAX, and the suite's
conftest does):

    python -m pytest -q -o addopts="" --noconftest -m card tests/test_torch_binned_search.py

Their cell lists are built by the port alone: the small three-level AMR
frame of test_torch_amr_cases, a 2-D spherical grid and a 3-D cartesian
grid taken as unstructured lists (test_torch_amr_index's three), two
overlapping layers of blocks (where the order in which the neighbour bins
are visited decides the cell), fault F8's frame, a coarse block beside
blocks refined 32-fold (1,024 cells a bin, test_torch_f8_index), a 3-D
cartesian slab one cell deep (one bin along axis 2), 3-D spherical and
polar grids as lists, and the benchmark's amr_jet frame (167,936 cells).
Their lanes are a moved population: points uniform over the domain padded
by 5 %, a third on cell and block seams, and points at NaN, +-inf, far
outside the grid and on its outer bin edges, each lane's own cell cached,
a fifth of the lanes moved, some cached cells wrong, -1 or past the last
cell, dead and pool lanes, and positions with a coordinate at NaN or +-inf.
The tests without the mark check, on the CPU, that CPU tensors take the
plain path and launch nothing, what the wrapper refuses, and how the
library is built.
"""
import dataclasses
import hashlib
import re

import numpy as np
import pytest
import torch

from mcrat_tpu_torch import Config, Dims, Geometry, SimType, Spectrum, _build, telemetry
from mcrat_tpu_torch import geometry as geo
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.io import flash as tflash
from mcrat_tpu_torch.models import analytic as tan
from mcrat_tpu_torch.ops import binned_search as bs
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)

KINDS = ["amr_cyl2", "sph2_cells", "cart3_cells", "overlap_cyl2", "cart3_slab", "sph3_cells",
         "pol3_cells"]
# the AMR frame's refinement bands (test_torch_amr_cases.BANDS), the
# benchmark's amr_jet frame's (benchmark/configs/amr_jet.json) and F8's
AMR_BANDS = [(0.0, 1.28e11, 4, 16), (1.28e11, 2.56e11, 2, 8), (2.56e11, 3.2e11, 1, 4)]
AMR_JET_BANDS = [(0.0, 1.28e11, 16, 128), (1.28e11, 2.56e11, 8, 64), (2.56e11, 3.2e11, 2, 32)]
F8_SIDE = 1e11
F8_BANDS = [(0.0, F8_SIDE, 1, 1), (F8_SIDE, 2 * F8_SIDE, 32, 32)]
R1 = (1.8e12, 2.9e12)
SPECIALS = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the carried lookup kernel runs only there")
    return torch.device("cuda")


def _blocks(cfg, bands, shifted=False):
    """The cell list of FLASH blocks in ``bands``; ``shifted`` adds a second
    layer of the same blocks moved by half a cell along r0 and back by half
    a cell along r1."""
    coords, size = tan.amr_blocks_2d(bands, *R1)
    if shifted:
        coords = np.concatenate([coords, coords + size / 16 * np.array([1.0, -1.0])])
        size = np.concatenate([size, size])
    ones = np.ones((len(coords), 64))
    return tflash.cells_from_blocks(cfg, coords, size, dict(velx=0 * ones, vely=0 * ones,
                                                            dens=ones, pres=ones))


def _edge_cells(cfg, edges):
    """The cells of a rectilinear grid's ``edges`` as an unstructured list."""
    c = np.meshgrid(*[0.5 * (e[:-1] + e[1:]) for e in edges], indexing="ij")
    d = np.meshgrid(*[np.diff(e) for e in edges], indexing="ij")
    n = c[0].size
    return tgrid.frame_from_numpy(cfg, dict(
        r0=c[0].ravel(), r1=c[1].ravel(), r2=c[2].ravel(), dr0=d[0].ravel(), dr1=d[1].ravel(),
        dr2=d[2].ravel(), v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n), dens=np.ones(n),
        pres=np.ones(n)))


def _host(kind):
    """(port host, per-axis seam coordinates) of a cell list."""
    if kind in ("amr_cyl2", "f8", "overlap_cyl2", "amr_jet"):
        cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                     simulation_type=SimType.CYLINDRICAL_OUTFLOW)
        if kind == "f8":
            return _blocks(cfg, F8_BANDS), None
        if kind == "amr_jet":
            host = _blocks(cfg, AMR_JET_BANDS)
            tan.cylindrical_prep(host)
            return host, (np.concatenate([np.arange(0, 128) * 1e9, 1.28e11 + np.arange(64) * 2e9,
                                          2.56e11 + np.arange(17) * 4e9]),
                          R1[0] + np.arange(0, 1025) * (1.1e12 / 1024), [0.0])
        if kind == "overlap_cyl2":
            # each point in two cells whose centres lie in different
            # neighbour bins: the bins' visiting order picks the cell
            return _blocks(cfg, AMR_BANDS[:1], shifted=True), (
                np.arange(0, 33) * 4e9, R1[0] + np.arange(0, 129) * (1.1e12 / 128), [0.0])
        host = _blocks(cfg, AMR_BANDS)
        tan.cylindrical_prep(host)
        return host, (np.arange(0, 41) * 8e9, R1[0] + np.arange(0, 65) * (1.1e12 / 64), [0.0])
    if kind == "sph2_cells":
        cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                     simulation_type=SimType.SPHERICAL_OUTFLOW)
        host, edges = tan.synthetic_spherical_frame(cfg, 5e11, 4e12, nr=48, ntheta=6,
                                                    theta_max=np.pi / 3)
        return host, (edges[0], edges[1], [0.0])
    if kind == "sph3_cells":
        cfg = Config(dims=Dims.THREE, geometry=Geometry.SPHERICAL)
        edges = (np.geomspace(5e11, 4e12, 13), np.linspace(0.0, np.pi, 10),
                 np.linspace(0.0, 2 * np.pi, 11))
        return _edge_cells(cfg, edges), edges
    if kind == "pol3_cells":
        cfg = Config(dims=Dims.THREE, geometry=Geometry.POLAR)
        edges = (np.geomspace(1e10, 4e11, 13), np.linspace(0.0, 2 * np.pi, 11),
                 np.linspace(1.8e12, 2.9e12, 10))
        return _edge_cells(cfg, edges), edges
    cfg = Config(dims=Dims.THREE, geometry=Geometry.CARTESIAN,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW)
    if kind == "cart3_slab":
        edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 17),
                 np.array([1.8e12, 2.9e12]))
        return _edge_cells(cfg, edges), edges
    edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 17),
             np.geomspace(1.8e12, 2.9e12, 33))
    return tan.apply_simulation_type(_edge_cells(cfg, edges)), edges


def _lanes(host, index, seams, n=6000, seed=3):
    """float64 hydro coordinates: uniform over the domain padded by 5 %, a
    third with one coordinate on a seam, then 600 lanes at NaN, +-inf and
    +-1e30 and on the index's outer bin edges."""
    rs = np.random.default_rng(seed)
    three_d = host.cfg.dims is Dims.THREE
    cols = []
    for axis, (lo, hi) in enumerate(np.asarray(host.domain)):
        pad = 0.05 * (hi - lo)
        col = rs.uniform(lo - pad, hi + pad, n)
        if axis < (3 if three_d else 2):
            sl = slice(axis * n // 6, (axis + 1) * n // 6)
            col[sl] = rs.choice(np.asarray(seams[axis]), sl.stop - sl.start)
        extra = rs.choice(SPECIALS, 600)
        width = 1.0 / float(index.inv_bin[axis])
        extra[:300] = float(index.grid_min[axis]) + width * rs.integers(-1, index.dims[axis] + 2,
                                                                        300)
        cols.append(np.concatenate([col, extra]) if three_d or axis < 2
                    else np.zeros(n + 600))
    return cols


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors run find_cell_rows_reference and BinnedIndex.find as torch
    ops: they never reach the kernel's wrapper nor build its tables, and a
    search split into lane chunks gives the cells of one chunk."""
    cfg, index, frame, pos, cached, alive, pool = _carried_inputs("amr_cyl2", torch.float32,
                                                                  "cpu", n=600)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(tgrid, "carried_lookup", no_kernel)
    before = bs.carried_lookup.launches
    got = tgrid.find_cell_rows(cfg, index, frame, pos, cached)
    want = tgrid.find_cell_rows_reference(cfg, index, frame, pos, cached)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    r = tgrid._hydro_inside(cfg, frame, pos)[:3]
    whole = index.find(*r, frame)
    monkeypatch.setattr(tgrid, "SEARCH_BUDGET_BYTES",
                        100 * tgrid._SEARCH_BYTES_PER_CANDIDATE * index.max_slab)
    assert torch.equal(index.find(*r, frame), whole) and (whole >= 0).any()
    assert bs.carried_lookup.launches == before and index._tables is None


def test_search_tables_are_the_bin_ordered_geometry():
    """The kernels' tables: the geometry rows in bin order, in the dtype the
    plain version tests in, and the domain, grid_min and inv_bin in the
    lanes' dtype, built once for a frame and dtype."""
    for kind in ("amr_cyl2", "cart3_cells"):
        host, _ = _host(kind)
        index = tgrid.build_binned_index(host, device="cpu")
        frame = host.to_device("cpu")
        rows, params = index.search_tables(frame, torch.float32)
        dom, lo, inv = params[:6], params[6:9], params[9:]
        assert torch.equal(dom, frame.domain.reshape(-1))
        ids = index.cell_ids.to(torch.int64)
        cols = [frame.r0, frame.r1, frame.dr0, frame.dr1]
        if index.dims[2] > 1:
            cols += [frame.r2, frame.dr2]
        assert rows.shape == (host.num_elements, 4 if len(cols) == 4 else 8)
        for q, col in enumerate(cols):
            assert torch.equal(rows[:, q], col[ids])
        assert (rows[:, len(cols):] == 0).all()
        assert torch.equal(lo, index.grid_min) and torch.equal(inv, index.inv_bin)
        assert index.search_tables(frame, torch.float32)[0] is rows
        rows64, params64 = index.search_tables(frame, torch.float64)
        assert rows64.dtype == torch.float64 and params64.dtype == torch.float64
        frame64 = host.to_device("cpu", dtype=torch.float64)
        assert index.search_tables(frame64, torch.float32)[0].dtype == torch.float64


def _carried_inputs(kind, dtype, device, frame_dtype=torch.float32, n=6000, seed=3):
    """(cfg, index, frame, pos, cached, alive, pool) of a moved population
    on a cell list: ``_lanes``' points as (N, 3) MCRaT positions of
    ``dtype`` (in 2-D on azimuth 0 for the first third, the seam lanes, so
    that r0 comes back exact), each lane's own cell cached, then a fifth of
    the lanes moved by up to 0.3 % of each coordinate, 5 % of the cached
    cells replaced by random cells, 5 % by -1 and 20 by a cell past the
    last, 200 positions with a coordinate at NaN or +-inf; 90 % of the lanes
    alive and 10 % pool lanes."""
    host, seams = _host(kind)
    cfg = host.cfg
    index = tgrid.build_binned_index(host, device=device)
    frame = host.to_device(device, dtype=frame_dtype)
    rs = np.random.default_rng(seed)
    cols = _lanes(host, index, seams, n=n, seed=seed)
    m = cols[0].size
    if cfg.dims is not Dims.THREE:
        cols[2] = np.where(np.arange(m) < n // 3, 0.0, rs.uniform(0.0, 2 * np.pi, m))
    with np.errstate(invalid="ignore"):
        xyz = np.stack(geo.hydro_to_mcrat(cfg, *cols), axis=1)
    none = torch.full((m,), -1, dtype=torch.int32, device=device)
    home, _ = tgrid.find_cell_rows_reference(
        cfg, index, frame, torch.as_tensor(xyz, dtype=dtype, device=device), none)
    xyz = xyz * np.where(rs.random((m, 1)) < 0.2, 1.0 + rs.uniform(-3e-3, 3e-3, (m, 3)), 1.0)
    bad = rs.choice(m, 200, replace=False)
    xyz[bad, rs.integers(0, 3, 200)] = rs.choice([np.nan, np.inf, -np.inf], 200)
    cached = home.cpu().numpy()
    pick = rs.random(m)
    cached[pick < 0.05] = rs.integers(0, host.num_elements, int((pick < 0.05).sum()))
    cached[(pick >= 0.05) & (pick < 0.1)] = -1
    cached[rs.choice(m, 20, replace=False)] = host.num_elements + 2
    alive, pool = rs.random(m) < 0.9, rs.random(m) < 0.1

    def put(a, t):
        return torch.as_tensor(a, dtype=t, device=device)

    return (cfg, index, frame, put(xyz, dtype), put(cached, torch.int32), put(alive, torch.bool),
            put(pool, torch.bool))


def _plain_carried(cfg, index, frame, pos, cached, alive, pool):
    """The plain path: find_cell_rows_reference, the clamp and lane_flags;
    (cell, in_grid, safe, flags, lanes searched)."""
    searched = torch.zeros((), dtype=torch.int64, device=pos.device)
    cell, in_grid = tgrid.find_cell_rows_reference(cfg, index, frame, pos, cached,
                                                   searched=searched)
    safe = torch.clamp(cell, 0, frame.num_elements - 1).to(torch.int32)
    return cell, in_grid, safe, tt.lane_flags(alive, pool, in_grid), int(searched)


def _check_carried(cfg, index, frame, pos, cached, alive, pool):
    """The kernel's (find_cell_rows_flags, find_cell_rows) against the plain
    path: every value and the lanes searched.  Returns the plain path's
    values."""
    want = _plain_carried(cfg, index, frame, pos, cached, alive, pool)
    counts = [torch.zeros((), dtype=torch.int64, device=pos.device) for _ in range(2)]
    cell, safe, flags = tgrid.find_cell_rows_flags(cfg, index, frame, pos, cached, alive, pool,
                                                   tt._FLAG_BITS, searched=counts[0])
    cell2, in_grid = tgrid.find_cell_rows(cfg, index, frame, pos, cached, searched=counts[1])
    for got, ref, name in ((cell, want[0], "cell"), (safe, want[2], "safe"),
                           (flags, want[3], "flags"), (cell2, want[0], "cell"),
                           (in_grid, want[1], "in_grid")):
        assert got.dtype == ref.dtype and torch.equal(got, ref), (name, int((got != ref).sum()))
    assert int(counts[0]) == int(counts[1]) == want[4]
    return want


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_carried_lookup_bit_identical_to_plain_path(kind, dtype, card):
    """One launch gives the plain path's cells, clamped cells, in-grid flags
    and flag words, and counts its lanes searched, on float32 and float64
    frames; pinned, searched, out-of-domain and NaN lanes all occur."""
    for frame_dtype in (torch.float32, torch.float64):
        cfg, index, frame, pos, cached, alive, pool = _carried_inputs(kind, dtype, card,
                                                                      frame_dtype)
        cell, in_grid, _, _, searched = _check_carried(cfg, index, frame, pos, cached, alive,
                                                       pool)
        assert 0 < searched < pos.shape[0] // 2
        assert ((cell == cached) & (cell >= 0)).float().mean() > 0.3  # pinned
        assert (cell < 0).any() and in_grid.float().mean() > 0.4
        assert (cell[torch.isnan(pos).any(dim=1)] == -1).all()


@pytest.mark.card
def test_carried_lookup_amr_jet_size_and_seam_gaps(card):
    """The benchmark's amr_jet frame (167,936 cells) at ~1M lanes, float32:
    bit for bit the plain path, and fault F14's seam lanes (points in the
    float32 rounding gap between two cells' boxes, on no cell) keep -1."""
    cfg, index, frame, pos, cached, alive, pool = _carried_inputs(
        "amr_jet", torch.float32, card, n=1_000_000, seed=19)
    assert frame.num_elements == 167_936
    cell, in_grid, _, _, searched = _check_carried(cfg, index, frame, pos, cached, alive, pool)
    _, _, _, inside = tgrid._hydro_inside(cfg, frame, pos)
    assert ((cell < 0) & inside).sum() > 0  # F14's gap lanes, inside the domain on no cell
    assert 0.05 < searched / pos.shape[0] < 0.5


@pytest.mark.card
def test_carried_lookup_f8_frame(card):
    """Every cell centre of the cell-ratio-32 frame (1,024 cells a bin),
    half with its own cell cached and half with none, then all with none."""
    host, _ = _host("f8")
    cfg = host.cfg
    index = tgrid.build_binned_index(host, device=card)
    frame = host.to_device(card)
    n = host.num_elements
    pos = torch.as_tensor(np.stack([host.r0, np.zeros(n), host.r1], axis=1), dtype=torch.float32,
                          device=card)
    ids = torch.arange(n, dtype=torch.int32, device=card)
    alive = torch.ones(n, dtype=torch.bool, device=card)
    for cached, want in ((torch.where(ids % 2 == 0, ids, -1), n // 2),
                         (torch.full_like(ids, -1), n)):
        cell, *_, searched = _check_carried(cfg, index, frame, pos, cached, alive, ~alive)
        assert torch.equal(cell, ids) and searched == want


@pytest.mark.card
def test_carried_lookup_one_launch_no_sync(card):
    """One launch a lookup (none for an empty lane set), no host sync
    (torch's sync debug mode raises on one), and the device counter equal to
    the plain path's lanes searched."""
    cfg, index, frame, pos, cached, alive, pool = _carried_inputs("amr_cyl2", torch.float32,
                                                                  card)
    want = _plain_carried(cfg, index, frame, pos, cached, alive, pool)
    tgrid.find_cell_rows(cfg, index, frame, pos, cached)  # builds the library and the tables
    searched = torch.zeros((), dtype=torch.int64, device=card)
    torch.cuda.synchronize()
    before = bs.carried_lookup.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tgrid.find_cell_rows_flags(cfg, index, frame, pos, cached, alive, pool,
                                         tt._FLAG_BITS, searched=searched)
        empty = tgrid.find_cell_rows(cfg, index, frame, pos[:0], cached[:0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bs.carried_lookup.launches == before + 1
    assert empty[0].shape == (0,) and empty[1].dtype == torch.bool
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[3])
    assert int(searched) == want[4] > 0


def _carried_frame(device):
    host, _ = _host("amr_cyl2")
    cfg = host.cfg
    index = tgrid.build_binned_index(host, device=device)
    frame = host.to_device(device)
    arrays, _ = tt.inject_photons(host, 2e12, 1e50, 1500, 3000, Spectrum.BLACKBODY, 0.0,
                                  0.1047, 5.0, np.random.default_rng(3))
    photons, _ = tt.photons_from_arrays(arrays, device=device)
    return cfg, index, frame, photons


@pytest.mark.card
def test_carried_branch_frame_unchanged_by_the_kernel(card, monkeypatch):
    """transport_rounds_fused's carried branch (through the round's plain
    twin) gives the same lanes and the same lanes searched with the
    kernel's lookups as with the plain path's, and every lookup is one
    launch of the carried lookup."""
    cfg, index, frame, photons = _carried_frame(card)
    t_rem = tt.frame_time(photons, 0.2)
    setup = tt.select_variant(cfg, frame, index)

    def run():
        with telemetry.frame("transport.frame", card):
            res = tt.transport_rounds_fused(cfg, photons, frame, index, t_rem, 7, setup,
                                            max_rounds=8, s_rows=8,
                                            rounds_fn=fr.fused_rounds_reference)
        return res, telemetry.summary()

    def plain_inputs(cfg, index, frame, pos, cached, alive, pool, searched=None):
        cell, in_grid = tgrid.find_cell_rows_reference(cfg, index, frame, pos, cached,
                                                       searched=searched)
        return (cell, torch.clamp(cell, 0, frame.num_elements - 1).to(torch.int32),
                tt.lane_flags(alive, pool, in_grid))

    before = bs.carried_lookup.launches
    telemetry.reset()
    telemetry.enable()
    try:
        got, summ = run()
        lookups = bs.carried_lookup.launches - before
        monkeypatch.setattr(tt, "carried_lane_inputs", plain_inputs)
        monkeypatch.setattr(tt, "find_cell_rows", tgrid.find_cell_rows_reference)
        want, _ = run()
    finally:
        telemetry.enable(False)
        telemetry.reset()
    assert lookups == summ["spans"]["grid.lookup"]["count"] > 0
    assert got.n_searched is not None and int(got.n_searched) == int(want.n_searched) > 0
    for name, value in want.photons.fields().items():
        assert torch.equal(getattr(got.photons, name), value), name
    assert torch.equal(got.t_rem, want.t_rem) and got.n_rounds == want.n_rounds


@pytest.mark.card
def test_xla_engine_frame_unchanged_by_the_kernel(card, monkeypatch):
    """The XLA engine's lookups (every lane, ``all_lanes``) through the
    carried lookup kernel give the plain path's frame."""
    cfg, index, frame, photons = _carried_frame(card)
    t_rem = tt.frame_time(photons, 0.2)
    key = tt.Key.from_seed(5, device=card)

    def run():
        return tt.transport_rounds(cfg, photons, frame, index, t_rem, key, max_rounds=6)

    before = bs.carried_lookup.launches
    got = run()
    assert bs.carried_lookup.launches - before == got.n_rounds > 0
    monkeypatch.setattr(tt, "find_cell_rows", tgrid.find_cell_rows_reference)
    want = run()
    for name, value in want.photons.fields().items():
        assert torch.equal(getattr(got.photons, name), value), name
    assert torch.equal(got.t_rem, want.t_rem)


@pytest.mark.parametrize("kind", ["amr_cyl2", "sph2_cells", "cart3_cells", "sph3_cells"])
def test_find_cell_rows_flags_on_cpu_is_the_plain_path(kind, monkeypatch):
    """On CPU tensors find_cell_rows_flags is find_cell_rows_reference, the
    clamp and lane_flags, launches nothing, and counts into ``searched`` the
    lanes inside the domain that left their cached cell."""
    cfg, index, frame, pos, cached, alive, pool = _carried_inputs(kind, torch.float32, "cpu",
                                                                  n=1500)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(tgrid, "carried_lookup_flags", no_kernel)
    monkeypatch.setattr(tgrid, "carried_lookup", no_kernel)
    before = bs.carried_lookup.launches
    want = _check_carried(cfg, index, frame, pos, cached, alive, pool)
    assert bs.carried_lookup.launches == before
    r0, r1, r2, inside = tgrid._hydro_inside(cfg, frame, pos)
    c = torch.clamp(cached, 0, frame.num_elements - 1).to(torch.int64)
    pinned = (cached >= 0) & geo.in_block(r0, r1, r2, frame.r0[c], frame.r1[c], frame.r2[c],
                                           frame.dr0[c], frame.dr1[c], frame.dr2[c],
                                           use_r2=cfg.dims is Dims.THREE)
    assert want[4] == int((inside & ~pinned).sum()) > 0
    assert torch.equal(want[0][pinned & inside], cached[pinned & inside])


def _bad_input(case):
    """Arguments of carried_lookup_flags that its wrapper refuses: CPU
    tensors, or another dtype or shape than it takes."""
    cfg, index, frame, pos, cached, alive, pool = _carried_inputs("amr_cyl2", torch.float32,
                                                                  "cpu", n=600)
    args = dict(pos=pos, cached=cached, alive=alive, pool=pool)
    if case == "float16_positions":
        args["pos"] = pos.half()
    elif case == "positions_n_by_2":
        args["pos"] = pos[:, :2]
    elif case == "int64_cached":
        args["cached"] = cached.long()
    elif case == "uint8_masks":
        args["alive"] = alive.to(torch.uint8)
    elif case == "float16_frame":
        frame = dataclasses.replace(frame, r0=frame.r0.half())
    return cfg, index, frame, args


@pytest.mark.parametrize("case, match", [
    ("cpu", "cuda"), ("float16_positions", "float32 or float64"),
    ("positions_n_by_2", r"\(N, 3\)"), ("int64_cached", "int32"), ("uint8_masks", "bool"),
    ("float16_frame", "frame")])
def test_carried_lookup_wrapper_refuses(case, match):
    cfg, index, frame, args = _bad_input(case)
    before = bs.carried_lookup.launches
    with pytest.raises(ValueError, match=match):
        bs.carried_lookup_flags(cfg, index, frame, args["pos"], args["cached"], args["alive"],
                                args["pool"], tt._FLAG_BITS)
    assert bs.carried_lookup.launches == before and index._tables is None


def _fake_nvcc(monkeypatch, tmp_path):
    """Record the build's compiler commands instead of running them."""
    cmds = []

    def run(cmd):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "run", run)
    return cmds


def test_build_gives_the_search_one_translation_unit(monkeypatch, tmp_path):
    cmds = _fake_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "bind_binned_search", lambda lib: lib)
    _, path = _build.load_binned_search()
    compiles = [c for c in cmds if "-c" in c]
    assert len(compiles) == 1 and len(cmds) == 2
    assert compiles[0][-1] == str(_build.BINNED_SEARCH_SRC)
    assert not any(a.startswith("-DMCRAT_FAMILY") for a in compiles[0])
    assert cmds[1][:2] == ["nvcc", "-shared"]
    assert path.startswith(str(tmp_path / "libbinned_search_"))
    assert _build.build(_build.BINNED_SEARCH_SRC, units=((),))["built"] is False


def test_carried_lookup_is_an_entry_of_the_search_library(monkeypatch, tmp_path):
    """The carried lookup is built into binned_search.cu's one translation
    unit and library (no further kernel library or loader), as its one
    kernel entry; the library's name follows the hydro-coordinate header it
    shares with the direct lookup, and its binding declares the entry."""
    src = _build.BINNED_SEARCH_SRC.read_text()
    entries = src[src.index('extern "C" {'):]
    assert re.findall(r"^\S.* (mcrat_\w+)\(", entries, flags=re.M) == [
        "mcrat_carried_lookup", "mcrat_binned_search_error_string"]
    assert src.count("__global__") == 1
    assert sorted(n for n in dir(_build) if n.startswith("load_")) == [
        "load_binned_search", "load_direct_lookup", "load_fused_round"]
    header = (_build.BINNED_SEARCH_SRC.parent / "hydro_coords.cuh").read_bytes()
    for path in (_build.BINNED_SEARCH_SRC, _build.DIRECT_LOOKUP_SRC):
        assert _build.source_bytes(path) == path.read_bytes() + header
    assert _build.source_bytes(_build.FUSED_ROUND_SRC) == _build.FUSED_ROUND_SRC.read_bytes()
    cmds = _fake_nvcc(monkeypatch, tmp_path)
    tag = hashlib.sha256(_build.source_bytes(_build.BINNED_SEARCH_SRC)
                         + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert _build.build(_build.BINNED_SEARCH_SRC, units=((),))["path"] == (
        tmp_path / f"libbinned_search_{tag}.so")
    assert len(cmds) == 2

    class Lib:
        class Fn:
            pass

        def __getattr__(self, name):
            fn = self.__dict__[name] = Lib.Fn()
            return fn

    lib = _build.bind_binned_search(Lib())
    assert len(lib.mcrat_carried_lookup.argtypes) == 36
    assert "mcrat_binned_search" not in vars(lib)


def test_build_leaves_the_fused_round_library_as_it_was(monkeypatch, tmp_path):
    """fused_round.cu: its six translation units and its library's name (a
    hash of the source and NVCC_FLAGS alone) as before."""
    cmds = _fake_nvcc(monkeypatch, tmp_path)
    info = _build.build()
    src = _build.FUSED_ROUND_SRC
    tag = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert info["path"] == tmp_path / f"libfused_round_{tag}.so"
    families = sorted(a for c in cmds for a in c if a.startswith("-DMCRAT_FAMILY="))
    assert families == [f"-DMCRAT_FAMILY={k}" for k in range(_build.N_FAMILIES)]
    assert len(cmds) == _build.N_FAMILIES + 2
