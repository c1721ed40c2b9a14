"""The rectilinear direct lookup kernel (``csrc/direct_lookup.cu``) against
its plain version, ``grid.find_cell_direct_reference``, cell for cell.

Tests marked ``card`` run the kernel and skip without a CUDA card; on one,
from the repository's root (this file imports no JAX, and the suite's
conftest does):

    python -m pytest -q -o addopts="" --noconftest -m card tests/test_torch_direct_lookup.py

Their grids are built by the port alone: one small rectilinear grid for
every (dims x geometry) that ``geometry.mcrat_to_hydro`` takes, with uniform
axes or with non-uniform ones (log-spaced radii, a stretched axis), indexed
and framed in float32 and in float64.  Their lanes: uniform over the domain
padded by 5 %, a sixth with one hydro coordinate on a cell edge, lanes on
the domain's bounds, and lanes with a Cartesian component at NaN, +-inf or
+-1e30.  The tests without the mark check, on the CPU, that CPU tensors
take the plain version and launch nothing, the kernel's tables, the
geometries it takes, and how its library is built.
"""
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcrat_tpu_torch import Config, Dims, Geometry, Spectrum, _build, telemetry
from mcrat_tpu_torch import geometry as geo
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.models.analytic import cylindrical_prep
from mcrat_tpu_torch.ops import direct_lookup as dl
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)

# every (dims x geometry) mcrat_to_hydro takes
CASES = [(Dims.TWO, Geometry.CARTESIAN), (Dims.TWO, Geometry.CYLINDRICAL),
         (Dims.TWO, Geometry.SPHERICAL), (Dims.TWO_POINT_FIVE, Geometry.CARTESIAN),
         (Dims.TWO_POINT_FIVE, Geometry.CYLINDRICAL), (Dims.TWO_POINT_FIVE, Geometry.SPHERICAL),
         (Dims.THREE, Geometry.CARTESIAN), (Dims.THREE, Geometry.SPHERICAL),
         (Dims.THREE, Geometry.POLAR)]
IDS = [f"{d.name}-{g.name}" for d, g in CASES]
SPECIALS = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the direct lookup kernel runs only there")
    return torch.device("cuda")


def _axis(lo, hi, n, uniform, log=False):
    if uniform:
        return np.linspace(lo, hi, n + 1)
    if log:
        return np.geomspace(lo, hi, n + 1)
    return lo + (hi - lo) * (np.arange(n + 1) / n) ** 1.5


def _edges(dims, geometry, uniform):
    """Cell edges of each hydro axis (2 or 3) of a small grid."""
    if dims is Dims.THREE:
        if geometry is Geometry.CARTESIAN:
            return (_axis(-4e11, 4e11, 12, uniform), _axis(-4e11, 4e11, 10, True),
                    _axis(1.8e12, 2.9e12, 14, uniform, log=True))
        if geometry is Geometry.SPHERICAL:
            return (_axis(5e11, 4e12, 12, uniform, log=True), _axis(0.0, np.pi, 9, uniform),
                    _axis(0.0, 2 * np.pi, 10, True))
        return (_axis(1e10, 4e11, 12, uniform, log=True), _axis(0.0, 2 * np.pi, 10, True),
                _axis(1.8e12, 2.9e12, 9, uniform))
    if geometry is Geometry.SPHERICAL:
        return (_axis(5e11, 4e12, 40, uniform, log=True), _axis(0.0, np.pi / 2, 16, uniform))
    return _axis(0.0, 3.2e11, 24, uniform), _axis(1.8e12, 2.9e12, 48, uniform, log=True)


def _host(dims, geometry, uniform):
    """(config, host frame, edges) of a grid whose cells are the C-order
    meshgrid of its edges, the index's flat order."""
    cfg = Config(dims=dims, geometry=geometry)
    edges = _edges(dims, geometry, uniform)
    mids = np.meshgrid(*[0.5 * (e[:-1] + e[1:]) for e in edges], indexing="ij")
    sizes = np.meshgrid(*[np.diff(e) for e in edges], indexing="ij")
    n = mids[0].size
    arrays = dict(v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n), dens=np.ones(n),
                  pres=np.ones(n))
    for a in range(len(edges)):
        arrays[f"r{a}"], arrays[f"dr{a}"] = mids[a].ravel(), sizes[a].ravel()
    return cfg, tgrid.frame_from_numpy(cfg, arrays), edges


def _lanes(cfg, host, edges, n=12000, seed=11):
    """(N, 3) float64 MCRaT positions: hydro coordinates uniform over the
    domain padded by 5 %, a sixth of them with one coordinate on a cell edge
    (on the azimuth 0 in 2-D, so that the radius comes back exact), 200 on
    the domain's bounds, then 400 with a Cartesian component at NaN, +-inf
    or +-1e30."""
    rs = np.random.default_rng(seed)
    three_d = cfg.dims is Dims.THREE
    r = []
    for axis in range(3):
        lo, hi = host.domain[axis]
        pad = 0.05 * (hi - lo)
        col = rs.uniform(lo - pad, hi + pad, n)
        if axis < len(edges):
            sl = slice(axis * n // 6, (axis + 1) * n // 6)
            col[sl] = rs.choice(edges[axis], sl.stop - sl.start)
            col[-200:] = rs.choice([lo, hi], 200)
        elif not three_d:
            col = rs.uniform(0.0, 2 * np.pi, n)  # the azimuth
            col[: len(edges) * n // 6] = 0.0
        r.append(col)
    pos = np.stack(geo.hydro_to_mcrat(cfg, *r), axis=1)
    bad = pos[rs.integers(0, n, 400)]
    bad[np.arange(400), rs.integers(0, 3, 400)] = rs.choice(SPECIALS, 400)
    return np.concatenate([pos, bad])


def _problem(dims, geometry, uniform, grid_dtype, device):
    cfg, host, edges = _host(dims, geometry, uniform)
    index = tgrid.build_rectilinear_index(*edges, dtype=grid_dtype, device=device)
    return cfg, host.to_device(device, dtype=grid_dtype), index, _lanes(cfg, host, edges)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_bit_identical_to_plain_version(case, uniform, dtype, card):
    """Cells and in-grid flags of the kernel and of the plain version on the
    card, for an index and frame in float32 and in float64."""
    for grid_dtype in (torch.float32, torch.float64):
        cfg, frame, index, lanes = _problem(*case, uniform, grid_dtype, card)
        assert index.uniform[0] == uniform
        pos = torch.as_tensor(lanes, dtype=dtype, device=card)
        cell, in_grid = tgrid.find_cell_direct(cfg, index, frame, pos)
        want_cell, want_in = tgrid.find_cell_direct_reference(cfg, index, frame, pos)
        assert cell.dtype == torch.int32 and in_grid.dtype == torch.bool
        assert torch.equal(cell, want_cell), (grid_dtype, int((cell != want_cell).sum()))
        assert torch.equal(in_grid, want_in)
        assert 0.4 < want_in.float().mean() < 0.95


@pytest.mark.card
@pytest.mark.parametrize("case", [CASES[1], CASES[7]], ids=[IDS[1], IDS[7]])
def test_lane_inputs_equal_clamp_and_lane_flags(case, card):
    """The second entry on the kernel's (16, Npad) state planes: cells, the
    clamp and the FLAG_* word equal to find_cell_direct_reference, clamp
    and lane_flags."""
    cfg, frame, index, lanes = _problem(*case, False, torch.float32, card)
    n = lanes.shape[0]
    state = torch.zeros((fr.N_STATE, n), dtype=torch.float32, device=card)
    state[fr.SP_X: fr.SP_Z + 1] = torch.as_tensor(lanes.T, dtype=torch.float32, device=card)
    pos = state[fr.SP_X: fr.SP_Z + 1].T
    rs = np.random.default_rng(5)
    alive, pool = (torch.as_tensor(rs.random(n) < 0.8, device=card) for _ in range(2))
    cell, safe, flags = tt.direct_lane_inputs(cfg, index, frame, pos, alive, pool)
    want_cell, want_in = tgrid.find_cell_direct_reference(cfg, index, frame, pos)
    assert torch.equal(cell, want_cell)
    assert torch.equal(safe, torch.clamp(want_cell, 0, frame.num_elements - 1).to(torch.int32))
    assert torch.equal(flags, tt.lane_flags(alive, pool, want_in))
    assert {cell.dtype, safe.dtype, flags.dtype} == {torch.int32}


@pytest.mark.card
def test_one_launch_no_sync_and_counters(card):
    """One launch a call, none for an empty lane set, no host sync (torch's
    sync debug mode raises on one), and the lanes counted: every lane of
    the direct branch through the kernel."""
    cfg, frame, index, lanes = _problem(Dims.TWO, Geometry.CYLINDRICAL, True, torch.float32,
                                        card)
    pos = torch.as_tensor(lanes, dtype=torch.float32, device=card)
    alive = torch.ones(pos.shape[0], dtype=torch.bool, device=card)
    tgrid.find_cell_direct(cfg, index, frame, pos)  # builds the library and the tables
    torch.cuda.synchronize()
    before = dl.direct_lookup.launches
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.frame("transport.frame", card):
            torch.cuda.set_sync_debug_mode("error")
            try:
                cell, _ = tgrid.find_cell_direct(cfg, index, frame, pos)
                empty, empty_in = tgrid.find_cell_direct(cfg, index, frame, pos[:0])
                tt.direct_lane_inputs(cfg, index, frame, pos, alive, alive)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counters = telemetry.summary()["counters"]
    finally:
        telemetry.enable(False)
        telemetry.reset()
    assert dl.direct_lookup.launches == before + 2
    assert empty.shape == (0,) and empty.dtype == torch.int32 and empty_in.dtype == torch.bool
    assert counters["grid.lookup_lanes"] == 2 * len(pos)
    assert torch.equal(cell, tgrid.find_cell_direct_reference(cfg, index, frame, pos)[0])


@pytest.mark.card
def test_direct_branch_frame_unchanged_by_the_kernel(card, monkeypatch):
    """transport_rounds_fused's direct branch (through the round's plain
    twin) gives the same lanes with the kernel's lookups as with the plain
    version's, and every lookup goes through the kernel."""
    cfg, host, edges = _host(Dims.TWO, Geometry.CYLINDRICAL, True)
    cylindrical_prep(host)
    frame = host.to_device(card)
    index = tgrid.build_rectilinear_index(*edges, device=card)
    arrays, _ = tt.inject_photons(host, 2e12, 1e50, 1500, 3000, Spectrum.BLACKBODY, 0.0,
                                  0.1047, 5.0, np.random.default_rng(3))
    photons, _ = tt.photons_from_arrays(arrays, device=card)
    t_rem = tt.frame_time(photons, 0.2)
    setup = tt.select_variant(cfg, frame, index)

    def run():
        return tt.transport_rounds_fused(cfg, photons, frame, index, t_rem, 7, setup,
                                         max_rounds=8, s_rows=8,
                                         rounds_fn=fr.fused_rounds_reference)

    before = dl.direct_lookup.launches
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.frame("transport.frame", card):
            got = run()
        spans = telemetry.summary()["spans"]
    finally:
        telemetry.enable(False)
        telemetry.reset()
    assert dl.direct_lookup.launches - before == spans["grid.lookup"]["count"] > 0

    def plain(cfg, index, frame, pos, alive, pool):
        cell, in_grid = tgrid.find_cell_direct_reference(cfg, index, frame, pos)
        return cell, torch.clamp(cell, 0, frame.num_elements - 1).to(torch.int32), \
            tt.lane_flags(alive, pool, in_grid)

    monkeypatch.setattr(tt, "direct_lane_inputs", plain)
    monkeypatch.setattr(tt, "find_cell_direct", tgrid.find_cell_direct_reference)
    want = run()
    for name, value in want.photons.fields().items():
        assert torch.equal(getattr(got.photons, name), value), name
    assert torch.equal(got.t_rem, want.t_rem) and got.n_rounds == want.n_rounds


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors run the plain version and never reach the kernel's
    wrapper; the lookups are counted, none launched."""
    cfg, frame, index, lanes = _problem(Dims.TWO, Geometry.CYLINDRICAL, True, torch.float32,
                                        "cpu")
    pos = torch.as_tensor(lanes, dtype=torch.float32)
    alive = torch.ones(len(pos), dtype=torch.bool)
    pool = torch.zeros(len(pos), dtype=torch.bool)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(tgrid, "direct_lookup", no_kernel)
    monkeypatch.setattr(tgrid, "direct_lookup_flags", no_kernel)
    before = dl.direct_lookup.launches
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.frame("transport.frame", torch.device("cpu")):
            cell, in_grid = tgrid.find_cell_direct(cfg, index, frame, pos)
            got = tt.direct_lane_inputs(cfg, index, frame, pos, alive, pool)
        counters = telemetry.summary()["counters"]
    finally:
        telemetry.enable(False)
        telemetry.reset()
    want_cell, want_in = tgrid.find_cell_direct_reference(cfg, index, frame, pos)
    assert torch.equal(cell, want_cell) and torch.equal(in_grid, want_in)
    assert torch.equal(got[0], want_cell)
    assert torch.equal(got[1], torch.clamp(want_cell, 0, frame.num_elements - 1))
    assert torch.equal(got[2], tt.lane_flags(alive, pool, want_in))
    assert counters["grid.lookup_lanes"] == 2 * len(pos)
    assert dl.direct_lookup.launches == before and index._tables is None
    with pytest.raises(ValueError, match="cuda"):
        dl.direct_lookup(cfg, index, frame, pos)
    with pytest.raises(ValueError, match="cuda"):
        dl.direct_lookup_flags(cfg, index, frame, pos, alive, pool, (1, 2, 4))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_takes_the_geometries_of_mcrat_to_hydro(case):
    """The kernel's geometry code: 2-D and 2.5-D cartesian and cylindrical
    share one (the same transform), every other case its own; a case that
    mcrat_to_hydro refuses the wrapper refuses too."""
    dims, geometry = case
    codes = ({Geometry.CARTESIAN: 2, Geometry.SPHERICAL: 3, Geometry.POLAR: 4}
             if dims is Dims.THREE else
             {Geometry.CARTESIAN: 0, Geometry.CYLINDRICAL: 0, Geometry.SPHERICAL: 1})
    assert dl._geometry_code(Config(dims=dims, geometry=geometry)) == codes[geometry]
    # a case Config itself refuses, as the lookup sees it
    cfg = SimpleNamespace(dims=dims, geometry=(
        Geometry.CYLINDRICAL if dims is Dims.THREE else Geometry.POLAR))
    with pytest.raises(ValueError):
        geo.mcrat_to_hydro(cfg, *torch.zeros(3, 4))
    with pytest.raises(ValueError):
        dl._geometry_code(cfg)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
def test_lookup_tables(uniform):
    """The kernel's tables: the domain, lo, inv_d and outer edges in the
    lanes' dtype, the edges in searchsorted's promoted dtype, built once for
    a frame and dtype and anew after an in-place write to the domain."""
    cfg, frame, index, _ = _problem(Dims.THREE, Geometry.SPHERICAL, uniform, torch.float64,
                                    "cpu")
    params, edges = index.lookup_tables(frame, torch.float32)
    assert params.dtype == torch.float32 and params.shape == (18,)
    ends = [v for e in (index.edges0, index.edges1, index.edges2) for v in (e[0], e[-1])]
    want = torch.cat([frame.domain.reshape(-1), index.lo, index.inv_d, torch.stack(ends)])
    assert torch.equal(params, want.to(torch.float32))
    assert all(e.dtype == torch.float64 for e in edges)
    assert torch.equal(edges[0], index.edges0) and torch.equal(edges[2], index.edges2)
    assert index.lookup_tables(frame, torch.float32)[0] is params
    assert index.lookup_tables(frame, torch.float64)[0].dtype == torch.float64
    frame.domain[0, 0] += 1.0
    again = index.lookup_tables(frame, torch.float64)[0]
    assert again[0] == frame.domain[0, 0]
    index32 = tgrid.build_rectilinear_index(index.edges0.numpy(), index.edges1.numpy(),
                                            device="cpu")
    assert index32.lookup_tables(frame, torch.float32)[1][0].dtype == torch.float32
    assert index32.lookup_tables(frame, torch.float64)[1][0].dtype == torch.float64


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


def test_build_gives_the_lookup_one_translation_unit(monkeypatch, tmp_path):
    cmds = _fake_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "bind_direct_lookup", lambda lib: lib)
    _, path = _build.load_direct_lookup()
    compiles = [c for c in cmds if "-c" in c]
    assert len(compiles) == 1 and len(cmds) == 2
    assert compiles[0][-1] == str(_build.DIRECT_LOOKUP_SRC)
    assert "--fmad=false" in compiles[0]
    assert not any(a.startswith("-DMCRAT_FAMILY") for a in compiles[0])
    assert cmds[1][:2] == ["nvcc", "-shared"]
    assert path.startswith(str(tmp_path / "libdirect_lookup_"))
    assert _build.build(_build.DIRECT_LOOKUP_SRC, units=((),))["built"] is False


def test_lookup_library_leaves_the_fused_round_library_as_it_was(monkeypatch, tmp_path):
    """With the lookup's library built beside it, fused_round.cu keeps its
    six translation units and its library's name (a hash of its source and
    NVCC_FLAGS alone)."""
    cmds = _fake_nvcc(monkeypatch, tmp_path)
    _build.build(_build.DIRECT_LOOKUP_SRC, units=((),))
    info = _build.build()
    src = _build.FUSED_ROUND_SRC
    tag = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert info["path"] == tmp_path / f"libfused_round_{tag}.so"
    families = sorted(a for c in cmds for a in c if a.startswith("-DMCRAT_FAMILY="))
    assert families == [f"-DMCRAT_FAMILY={k}" for k in range(_build.N_FAMILIES)]
    assert len(cmds) == 2 + _build.N_FAMILIES + 2
    assert {p.name for p in tmp_path.glob("*.so")} == {
        f"libfused_round_{tag}.so", _build.build(_build.DIRECT_LOOKUP_SRC, units=((),))[
            "path"].name}
