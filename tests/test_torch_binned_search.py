"""The carried AMR search kernel (``csrc/binned_search.cu``) against its plain
version, ``grid.BinnedIndex.find_reference``, cell for cell.

Tests marked ``card`` run the kernel and skip without a CUDA card; on one,
from the repository's root (this file imports no JAX, and the suite's
conftest does):

    python -m pytest -q -o addopts="" --noconftest -m card tests/test_torch_binned_search.py

Their cell lists are built by the port alone: the small three-level AMR
frame of test_torch_amr_cases, a 2-D spherical grid and a 3-D cartesian
grid taken as unstructured lists (test_torch_amr_index's three), two
overlapping layers of blocks (where the order in which the neighbour bins
are visited decides the cell), and fault F8's frame, a coarse block beside
blocks refined 32-fold (1,024 cells a bin, test_torch_f8_index).  Their lanes: uniform over the domain padded by 5 %, a
third on cell and block seams, and lanes at NaN, +-inf, far outside the
grid and on its outer bin edges.  The tests without the mark check, on the
CPU, that CPU tensors take the plain version and launch nothing, and how
the search's library is built.
"""
import hashlib

import numpy as np
import pytest
import torch

from mcrat_tpu_torch import Config, Dims, Geometry, SimType, _build
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch.io import flash as tflash
from mcrat_tpu_torch.models import analytic as tan
from mcrat_tpu_torch.ops import binned_search as bs

torch.set_num_threads(1)

KINDS = ["amr_cyl2", "sph2_cells", "cart3_cells", "overlap_cyl2"]
# the AMR frame's refinement bands (test_torch_amr_cases.BANDS) and F8's
AMR_BANDS = [(0.0, 1.28e11, 4, 16), (1.28e11, 2.56e11, 2, 8), (2.56e11, 3.2e11, 1, 4)]
F8_SIDE = 1e11
F8_BANDS = [(0.0, F8_SIDE, 1, 1), (F8_SIDE, 2 * F8_SIDE, 32, 32)]
R1 = (1.8e12, 2.9e12)
SPECIALS = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the search kernel runs only there")
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


def _host(kind):
    """(port host, per-axis seam coordinates) of a cell list."""
    if kind in ("amr_cyl2", "f8", "overlap_cyl2"):
        cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                     simulation_type=SimType.CYLINDRICAL_OUTFLOW)
        if kind == "f8":
            return _blocks(cfg, F8_BANDS), None
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
    cfg = Config(dims=Dims.THREE, geometry=Geometry.CARTESIAN,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW)
    edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 17),
             np.geomspace(1.8e12, 2.9e12, 33))
    c = np.meshgrid(*[0.5 * (e[:-1] + e[1:]) for e in edges], indexing="ij")
    d = np.meshgrid(*[np.diff(e) for e in edges], indexing="ij")
    n = c[0].size
    host = tgrid.frame_from_numpy(cfg, dict(
        r0=c[0].ravel(), r1=c[1].ravel(), r2=c[2].ravel(), dr0=d[0].ravel(), dr1=d[1].ravel(),
        dr2=d[2].ravel(), v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n), dens=np.ones(n),
        pres=np.ones(n)))
    return tan.apply_simulation_type(host), edges


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


def _both(index, frame, cols, dtype, device):
    """(kernel cells, plain version's cells) of lanes ``cols`` as ``dtype``
    on ``device``."""
    r = [torch.as_tensor(c, dtype=dtype, device=device) for c in cols]
    return index.find(*r, frame), index.find_reference(*r, frame)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_bit_identical_to_plain_version(kind, dtype, card):
    host, seams = _host(kind)
    index = tgrid.build_binned_index(host, device=card)
    cols = _lanes(host, index, seams)
    for frame_dtype in (torch.float32, torch.float64):
        frame = host.to_device(card, dtype=frame_dtype)
        got, want = _both(index, frame, cols, dtype, card)
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got, want), (frame_dtype, int((got != want).sum()))
        assert (want >= 0).float().mean() > 0.5 and (want < 0).any()
        # NaN lanes find no cell
        nan = torch.as_tensor(np.isnan(cols[0]), device=card)
        assert (got[nan] == -1).all()


@pytest.mark.card
def test_kernel_finds_every_cell_of_f8_frame(card):
    """Every cell centre of the cell-ratio-32 frame, 1,024 cells a bin."""
    host, _ = _host("f8")
    index = tgrid.build_binned_index(host, device=card)
    assert index.max_slab == 1024
    cols = [host.r0, host.r1, np.zeros(host.num_elements)]
    got, want = _both(index, host.to_device(card), cols, torch.float32, card)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), torch.arange(host.num_elements, dtype=torch.int32))


@pytest.mark.card
def test_kernel_one_launch_no_sync(card):
    """One launch a call, none for an empty lane set, no host sync (torch's
    sync debug mode raises on one), and the lanes counted."""
    from mcrat_tpu_torch import telemetry

    host, seams = _host("amr_cyl2")
    index = tgrid.build_binned_index(host, device=card)
    frame = host.to_device(card)
    r = [torch.as_tensor(c, dtype=torch.float32, device=card)
         for c in _lanes(host, index, seams)]
    index.find(*r, frame)  # builds the library and the tables
    torch.cuda.synchronize()
    before = bs.binned_search.launches
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.frame("transport.frame", card):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = index.find(*r, frame)
                empty = index.find(*(x[:0] for x in r), frame)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counters = telemetry.summary()["counters"]
    finally:
        telemetry.enable(False)
        telemetry.reset()
    assert bs.binned_search.launches == before + 1
    assert empty.shape == (0,) and empty.dtype == torch.int32
    assert counters.get("grid.search_kernel_lanes") == r[0].numel()
    assert torch.equal(got, index.find_reference(*r, frame))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors run find_reference and never reach the kernel's wrapper."""
    host, seams = _host("amr_cyl2")
    index = tgrid.build_binned_index(host, device="cpu")
    frame = host.to_device("cpu")
    r = [torch.as_tensor(c, dtype=torch.float32) for c in _lanes(host, index, seams, n=600)]

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(tgrid, "binned_search", no_kernel)
    before = bs.binned_search.launches
    got = index.find(*r, frame)
    assert torch.equal(got, index.find_reference(*r, frame))
    assert bs.binned_search.launches == before and index._tables is None
    with pytest.raises(ValueError, match="cuda"):
        bs.binned_search(index, *r, frame)


def test_search_tables_are_the_bin_ordered_geometry():
    """The kernel's tables: the geometry rows in bin order, in the dtype the
    plain version tests in, built once for a frame and dtype."""
    for kind in ("amr_cyl2", "cart3_cells"):
        host, _ = _host(kind)
        index = tgrid.build_binned_index(host, device="cpu")
        frame = host.to_device("cpu")
        rows, lo, inv = index.search_tables(frame, torch.float32)
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
        rows64, lo64, _ = index.search_tables(frame, torch.float64)
        assert rows64.dtype == torch.float64 and lo64.dtype == torch.float64
        frame64 = host.to_device("cpu", dtype=torch.float64)
        assert index.search_tables(frame64, torch.float32)[0].dtype == torch.float64


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
