"""The spherical fireball cell of the benchmark (``sph2_fireball.frame``:
MCRaT's SPHERICAL_OUTFLOW on 384 log-r x 64 theta cells through
``packed_sph2`` and the direct lookup's searched radial axis) on the CPU,
the program's plain twin standing in for the kernel.

* The plain spherical reference (``benchmark/reference/sph2.py``) builds
  the program's packed cell table, looks positions up to the program's
  cells (exactly, in float64 and in float32, the searched axis included),
  and its round's fluid velocity and membership terms equal the twin's
  ``packed_sph2`` terms element by element.
* Its ``cell_holds`` accepts -1 only outside the domain, at its edge (the
  jet axis, where a float32 cos(theta) rounds to 1) or at a seam, and no
  cell but the photon's own.
* A whole small window (the harness's run, ~2,500 photons) is correct
  against the reference; each of ``benchmark/faults.py``'s faults and the
  bfloat16 control fail the comparison at ~10,000 photons.  There the
  ``altered`` fault's gain is 2: its 1.1 lifts the mean log lab energy by
  ln 1.1 on the ~half of the photons that scatter in a window, z 6.0 at
  9,544 photons, under the limit of 8 (~190 at the cell's ~9.5M photons on
  the card, where the benchmark's runs keep it at 1.1); at 2, z 42.

The windows run with 1,024-lane blocks (``s_rows`` 8) so that the twin's
work follows the photons.
"""
import functools
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, faults, harness, spec  # noqa: E402
from benchmark.reference import sph2  # noqa: E402
from mcrat_tpu_torch import grid, transport  # noqa: E402
from mcrat_tpu_torch.ops import fused_round as fr  # noqa: E402

torch.set_num_threads(1)

CELL = "sph2_fireball.frame"
SEED = 2**31 + 8191
TINY_MIX = dict(min_photons=1500, max_photons=3000, warmup_windows=1, trace_windows=1,
                sync_windows=1)
FAULT_MIX = dict(TINY_MIX, min_photons=8000, max_photons=16000)


@pytest.fixture(scope="module")
def case():
    """(spec, Config, host frame, edges) of the cell's configuration."""
    data, module = spec.config("sph2_fireball")
    cfg, host, edges = module.build_host(data)
    return data, cfg, host, edges


def positions(n, seed, dtype):
    """(n, 3) positions over the grid and a margin around it: log-uniform
    radii, theta uniform to past the domain's edge, a tenth of them within
    1e-3 rad of the jet axis, any azimuth."""
    rng = np.random.default_rng(seed)
    r = 10.0 ** rng.uniform(np.log10(0.9e12), np.log10(1e14), n)
    th = rng.uniform(0.0, 0.35, n)
    th[: n // 10] = rng.uniform(0.0, 1e-3, n // 10)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    pos = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1)
    return torch.as_tensor(pos, dtype=dtype)


def reference_inputs(data, host, edges):
    return sph2.inputs(data, host, edges, photons={})


def test_the_cell_runs_packed_sph2_on_a_searched_radial_axis(case):
    data, cfg, host, edges = case
    assert host.num_elements == 384 * 64
    index = grid.build_rectilinear_index(*edges, device="cpu")
    assert index.uniform[:2] == (False, True)
    assert sph2.build_index(edges, "cpu").uniform == (False, True)
    frame = host.to_device("cpu")
    assert transport.select_variant(cfg, frame, index).variant == data["instantiation"]
    # the configured outflow: coasting at Gamma_inf beyond r0 Gamma_inf
    assert np.allclose(host.gamma, 100.0) and np.all(host.v1 == 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cell_table_equals_the_programs(case, dtype):
    data, cfg, host, edges = case
    ref = sph2.build_frame(reference_inputs(data, host, edges), "cpu", dtype)
    prog = host.to_device("cpu", dtype=dtype)
    assert ref.source == "packed"
    assert torch.equal(ref.table, prog.packed)
    assert torch.equal(ref.domain, prog.domain)
    for k in ("r0", "r1", "dr0", "dr1"):
        assert torch.equal(getattr(ref, k), getattr(prog, k))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lookup_equals_the_programs(case, dtype):
    data, cfg, host, edges = case
    pos = positions(20000, 7, dtype)
    index = grid.build_rectilinear_index(*edges, dtype=dtype, device="cpu")
    prog_cell, prog_in = grid.find_cell_direct_reference(
        cfg, index, host.to_device("cpu", dtype=dtype), pos)
    ref_frame = sph2.build_frame(reference_inputs(data, host, edges), "cpu", dtype)
    ref_cell, ref_in = sph2.find_cell(sph2.build_index(edges, "cpu", dtype), ref_frame, pos)
    assert torch.equal(ref_cell, prog_cell) and torch.equal(ref_in, prog_in)
    # the positions reach every kind of answer: in the grid, outside it in r
    # and in theta, and on the axis, where float32 reads theta 0
    assert 0.3 < float(prog_in.double().mean()) < 0.9
    r = pos.double().norm(dim=1)
    axis = (pos[:, 2] / pos.norm(dim=1)) >= 1.0
    inside_r = (r > edges[0][0] * 1.001) & (r < edges[0][-1] * 0.999)
    if dtype == torch.float32:
        assert int((axis & inside_r & (prog_cell < 0)).sum()) > 10
    else:
        assert not bool((axis & inside_r).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fluid_and_membership_terms_equal_the_twins(case, dtype):
    data, cfg, host, edges = case
    frame = host.to_device("cpu", dtype=dtype)
    index = grid.build_rectilinear_index(*edges, dtype=dtype, device="cpu")
    start = positions(20000, 11, dtype)
    cell, _ = grid.find_cell_direct_reference(cfg, index, frame, start)
    cl = torch.clamp(cell.long(), 0, frame.num_elements - 1)
    # each position moved up to a cell's size, so that some leave their cell
    g = torch.Generator().manual_seed(3)
    moved = start * (1.0 + 0.02 * (torch.rand(start.shape, generator=g, dtype=dtype) - 0.5))
    px, py, pz = moved.unbind(1)
    twin = fr._Cell(fr.VARIANTS["packed_sph2"], frame.packed, cl,
                    transport.grid_scalars(frame, index))
    ref_frame = sph2.build_frame(reference_inputs(data, host, edges), "cpu", dtype)
    mine = sph2._Cell(ref_frame.table, cl, sph2.grid_scalars(ref_frame))
    for a, b in zip(mine.fluid_beta(px, py), twin.fluid_beta(px, py)):
        assert torch.equal(a, b)
    assert torch.equal(mine.beta_mag, twin.beta_mag) and torch.equal(mine.n_e, twin.n_e)
    assert torch.equal(mine.temp, twin.temp)
    inside = mine.contains(px, py, pz)
    if dtype == torch.float32:
        assert torch.equal(inside, twin.contains(px, py, pz))
    else:
        # the twin's domain cosines are float32 values; away from the theta
        # domain's edges the tests agree exactly
        th = torch.arccos(torch.clamp(pz / moved.norm(dim=1), -1.0, 1.0))
        away = (th - float(host.domain[1, 1])).abs() > 1e-6
        assert torch.equal(inside[away], twin.contains(px, py, pz)[away])
    assert 0.1 < float(inside.double().mean()) < 0.9
    assert float(mine.beta_mag.max()) == pytest.approx((1 - 1e-4) ** 0.5, rel=1e-6)


def test_cell_holds(case):
    data, cfg, host, edges = case
    inp = reference_inputs(data, host, edges)
    r_edges, t_edges = edges
    n1 = len(t_edges) - 1
    i, j = 200, 5
    rc, tc = 0.5 * (r_edges[i] + r_edges[i + 1]), 0.5 * (t_edges[j] + t_edges[j + 1])
    dth = t_edges[1] - t_edges[0]

    def at(r, th):
        return torch.tensor([[r * np.sin(th), 0.0, r * np.cos(th)]], dtype=torch.float64)

    def holds(pos, c):
        return bool(sph2.cell_holds(inp, pos, torch.tensor([c], dtype=torch.int32))[0])

    assert holds(at(rc, tc), i * n1 + j)
    assert not holds(at(rc, tc), i * n1 + j + 1)
    assert not holds(at(rc, tc), (i + 1) * n1 + j)
    assert not holds(at(rc, tc), -1)
    # within 1e-2 of the cell's size past its theta wall, and not beyond
    wall = t_edges[j + 1]
    assert holds(at(rc, wall + 0.004 * dth), i * n1 + j)
    assert not holds(at(rc, wall + 0.03 * dth), i * n1 + j)
    # -1 outside the domain and on the jet axis where float32 reads theta 0,
    # not further from it
    assert holds(at(r_edges[-1] * 1.01, tc), -1)
    assert holds(at(rc, 0.31416 * 1.01), -1)
    assert holds(at(rc, 3e-4), -1)
    assert not holds(at(rc, 2e-3), -1)
    # at a seam, in the rounding gap between two cells
    assert holds(at(rc, wall + 0.004 * dth), -1)


def small_windows():
    return mock.patch.object(transport, "transport_frame",
                             functools.partial(transport.transport_frame, s_rows=8))


def test_small_window_is_correct():
    with small_windows():
        out = harness.run(CELL, SEED, 0.05, False, device="cpu", mix_override=TINY_MIX)
    values = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is True and out["failed"] == 0, values
    assert values["windows_off_path"] == values["photons_off"] == values["scatter_count_off"] == 0
    assert set(out["metrics"]) == {"photon_frames_per_s", "frame_ms_p90", "peak_mem_gib",
                                   "setup_s"}


@pytest.fixture(scope="module")
def readings():
    """``benchmark/control.py``'s readings of one seed: the program, each
    fault and the bfloat16 control."""
    with small_windows(), mock.patch.object(faults, "ALTERED_GAIN", 2.0):
        return control.readings(CELL, SEED, True, device="cpu", mix_override=FAULT_MIX)


def fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in numbers if k in limits)


def test_sound_window_passes(readings):
    limits = spec.config("sph2_fireball")[0]["limits"]
    assert not fails(readings["program"], limits), readings["program"]
    assert readings["program"]["photons_off"] == 0


@pytest.mark.parametrize("name", [*faults.FAULTS, "control_bfloat16"])
def test_fault_fails_the_comparison(readings, name):
    limits = spec.config("sph2_fireball")[0]["limits"]
    assert fails(readings[name], limits), (name, readings[name])
    if name == "unchanged":
        assert readings[name]["photons_off"] == readings["photons"]


def test_reference_window_moves_every_photon_and_scatters_some(case):
    """The reference alone: no frame time left, every live photon moved,
    about half of them scattered, and its scatterings counted in the
    population."""
    data, cfg, host, edges = case
    arrays = spec.kind("frame_repeat").inject(host, data["injection"], TINY_MIX, SEED)
    inp = sph2.inputs(data, host, edges, arrays)
    out, t_rem = sph2.transport_window(inp, torch.Generator().manual_seed(5), "cpu")
    assert float(t_rem.abs().max()) == 0.0
    ds = out["num_scatt"].double() - torch.as_tensor(arrays["num_scatt"])
    assert 0.2 < float((ds > 0).double().mean()) < 0.9
    moved = (out["pos"].double() - torch.as_tensor(arrays["pos"])).norm(dim=1)
    assert bool((moved > 0).all())
    assert bool(sph2.cell_holds(inp, out["pos"], out["cell"]).all())
    assert out["p"].dtype == torch.float32
