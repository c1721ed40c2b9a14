"""The hot, nonthermal FLASH jet cell of the benchmark (``amr_table.frame``:
TABLE hot cross sections and power-law electrons on an AMR cell list,
through the aux planes and ``packed_cyl2+aux+nt``) on the CPU, the
program's plain twin standing in for the kernel.

* The program's aux planes (``transport.aux_planes``: the biased total
  before the fluid factor and the thermal probability) equal the plain
  reference's TABLE rate (``benchmark/reference/table.py``'s depths) at the
  lanes' comoving energies, and its sigma_hat and subgroup sigmas
  (``ops.hot_xsec.interp_thermal`` / ``interp_nonthermal``) equal the
  reference's (``reference/hot.py``): to 1e-12 in float64; in float32
  within ``F32_RTOL``, the rounding of the energy axis's float32 step,
  which moves the program's cell fraction by up to ~1.3e-3 of a cell at the
  table's top (the reference searches its float32 nodes and stays within
  ~1e-5 of float64).
* The cell's frame takes the carried branch with the aux tables and the
  nonthermal constants (``packed_cyl2``, ``KernelSetup.aux`` and ``.nt``).
* A whole tiny window (the harness's run, each refinement band cut to
  2 x 8 blocks, 3,072 cells, ~450 photons) is correct against
  ``reference/amr_table.py``; each of ``benchmark/faults.py``'s faults, the
  bfloat16 control and the program with its nonthermal electrons dropped
  (``tools/nt_dropped.py --cell amr_table.frame``) fail the comparison at
  ~1,000 photons, the ``altered`` fault's gain there 2 (as in
  ``test_torch_cyl2_nt.py``: its 1.1 moves the mean log lab energy by less
  than a few photons' spread resolves).
* ``transport.aux_lanes`` is the sum of the padded lanes of the kernel
  calls, counted only while tracing, and tracing on and off give the same
  photons bit for bit.

The hot tables are built once a module (~4 s on the CPU); the windows run
with 1,024-lane blocks (``s_rows`` 8).
"""
import contextlib
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
from benchmark.reference import frame as ref_frame  # noqa: E402
from benchmark.reference import hot  # noqa: E402
from benchmark.reference import rounds as ref_rounds  # noqa: E402
from benchmark.reference import table as ref_table  # noqa: E402
from mcrat_tpu_torch import grid, telemetry, transport  # noqa: E402
from mcrat_tpu_torch.ops import fused_round as fr  # noqa: E402
from mcrat_tpu_torch.ops import hot_xsec  # noqa: E402

torch.set_num_threads(1)

CELL = "amr_table.frame"
SEED = 2**31 + 4099
TINY_MIX = dict(min_photons=300, max_photons=600, warmup_windows=1, trace_windows=1,
                sync_windows=1)
FAULT_MIX = dict(TINY_MIX, min_photons=1000, max_photons=2000)
BLOCKS = (2, 8)  # blocks of each refinement band in the tiny frames
S_ROWS = 8
# float32 against float64 sigma: the program's fraction along the energy
# axis divides by the float32 step of the table's nodes, rounded by up to
# ~6e-6 of it, which at the table's top (~220 steps) moves the fraction by
# ~1.3e-3 of a cell and log10 sigma by up to ~1e-4 (measured: 1.8e-4 of
# sigma at eps' ~ 1e5)
F32_RTOL = 5e-4
nt_dropped = spec.load_module(ROOT / "tools" / "nt_dropped.py", "nt_dropped")


def config():
    return spec.config("amr_table")


@pytest.fixture(scope="module")
def program_tables():
    _, module = config()
    with nt_dropped.cells(1, 1):
        small, _ = spec.config("amr_table")
    cfg, _, _ = module.build_host(small)
    return hot_xsec.load_or_build(cfg, None, device="cpu")


@contextlib.contextmanager
def tiny(tables):
    """The cell on 2 x 8 blocks a band, the program's tables built once,
    windows on 1,024-lane blocks."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(nt_dropped.cells(*BLOCKS))
        stack.enter_context(mock.patch.object(hot_xsec, "load_or_build",
                                              lambda cfg, path, device=None: tables))
        stack.enter_context(mock.patch.object(
            transport, "transport_frame",
            functools.partial(transport.transport_frame, s_rows=S_ROWS)))
        yield


@pytest.fixture(scope="module")
def problem():
    """(the configuration, its module, the tiny host frame, its injected
    population's arrays)."""
    with nt_dropped.cells(*BLOCKS):
        data, module = spec.config("amr_table")
    cfg, host, edges = module.build_host(data)
    assert edges is None
    arrays = spec.kind("frame_repeat").inject(host, data["injection"], TINY_MIX, SEED)
    return data, module, cfg, host, arrays


def fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in numbers if k in limits)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_aux_planes_equal_the_references_rate(program_tables, problem, dtype):
    data, module, cfg, host, arrays = problem
    ref_tables = hot.build(hot.PowerLaw(data["powerlaw_index"], data["gamma_min"],
                                        data["gamma_max"], data["n_gamma"]), "cpu")
    g = torch.Generator().manual_seed(7)
    # the lanes' comoving energies, and a sweep over the table's decades
    lanes = torch.as_tensor(np.asarray(arrays["comv_p"])[:, 0], dtype=torch.float64)
    sweep = 10.0 ** (torch.rand(4000, generator=g, dtype=torch.float64) * 17.0 - 11.0)
    e = torch.cat([lanes, sweep]).to(dtype)
    cell = torch.randint(0, host.num_elements, (e.numel(),), generator=g)
    frame = host.to_device("cpu", dtype=dtype)
    aux = transport.aux_planes(cfg, program_tables, frame, cell.to(torch.int32), e)

    inp = module.reference.inputs(data, host, None, arrays)
    rframe = ref_frame.build_frame(inp, "cpu", dtype)
    rframe.table[ref_rounds.PCOL["nonthermal_dens"]] = torch.as_tensor(
        np.asarray(inp.cells["nonthermal_dens"]), dtype=dtype)
    rgrid = ref_frame.grid_scalars(rframe, ref_frame.build_bin_index(inp.cells, "cpu", dtype))
    rcell = module.reference._Cell(rframe.table, cell, rgrid)
    total, tau0, _ = ref_table._depths(ref_tables, rcell, e, torch.ones_like(e))

    rtol = 1e-12 if dtype == torch.float64 else F32_RTOL
    assert aux.dtype == dtype and aux.shape == (2, e.numel())
    torch.testing.assert_close(aux[0], total, rtol=rtol, atol=0.0)
    torch.testing.assert_close(aux[1], tau0 / total, rtol=rtol, atol=0.0)
    temp = frame.temp[cell]
    torch.testing.assert_close(hot_xsec.interp_thermal(program_tables, e, temp),
                               hot.sigma_thermal(ref_tables, e, rcell.theta), rtol=rtol, atol=0.0)
    torch.testing.assert_close(hot_xsec.interp_nonthermal(program_tables, e),
                               hot.sigma_subgroups(ref_tables, e), rtol=rtol, atol=0.0)


def test_the_cell_takes_the_carried_aux_nt_path(program_tables, problem):
    data, _, cfg, host, _ = problem
    index = grid.build_binned_index(host, device="cpu")
    setup = transport.select_variant(cfg, host.to_device("cpu"), index, program_tables)
    assert data["instantiation"] == "packed_cyl2+aux+nt"
    assert setup.variant == "packed_cyl2" and setup.aux is program_tables
    assert setup.nt is not None and setup.cheb_base == 0


def test_tiny_window_is_correct(program_tables):
    with tiny(program_tables):
        out = harness.run(CELL, SEED, 0.05, False, device="cpu", mix_override=TINY_MIX)
    values = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is True and out["failed"] == 0, values
    assert values["windows_off_path"] == values["photons_off"] == values["scatter_count_off"] == 0
    assert set(out["metrics"]) == {"photon_frames_per_s", "frame_ms_p90", "peak_mem_gib",
                                   "setup_s"}


@pytest.fixture(scope="module")
def readings(program_tables):
    """``benchmark/control.py``'s readings of one seed (the program, each
    fault, the bfloat16 control) and of the program with its nonthermal
    electrons dropped."""
    with tiny(program_tables), mock.patch.object(faults, "ALTERED_GAIN", 2.0):
        line = control.readings(CELL, SEED, True, device="cpu", mix_override=FAULT_MIX)
        with nt_dropped.nonthermal_dropped():
            line["nonthermal_dropped"] = control.readings(
                CELL, SEED, False, device="cpu", mix_override=FAULT_MIX)["program"]
    return line


def test_sound_window_passes(readings):
    limits = config()[0]["limits"]
    assert not fails(readings["program"], limits), readings["program"]
    assert readings["program"]["photons_off"] == 0


@pytest.mark.parametrize("name", [*faults.FAULTS, "control_bfloat16", "nonthermal_dropped"])
def test_fault_fails_the_comparison(readings, name):
    limits = config()[0]["limits"]
    assert fails(readings[name], limits), (name, readings[name])
    if name == "unchanged":
        assert readings[name]["photons_off"] == readings["photons"]


@pytest.fixture
def tracing():
    telemetry.reset()
    telemetry.enable(False)
    yield telemetry
    telemetry.enable(False)
    telemetry.reset()


def _window(program_tables, problem, seed, rounds_fn=fr.fused_rounds_reference):
    data, _, cfg, host, arrays = problem
    photons, _ = transport.photons_from_arrays(arrays, device="cpu")
    return transport.transport_frame(
        cfg, photons, host.to_device("cpu"), grid.build_binned_index(host, device="cpu"),
        data["frame_window_s"], torch.Generator().manual_seed(seed), stokes_on=data["stokes"],
        chunk_rounds=64, fused=True, s_rows=S_ROWS, rounds_fn=rounds_fn,
        xsec_table=program_tables)


def test_aux_lanes_count_the_padded_lanes_of_every_call(program_tables, problem, tracing):
    pads = []

    def spy(state, *args, aux=None, **kw):
        assert aux is not None and aux.shape == (2, state.shape[1])
        pads.append(state.shape[1])
        return fr.fused_rounds_reference(state, *args, aux=aux, **kw)

    _window(program_tables, problem, 3, spy)
    assert "transport.aux_lanes" not in telemetry.summary()["counters"]
    pads.clear()
    telemetry.enable()
    _window(program_tables, problem, 3, spy)
    summ = telemetry.summary()
    assert summ["frames"] == 1 and len(pads) > 1
    assert summ["counters"]["transport.aux_lanes"] == sum(pads)
    assert summ["counters"]["transport.kernel_calls"] == len(pads)
    assert summ["spans"]["transport.aux_planes"]["count"] == len(pads)


def test_result_bit_identical_with_tracing_on_and_off(program_tables, problem, tracing):
    off = _window(program_tables, problem, 11)
    telemetry.enable()
    on = _window(program_tables, problem, 11)
    assert telemetry.summary()["counters"]["transport.aux_lanes"] > 0
    assert (on.n_scatt, on.n_rounds, on.engine) == (off.n_scatt, off.n_rounds, off.engine)
    assert int(off.n_scatt) > 0
    assert torch.equal(on.t_rem, off.t_rem)
    for k, v in off.photons.fields().items():
        assert torch.equal(getattr(on.photons, k), v), k
