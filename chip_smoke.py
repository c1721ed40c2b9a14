#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcrat_tpu_torch) on one NVIDIA GPU.

Drives the port's paths -- inject_photons -> photons_from_arrays ->
transport_frame, float32, through the hand-written CUDA fused-round kernel
(86 instantiations: 11 geometry variants x DIRECT / TABLE, the 7 packed
variants with nonthermal electrons, and the 7 packed variants with aux planes
(K5, the carried AMR path), thermal and nonthermal, each with Stokes on and
off) -- and checks them:

  0. device: nvidia-smi name/power limit, torch, CUDA and nvcc versions;
     exits non-zero without a CUDA device;
  1. build: compiles csrc/fused_round.cu as six translation units by
     concurrent nvcc processes (wall time); each instantiation's block,
     registers, local memory and shared memory as the loaded library
     reports them, its block and layout held to fused_round.cuda_block and
     layout_floats; the hot cross-section tables
     built (or loaded) into
     build/xsec/, timed;
     the kernel's Klein-Nishina cross section against float64 (fault F6);
  2. kernel vs its plain twin on the card, for every instantiation, on real
     lanes of a frame that selects it, timed: DIRECT on the flagship (plus a
     hot 5e8 K frame with one idle block), the 2-D spherical main grid
     (packed_sph2) and the same grid with linear radii (ultra_sph2), the
     flagship grid with geomspace z edges (slim_cyl2) and with a phi-hat
     velocity (packed_cyl2), 2.5-D cylindrical and spherical frames
     (packed_cyl25, packed_sph25), the bench 3-D cartesian frame
     (ultra_cart3) and the same with geomspace z edges (packed_cart3), 3-D
     spherical 128x32x32 (packed_sph3) and 3-D polar 64x32x128 (packed_pol3)
     frames; TABLE on the same eleven frames with cell temperatures spread
     over 1e5-5e9 K (cells below theta = 1e-4 take the Chebyshev rows'
     Klein-Nishina branch); nonthermal (bench.py's power law) on the seven
     frames of packed variants, a broken power law on the spherical grid, and
     the phi-velocity flagship grid with every third cell free of thermal
     electrons (the subgroup-1 fallback); then the TABLE and nonthermal main
     paths' own frames (5. and 6.), Stokes on and off (the DIRECT main
     paths' frames are those of the flagship and spherical cases above);
     aux planes (K5: TABLE and the power law through a BinnedIndex over the
     cells, TABLE spread temperatures) on the seven frames of packed
     variants; then the three AMR main paths' own frames (6b.).
     Then the kernel's block-local scatter queue at its edges (edge_call),
     on the lead instantiations' main frames (packed_cyl2+cheb+nt,
     packed_cyl2+aux+nt) and the flagship's (ultra_cyl2), Stokes on and
     off: CUDA blocks with 0, 1, 31, 32, 33, all and 100 of their lanes
     accepted in round 0 (pool lanes among the last), a block whose lanes
     all stall in round 0, an idle logical block between active ones.
     NS, out-flags and every state plane must be identical.  Each timed
     instantiation (device time of each launch alone, CUDA events, kernel_ms)
     gets its bound (bound()): the largest of the bytes one call must move
     over 3.35 TB/s and its work on each pipe (counted from the kernel
     source, at the twin's tally of this call's rounds, attempts, draws and
     rejection trials; the math functions at their instructions,
     tools/sass_counts.py): float32 over 67 TFLOP/s, the counter hash over
     the INT32 rate, MUFU instructions over the SFU rate, the double KN form
     over the FP64 rate; and the twin's warp tally (warps a branch runs with
     one thread a lane, and packed);
  3. the flagship path -- the 2-D cylindrical Gamma=100 outflow, 160x512
     uniform grid, ~1M photons, 64-round chunks with compaction: one warm-up
     + median of 3 transport_frame runs, with the kernel's launch count (the
     twin's must stay 0) and the frame checks, then the same frame through
     the twin on the card, timed once, every photon of it identical to the
     kernel's frame of the same seed, and once with Stokes off;
  4. the 2-D spherical main path -- the JAX driver's default synthetic grid
     (384 log-spaced radii x 64 theta cells), spherical outflow, ~1M photons,
     fps = 1: the same as 3.;
  5. the TABLE main path -- bench.py:265-276, the flagship grid at T' = 5e8 K
     with TABLE hot cross sections, default_rng(2): the same as 3.;
  6. the nonthermal main path -- bench.py:278-294, the same with a power law
     p = 2.5, gamma 1-100, 3 subgroups, nonthermal density from the
     equipartition B field, default_rng(3): the same as 3.;
  6b. the three AMR main paths -- the flagship outflow and domain on FLASH
     leaf blocks of 8x8 cells on three refinement levels (dr0 = 1e9 cm for
     r0 < 1.28e11, the flagship's 2e9 cm to 2.56e11, 4e9 cm beyond;
     167,936 cells), built in memory by io.flash.cells_from_blocks and
     indexed by a BinnedIndex (the carried path): amr_cyl2 (DIRECT,
     default_rng(0)), amr_cyl2 (aux) (T' = 5e8 K, TABLE, default_rng(2))
     and amr_cyl2 (aux_nt) (+ the power law, default_rng(3)): the same as
     3.; before them the AMR frame's cell lookup (find_cell_rows, the index
     search and the cached-cell pin) on the card against the same lookup on
     the CPU, on the injected photons, 2^20 random points and points on
     block seams and level boundaries; then the carried search's kernel
     (csrc/binned_search.cu) against its plain version on the card at the
     benchmark's amr_jet size (167,936 cells, ~237k lanes moved off their
     cells), cell for cell, with the kernel's device ms a call and the plain
     version's ms at the same shapes (binned_search_check); after them
     amr_cyl2's mean energy, mean scatterings and mean Q against the
     flagship's, within 4 sigma (the same uniform outflow), and the search
     kernel's launches on amr_cyl2's main path; then the direct lookup
     kernel (csrc/direct_lookup.cu) against its plain version on the
     flagship's and the 2-D spherical main frames (~1M injected photons
     moved by up to 4e9 cm), cells, in-grid flags, clamp and lane flags,
     with the kernel's device ms a call and the plain version's ms
     (direct_lookup_check), and the kernel's launches on the flagship's main
     path;
  7. every other frame of 2. once through the kernel with Stokes on and once
     with Stokes off, with the frame checks (the aux cases through
     transport_frame on their BinnedIndex: the carried path on every
     geometry);
  8. the driver's main path (driver_phase): ``mcrat_tpu_torch.cli run`` of
     the 2-D spherical outflow on the driver's default synthetic grid (the
     frame of 4.), ~1M photons injected at frames 0 and 1, frames 0-4, npz
     dumps, merged; per frame its photons, scatterings, rounds, transport
     and persistence-wait wall and the writer's fetch, checkpoint and dump
     seconds (the driver's ``frame_timing`` records), the run's wall and
     peak device memory, and its launches (packed_sph2 alone); checks:
     frames 0-4 dumped, each merged frame the photons and weight of the
     injections that reach it, frame 0 bit for bit a hand-sequenced inject
     + transport_frame, a run resumed from the .old checkpoint a crash after
     frame 2 leaves equal to the main run's first injection bit for bit on
     frames 0-4, ``cli status`` every rank done; ``analysis`` peak energy
     and polarization of frame 4;
  8b. the cyclo-synchrotron driver (cs_phase): ``cli run --cyclosynchrotron``
     of bench.py:414-438's configuration (the cylindrical outflow on the
     default synthetic grid at 256 x 48, TOTAL_E field, eps_B 0.5, comv off,
     fps 1, injection at frame 10, frames 10-12, 150k-400k photons, 256-round
     chunks, npz, merged), each frame's counts (pool photons emitted,
     promoted and replaced, merged, absorbed) and seconds (transport,
     emission, rebin, absorption, persistence wait), the run's wall, peak
     device memory and launches (packed_sph2 alone, the twin's 0); then two
     forced-rebin runs, each resumed from frame 10's checkpoint with its
     photons marked scattered-CS and max_photons lowered, once through the
     kernel and once through the twin: the main run's configuration
     (frame 10 equal to the main run's bit for bit; frame 11's end-of-frame
     rebin of ~150k scattered-CS photons timed through the kernel without
     the checks) and tests/test_cyclosynch.py:258-270's (the mid-frame rebin
     too): dumps identical bit for bit between kernel and twin, the rebins
     fired, weight conserved across each rebin, no photon that a rebin
     merged absorbed above nu_c (F10), no pool photon in any dump;
  8c. the XLA engine and the readers: (a) the flagship frame of 3. through
     the XLA engine on the card (no kernel or twin launch), in float64
     (``transport_frame(fused=None)`` on a float64 population of the same
     injection) and in float32 (``fused=False``), each held against the
     kernel frame of 3. (mean energy, scatterings a photon, scattered
     fraction, mean Q and U within 5 standard errors), with its wall,
     rounds, ms a round, device-to-host syncs (torch's sync debug mode) and
     peak device memory (xla_frames); (b) ``cli run --dtype float64 --output
     npz --merge`` of the driver phase's configuration at 100k-200k photons,
     frames 0-2: counts, finite fields, weight conserved, and a resume from
     the ``.old`` checkpoint a crash after frame 1 leaves bit for bit the
     uninterrupted run (xla_driver); (c) PLUTO .dbl and RIKEN 2-D frame
     sets that chip_smoke writes with numpy (the flagship outflow on its
     160x512 grid, the 2-D spherical main frame) into build/readers/,
     through ``cli run --sim pluto`` / ``--sim riken`` at ~1M photons, two
     frames: the kernel instantiation of the readers' cell list alone, the
     twin 0; the same run once more through the twin on the card, its npz
     dumps equal to the kernel run's bit for bit; frame 0 held against the
     synthetic main path of the same outflow within 4 sigma (reader_phase);
  8d. the photon axis over a mesh (mesh_phase, into build/mesh_run/): (a)
     the flagship frame of 3. on a two-shard mesh of the card (the card
     twice), 64-round chunks with compaction: the kernel launched on both
     shards (``Mesh.launches``) and nothing else, the same call through the
     twin bit for bit with the twin alone launching, weight conserved,
     within 5 standard errors of the one-device kernel frame of 3. (mean
     energy, scatterings, scattered fraction, Q, U); a one-shard mesh bit
     for bit ``transport_frame`` (mesh_frames); (b) ``cli run --mesh 1
     --coordinator 127.0.0.1:<port> --num-hosts 1 --host-id 0`` of the
     driver phase's configuration, frames 0-2 (NCCL at world size 1): its
     dumps bit for bit the plain ``cli run``'s of the same frames
     (mesh_cli); (c) two processes on the card (gloo, one shard each, a
     worker script, ``driver.run_rank(mesh=)``) on the driver phase's frame
     with one injection, frames 0-2, npz: an uninterrupted run beside a run
     killed after frame 1 (its ``.old`` checkpoint restored), then resumed
     and merged; every process within its timeout, process 1 writing
     nothing under the run directory (an audit hook), the kernel launched
     in both processes, the resumed dumps bit for bit the uninterrupted
     run's, the merged frames within 4 sigma of the driver phase's first
     injection (mesh_processes); (d) ``parallel.dryrun.dryrun_multichip(4,
     "cuda")``, four shards on the card through the kernel; (e) the serial
     oracle in float64 on tests/test_serial_equivalence.py's frame against
     the XLA engine on the card, by that test's checks (serial_phase);
  9. prints the kernels' JSON line (with each instantiation's block,
     registers, local memory a thread -- spills and stack, as the CUDA
     runtime reports them -- and shared memory, and its launches in the
     driver run, in the cyclo-synchrotron run, in the PLUTO and RIKEN runs
     and in phase 8d's in-process mesh runs, ``mesh_launches``), the search
     kernel's line (its launches on amr_cyl2's main path), then
     {"ok": true, "device": {...}} last.

Each path's launch counts (the driver runs' too) are set to 0 just before it
runs and read just after.  An instantiation's ``launches`` in the kernels' line are those of
the one path that owns it: a main path (its timed runs) where one runs it,
else the first frame of 7. that runs it; a line per instantiation names
that path.  Run from the repository root: ``python3 chip_smoke.py``.  Imports no
JAX.
"""
import collections
import dataclasses
import glob
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the hot cross-section tables' cache (git-ignored)
TABLE_DIR = os.path.join(ROOT, "build", "xsec")
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"


def timed(fn, device):
    """Wall time [ms] of ``fn()``, synchronized with the device."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


# cycles of the spin kernel that holds the stream while the host queues the
# timed launches: ~10 ms at the H100's 1.98 GHz
SPIN_CYCLES = 20_000_000


def kernel_ms(call, launch, k=20):
    """Device ms of each of ``k`` launches ``launch(state)`` (one kernel
    launch on the current stream) on ``call``'s lanes: a CUDA event pair
    around each launch alone, the state restored from ``call.state``
    between launches outside the pairs.  A spin kernel holds the stream
    while the host queues all of them, so no host launch latency falls
    inside a pair.  On the CPU, the host clock of each call."""
    s = call.state.clone()
    if s.device.type != "cuda":
        return [timed(lambda: (s.copy_(call.state), launch(s)), s.device) for _ in range(k)]
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(k)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in ev:
        s.copy_(call.state)
        a.record()
        launch(s)
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def make_grid_3d(e0, e1, e2) -> dict:
    """Rectilinear 3-D grid arrays (C-order raveled meshgrid), as
    bench.py:101-117 builds them."""
    c = [0.5 * (e[:-1] + e[1:]) for e in (e0, e1, e2)]
    g = np.meshgrid(*c, indexing="ij")
    d = np.meshgrid(*[np.diff(e) for e in (e0, e1, e2)], indexing="ij")
    n = g[0].size
    return dict(r0=g[0].ravel(), r1=g[1].ravel(), r2=g[2].ravel(),
                dr0=d[0].ravel(), dr1=d[1].ravel(), dr2=d[2].ravel(),
                v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n),
                dens=np.ones(n), pres=np.ones(n))


def with_phi_velocity(host, scale=0.8, v2=0.3):
    """A phi-hat fluid velocity (2.5-D frames) with a consistent Lorentz factor."""
    host.v0 = host.v0 * scale
    host.v1 = host.v1 * scale
    host.v2 = np.full(host.num_elements, v2)
    host.gamma = 1.0 / np.sqrt(1.0 - (host.v0 ** 2 + host.v1 ** 2 + host.v2 ** 2))
    host.dens_lab = host.dens * host.gamma


# the nonthermal distributions: bench.py:278-294's power law, a broken power law
NT_DISTS = dict(
    nt=dict(nonthermal_e_dist="POWERLAW", powerlaw_index=2.5, gamma_min=1.0,
            gamma_max=100.0),
    bpl=dict(nonthermal_e_dist="BROKENPOWERLAW", powerlaw_index_1=1.5, powerlaw_index_2=3.0,
             gamma_break=10.0, gamma_min=1.0, gamma_max=1000.0),
)
# the frames of the seven packed variants, with nonthermal electrons
NT_PATHS = ("flagship_phi_velocity", "spherical", "cylindrical_2.5d", "spherical_2.5d",
            "cartesian_3d_geomspace_z", "spherical_3d", "polar_3d")
# the AMR main frame's refinement levels: (r0_lo, r0_hi, blocks along r0,
# blocks along r1) over r1 in [1.8e12, 2.9e12], 8x8 cells a block
AMR_BANDS = [(0.0, 1.28e11, 16, 128), (1.28e11, 2.56e11, 8, 64), (2.56e11, 3.2e11, 2, 32)]
# path name -> (frame window dt_max [s], injection fps, kernel variant it selects)
PATHS = {
    "flagship": (0.2, 5.0, "ultra_cyl2"),
    "spherical": (1.0, 1.0, "packed_sph2"),
    "spherical_linear_r": (1.0, 1.0, "ultra_sph2"),
    "flagship_geomspace_z": (0.2, 5.0, "slim_cyl2"),
    "flagship_phi_velocity": (0.2, 5.0, "packed_cyl2"),
    "cylindrical_2.5d": (0.2, 5.0, "packed_cyl25"),
    "spherical_2.5d": (1.0, 1.0, "packed_sph25"),
    "cartesian_3d": (0.2, 5.0, "ultra_cart3"),
    "cartesian_3d_geomspace_z": (0.2, 5.0, "packed_cart3"),
    "spherical_3d": (0.3, 5.0, "packed_sph3"),
    "polar_3d": (0.05, 5.0, "packed_pol3"),
    "amr_cyl2": (0.2, 5.0, "packed_cyl2"),
}
# every (path, mode) case of the kernel-vs-twin phase; modes: direct, table
# (TABLE optical depth), nt / bpl (TABLE + nonthermal electrons), nt_ne0 (nt
# with every third cell free of thermal electrons), aux / aux_nt (TABLE,
# thermal or the power law, through aux planes: the carried path on a
# BinnedIndex over the frame's cells)
RECT_PATHS = [n for n in PATHS if n != "amr_cyl2"]
AUX_MODES = ("aux", "aux_nt")
CASES = ([(n, "direct") for n in RECT_PATHS] + [(n, "table") for n in RECT_PATHS]
         + [(n, "nt") for n in NT_PATHS]
         + [("spherical", "bpl"), ("flagship_phi_velocity", "nt_ne0")]
         + [(n, m) for m in AUX_MODES for n in NT_PATHS])
# the main paths: (path, mode) -> (injection seed, T' = 5e8 K), as bench.py
MAIN = {("flagship", "direct"): (0, False), ("spherical", "direct"): (0, False),
        ("flagship", "table"): (2, True), ("flagship", "nt"): (3, True),
        ("amr_cyl2", "direct"): (0, False), ("amr_cyl2", "aux"): (2, True),
        ("amr_cyl2", "aux_nt"): (3, True)}


@dataclasses.dataclass
class Problem:
    cfg: object
    photons: object
    frame: object
    index: object
    xsec: object  # hot cross-section table (TABLE modes), else None
    dt_max: float  # frame window [s]


def table_cfg(cfg, mode):
    """``cfg`` in TABLE mode, with the nonthermal distribution of ``mode``."""
    from mcrat_tpu_torch import NonthermalDist, TauCalculation

    dist = dict(NT_DISTS.get({"nt_ne0": "nt", "aux_nt": "nt"}.get(mode, mode), {}))
    if dist:
        dist["nonthermal_e_dist"] = NonthermalDist[dist["nonthermal_e_dist"]]
    return dataclasses.replace(cfg, tau_calculation=TauCalculation.TABLE, **dist)


def xsec_tables(cfg, device):
    """The hot cross-section tables of the thermal, power-law and broken
    power-law configs, built (float64 on ``device``) or loaded from
    build/xsec/; prints the time each took."""
    from mcrat_tpu_torch.ops import hot_xsec

    os.makedirs(TABLE_DIR, exist_ok=True)
    tables = {}
    for mode in ("table", "nt", "bpl"):
        path = os.path.join(TABLE_DIR, f"{mode}.npz")
        cached = os.path.exists(path)
        t0 = time.perf_counter()
        tables[mode] = hot_xsec.load_or_build(table_cfg(cfg, mode), path, device=device)
        print(f"[tables] {mode}: {'loaded' if cached else 'built'} {path} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    tables.update(nt_ne0=tables["nt"], aux=tables["table"], aux_nt=tables["nt"])
    return tables


def problem(name, device, n_min, n_max, seed=0, hot=False, mode="direct", tables=None,
            spread=False, dtype=torch.float32):
    """The :class:`Problem` of one path's frame, set up as the repository
    sets it up: the flagship as bench.py:63-92, the spherical main grid as
    mcrat_tpu/driver.py:901-921 for the mc.par of bench.py:424-430, the 3-D
    cartesian frame as bench.py:95-127, the 3-D spherical and polar frames
    as tests/test_pallas_round.py:281-324 at 128x32x32 and 64x32x128 cells,
    the AMR frame as the flagship's outflow on AMR_BANDS' FLASH blocks;
    ``hot`` at T' = 5e8 K, ``spread`` with cell temperatures spread over
    1e5-5e9 K; ``mode`` (see CASES) sets the optical depth and electrons,
    nonthermal densities from the equipartition B field (bench.py:292);
    ``dtype`` float64 gives the XLA engine's frame, photons and index (the
    same injection: the host arithmetic is float64 either way)."""
    from mcrat_tpu_torch import M_P, Config, Dims, Geometry, SimType, Spectrum, transport
    from mcrat_tpu_torch.grid import frame_from_numpy
    from mcrat_tpu_torch.io.flash import cells_from_blocks
    from mcrat_tpu_torch.io.hydro import build_index
    from mcrat_tpu_torch.ops.cyclosynch import nonthermal_electron_dens
    from mcrat_tpu_torch.models.analytic import (
        amr_blocks_2d, apply_simulation_type, make_grid_2d, synthetic_spherical_frame)

    inj = dict(r_inj=2e12, theta_max=np.pi / 30)
    if name == "amr_cyl2":
        cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                     simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
        coords, bsz = amr_blocks_2d(AMR_BANDS, 1.8e12, 2.9e12)
        ones = np.ones((len(coords), 64))
        host = cells_from_blocks(cfg, coords, bsz, dict(velx=0 * ones, vely=0 * ones,
                                                        dens=ones, pres=ones))
        apply_simulation_type(host)
        edges = None
    elif name.startswith("spherical") and "3d" not in name:
        dims = Dims.TWO_POINT_FIVE if name.endswith("2.5d") else Dims.TWO
        cfg = Config(dims=dims, geometry=Geometry.SPHERICAL,
                     simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32")
        host, edges = synthetic_spherical_frame(
            cfg, r_min=1e12, r_max=9e13, nr=384, ntheta=64, theta_max=0.31416,
            log_r=name != "spherical_linear_r")
        if dims is Dims.TWO_POINT_FIVE:
            with_phi_velocity(host)
        inj = dict(r_inj=8e12, theta_max=np.pi / 30)
    elif name.startswith("flagship") or name.startswith("cylindrical"):
        dims = Dims.TWO_POINT_FIVE if name.endswith("2.5d") else Dims.TWO
        cfg = Config(dims=dims, geometry=Geometry.CYLINDRICAL,
                     simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
        r1e = (np.geomspace if name.endswith("geomspace_z") else np.linspace)(
            1.8e12, 2.9e12, 513)
        edges = (np.linspace(0.0, 3.2e11, 161), r1e)
        host = frame_from_numpy(cfg, make_grid_2d(cfg, *edges))
        apply_simulation_type(host)
        if name == "flagship_phi_velocity":
            # a 2-D frame with a phi-hat velocity has no slim table; the
            # kernel ignores v2 there (mcrat_tpu/ops/pallas_round.py:636-640)
            host.v2 = np.full(host.num_elements, 1e-3)
        elif dims is Dims.TWO_POINT_FIVE:
            with_phi_velocity(host)
    else:
        geom = dict(cartesian=Geometry.CARTESIAN, spherical=Geometry.SPHERICAL,
                    polar=Geometry.POLAR)[name.split("_")[0]]
        cfg = Config(dims=Dims.THREE, geometry=geom,
                     simulation_type=(SimType.SPHERICAL_OUTFLOW if geom is Geometry.SPHERICAL
                                      else SimType.CYLINDRICAL_OUTFLOW), dtype="float32")
        if geom is Geometry.CARTESIAN:
            ez = (np.geomspace if name.endswith("geomspace_z") else np.linspace)(
                1.8e12, 2.9e12, 65)
            edges = (np.linspace(-4e11, 4e11, 65), np.linspace(-4e11, 4e11, 65), ez)
        elif geom is Geometry.SPHERICAL:
            edges = (np.geomspace(1e12, 2e13, 129), np.linspace(1e-3, np.pi / 3, 33),
                     np.linspace(0.0, 2 * np.pi, 33))
            inj = dict(r_inj=3e12, theta_max=np.pi / 6)
        else:
            edges = (np.linspace(1e10, 3.2e11, 65), np.linspace(0.0, 2 * np.pi, 33),
                     np.linspace(1.8e12, 2.9e12, 129))
        host = frame_from_numpy(cfg, make_grid_3d(*edges))
        apply_simulation_type(host)
    if hot:
        host.temp[:] = 5e8
    if spread:
        # log-uniform over 1e5-5e9 K, cell by cell: theta from 1.7e-5 to 0.84
        frac = (np.arange(host.num_elements) * 0.6180339887) % 1.0
        host.temp = 10.0 ** (5.0 + frac * np.log10(5e4))
    xsec = None
    if mode != "direct":
        cfg = table_cfg(cfg, mode)
        xsec = tables[mode]
    if mode in ("nt", "bpl", "nt_ne0", "aux_nt"):
        host.nonthermal_dens = nonthermal_electron_dens(cfg, host)
    if mode == "nt_ne0":
        # every third cell's electrons are all nonthermal, at the cell's
        # thermal density: tau_norm falls back to subgroup 1's
        empty = np.arange(host.num_elements) % 3 == 0
        host.nonthermal_dens[empty] = host.dens[empty] / M_P
        host.dens[empty] = 0.0
        host.dens_lab[empty] = 0.0
    if dtype == torch.float64:
        cfg = dataclasses.replace(cfg, dtype="float64")
        host.cfg = cfg
    # the aux modes run the carried path: a BinnedIndex over the cells
    index = build_index(cfg, host, None if mode in AUX_MODES else edges, device=device)
    arrays, _ = transport.inject_photons(
        host, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, fps=PATHS[name][1],
        rng=np.random.default_rng(seed), **inj)
    photons, _ = transport.photons_from_arrays(arrays, dtype=dtype, device=device)
    frame = host.to_device(device, dtype=dtype)
    if dtype == torch.float32:
        variant = transport.select_variant(cfg, frame, index, xsec)[0]
        if mode in ("direct", "table", *AUX_MODES) and variant != PATHS[name][2]:
            raise RuntimeError(f"{name} ({mode}) selects {variant}, not {PATHS[name][2]}")
    return Problem(cfg, photons, frame, index, xsec, PATHS[name][0])


# Work of the kernel (csrc/fused_round.cu) per unit of the twin's tally
# (fused_round.WORK_KEYS), counted by hand from its source, on each pipe.
# FP32: each +, -, *, /, sqrt, rsqrt, min, max and each call of a math
# function one operation; selects, compares and the counter hash not
# counted.
OPS = dict(
    lane_round=41,  # cos(beta, p) 20, rate 3, free path + move 18, per round
    in_grid_round=37,  # the comoving boost
    attempt=107,  # electron direction 57, rest-frame boost + axes 50
    attempt_stokes=167,  # + three Stokes rotations (20 each) in the attempt
    mb=22,  # Maxwell-Boltzmann speed draw (+ theta)
    mj_trial=27,  # one Maxwell-Juttner trial
    nt_draw=30,  # population draw and inverse-CDF gamma (power law)
    scatter=96,  # outgoing photon, two boosts
    scatter_stokes=434,  # + Fano matrix, four rotations, polarized angle set-up
    theta_trial=16,
    phi_trial=9,
    phi_trial_stokes=23,
    cheb=43,  # one Chebyshev sigma_hat, every round (CHEB)
    cheb_nt=53,  # + the subgroup-1 sigma and the biased total (CHEB_NT)
)
# per round: fluid velocity at the photon and the post-move membership test
OPS_GEO = dict(cyl2=(8, 12), sph2=(14, 20), cart3=(0, 12), sph3=(0, 32), pol3=(0, 24))
# The math functions' instructions on their common path, as nvcc 12.9
# compiles them for sm_90a with the kernel's flags (tools/sass_counts.py, its
# listing from the H100 machine): (SFU instructions, FP32 operations: FFMA
# two, FADD and FMUL one, FP64 instructions) of one call; sincos is sinf and
# cosf of one argument, which share their range reduction.
MATH = dict(sqrt=(1, 6, 0), rsqrt=(1, 2, 0), div=(1, 10, 0), exp=(1, 10, 0), log=(0, 27, 0),
            cos=(0, 20, 0), sincos=(0, 33, 0), log1p64=(1, 2, 22), div64=(1, 2, 8))
# the calls of each function per unit of the tally, counted from the source
# (the CHEB families' log of an energy above the knee is not counted: its
# lanes are not tallied)
CALLS = dict(
    lane_round=dict(sqrt=2, div=3, log=1),
    in_grid_round=dict(rsqrt=1, sqrt=1, div=2),
    attempt=dict(div=8, sqrt=5, rsqrt=1, sincos=1),
    attempt_stokes=dict(div=8, sqrt=8, rsqrt=4, sincos=1),
    mb=dict(cos=1, log=2, rsqrt=1, sqrt=1),
    mj_trial=dict(log=1, sqrt=1),
    nt_draw=dict(exp=3, log=1, sqrt=1, div=1),
    scatter=dict(sqrt=5, div=9, rsqrt=3),
    scatter_stokes=dict(sqrt=10, div=15, rsqrt=7),
    theta_trial=dict(div=2),
    phi_trial={},
    phi_trial_stokes=dict(div=3),
    cheb=dict(exp=1),
    cheb_nt=dict(exp=2, div=1),
)
CALLS_GEO = dict(cyl2=(dict(sqrt=1, div=2), dict(sqrt=1)),
                 sph2=(dict(sqrt=1, div=2), dict(sqrt=2, div=1)), cart3=({}, {}),
                 sph3=({}, dict(sqrt=3, div=3)), pol3=({}, dict(sqrt=2, div=2)))
# INT32: the counter hash, 12 integer operations a uniform (ops/rng.py,
# fused_round.cu uniform: multiply-add of the draw number, three
# shift-xors, two multiplies, shift-or), times the uniforms each unit draws
INT_OPS_PER_UNIFORM = 12
UNIFORMS = dict(lane_round=1, attempt=3, attempt_nt=4, mb=3, mj_trial=5, nt_draw=1,
                theta_trial=2, phi_trial=2)
# FP64: the Klein-Nishina closed form (F6) on attempts at e >= 1e-3
# (kn_double): 12 operations (fmax, the common 2 se and 1 + se, four
# products, three sums, the 0.75 scale), four divisions and a log1p
KN_F64_OPS, KN_F64_CALLS = 12, dict(div64=4, log1p64=1)
# per-SM results a clock for compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instructions) x 132 SMs x 1.98 GHz (H100 SXM boost)
SM_RATE = 132 * 1.98e9
PEAK_INT32_S = 64 * SM_RATE  # 32-bit integer add, multiply, shift, logic
PEAK_SFU_S = 16 * SM_RATE  # reciprocal, rsqrt, log2, exp2, sine, cosine
PEAK_F64_S = 64 * SM_RATE  # 64-bit floating-point add, multiply


def table_rows_read(variant, tau):
    """Rows of the cell table the kernel reads for each cell a running lane
    holds (fused_round.cu Cell::load): the ultra and slim tables whole; of
    the packed rows, the fluid (gamma, temperature, v0, v1, v2 where it has
    a phi-hat or 3-D velocity), the density (not in the AUX families, which
    take it from their plane), the nonthermal density (CHEB_NT), the cell's
    centre and size and its angular sines and cosines; in CHEB families 16
    Chebyshev rows (the knee and the coefficients)."""
    from mcrat_tpu_torch.ops import fused_round as fr

    var = fr.VARIANTS[variant]
    cheb = (3 + fr.CHEB_DLO + fr.CHEB_DHI) if tau in (fr.TAU_CHEB, fr.TAU_CHEB_NT) else 0
    if var.source != "packed":
        return var.width + cheb
    d3 = var.geom in ("cart3", "sph3", "pol3")
    return (4 + (tau not in (fr.TAU_AUX, fr.TAU_AUX_NT)) + (var.v2 or d3)
            + (tau == fr.TAU_CHEB_NT) + 4 + 2 * d3 + 2 * (var.geom in ("sph2", "sph3", "pol3"))
            + 2 * (var.geom == "sph3") + cheb)


def bound(inst, variant, n_lanes, run_lanes, n_cells, work, stokes_on):
    """(bound_ms, bound_by, pipe) of one call: the largest of the times the
    card needs for the bytes it must move (flags and out-flags of every
    lane; state read and written, cell index and the aux planes an AUX
    family reads of each lane that runs; the rows the kernel reads of each
    distinct cell those lanes hold, once) over the HBM rate, and for its
    work on each pipe at the twin's tally of this call: float32 operations
    (OPS, each math function at its instructions) over the float32 rate,
    the counter hash's integer operations over the INT32 rate, the math
    functions' MUFU instructions over the SFU rate and the double KN form
    over the FP64 rate.  ``bound_by`` is "bytes" or "operations", ``pipe``
    the one that binds (bytes, fp32, int32, sfu, fp64)."""
    from mcrat_tpu_torch.ops import fused_round as fr

    var = fr.VARIANTS[variant]
    nt = "+nt" in inst
    tau = (fr.TAU_AUX_NT if nt else fr.TAU_AUX) if "+aux" in inst else (
        (fr.TAU_CHEB_NT if nt else fr.TAU_CHEB) if "+cheb" in inst else fr.TAU_DIRECT)
    aux_bytes = {fr.TAU_AUX: 4, fr.TAU_AUX_NT: 8}.get(tau, 0)
    nbytes = (n_lanes * (4 + 4) + run_lanes * (2 * 64 + 4 + aux_bytes)
              + n_cells * table_rows_read(variant, tau) * 4)
    w = {k: work.get(k, 0.0) for k in (
        "lane_rounds", "in_grid_rounds", "attempts", "mb", "mj_trials", "nt_draws", "scatters",
        "theta_trials", "phi_trials", "kn_double")}
    st = "_stokes" if stokes_on else ""
    cheb = ("cheb_nt" if nt else "cheb") if "+cheb" in inst else None
    # (tally key, unit) pairs; a lane round also runs the geometry's fluid
    # and membership code and, in CHEB families, the Chebyshev sigma
    units = [("in_grid_rounds", "in_grid_round"), ("attempts", "attempt" + st), ("mb", "mb"),
             ("mj_trials", "mj_trial"), ("nt_draws", "nt_draw"), ("scatters", "scatter" + st),
             ("theta_trials", "theta_trial"), ("phi_trials", "phi_trial" + st)]
    per_round = ["lane_round"] + ([cheb] if cheb else [])

    fluid, member = OPS_GEO[var.geom]
    fp32 = (w["lane_rounds"] * (sum(OPS[u] for u in per_round) + fluid + member
                                + (2 if var.v2 else 0))
            + sum(w[k] * OPS[u] for k, u in units))
    calls = collections.Counter()
    for k, parts in (("lane_rounds", [CALLS[u] for u in per_round] + list(CALLS_GEO[var.geom])),
                     *((k, [CALLS[u]]) for k, u in units), ("kn_double", [KN_F64_CALLS])):
        for part in parts:
            for f, n in part.items():
                calls[f] += w[k] * n
    # each call at its instructions, in place of the operations OPS counts
    # for it (one; sinf and cosf two; the KN form's double calls none)
    fp32 += sum(n * (MATH[f][1] - {"sincos": 2, "log1p64": 0, "div64": 0}.get(f, 1))
                for f, n in calls.items())
    sfu = sum(n * MATH[f][0] for f, n in calls.items())
    fp64 = w["kn_double"] * KN_F64_OPS + sum(n * MATH[f][2] for f, n in calls.items())
    uniforms = (w["lane_rounds"] * UNIFORMS["lane_round"]
                + w["attempts"] * UNIFORMS["attempt_nt" if nt else "attempt"]
                + w["mb"] * UNIFORMS["mb"] + w["mj_trials"] * UNIFORMS["mj_trial"]
                + w["nt_draws"] * UNIFORMS["nt_draw"]
                + w["theta_trials"] * UNIFORMS["theta_trial"]
                + w["phi_trials"] * UNIFORMS["phi_trial"])
    times = dict(bytes=nbytes / PEAK_BYTES_S, fp32=fp32 / PEAK_F32_S,
                 int32=uniforms * INT_OPS_PER_UNIFORM / PEAK_INT32_S, sfu=sfu / PEAK_SFU_S,
                 fp64=fp64 / PEAK_F64_S)
    pipe = max(times, key=times.get)
    return 1e3 * times[pipe], ("bytes" if pipe == "bytes" else "operations"), pipe


def library_resources(lib):
    """Each instantiation's launch shape and resources as the loaded library
    reports them (fused_round.kernel_attributes), printed; fails unless its
    block is fused_round.cuda_block's and its dynamic shared memory that
    block's fused_round.layout_floats columns."""
    from mcrat_tpu_torch.ops import fused_round as fr

    out = {}
    for name, variant, tau, stokes_on in fr.instantiation_specs():
        r = out[name] = fr.kernel_attributes(lib, variant, tau, stokes_on)
        threads = fr.cuda_block(variant, tau, stokes_on)
        print(f"[build] {name}: {r['threads']} threads a block, {r['registers']} registers, "
              f"{r['local_bytes']} B local memory a thread, shared memory {r['dyn_smem']} B + "
              f"{r['static_smem']} B static a block", flush=True)
        if (r["threads"], r["dyn_smem"]) != (threads, 4 * threads * fr.layout_floats(variant, tau)):
            raise RuntimeError(f"{name}: the library's block or shared memory differs from "
                               f"fused_round.cuda_block / layout_floats")
    return out


def warp_line(work):
    """The twin's warp tally of one call, branch by branch: warps that run
    it with one thread a lane (any lane), warps once each CUDA block packs
    its lanes (dense), and the lanes that take it."""
    from mcrat_tpu_torch.ops import fused_round as fr

    parts = []
    for b in fr.WARP_BRANCHES:
        a, d = work.get(f"warps_any_{b}", 0.0), work.get(f"warps_dense_{b}", 0.0)
        parts.append(f"{b} any {a:.0f} dense {d:.0f} ({a / max(d, 1.0):.2f}x, "
                     f"{work.get(b, 0.0):.0f} lanes)")
    return "; ".join(parts)


def lane_cells(prob, state):
    """Each lane's cell and in-grid flag, as the frame's glue finds them:
    find_cell_direct on a RectilinearIndex; on a BinnedIndex the cached-cell
    pin (the photons' injection cells) and the index search."""
    from mcrat_tpu_torch.grid import BinnedIndex, find_cell_direct, find_cell_rows
    from mcrat_tpu_torch.ops import fused_round as fr

    pos = state[fr.SP_X: fr.SP_Z + 1].T
    if isinstance(prob.index, BinnedIndex):
        cached = torch.full((state.shape[1],), -1, dtype=torch.int32, device=state.device)
        cached[:prob.photons.capacity] = prob.photons.cell
        return find_cell_rows(prob.cfg, prob.index, prob.frame, pos, cached)
    return find_cell_direct(prob.cfg, prob.index, prob.frame, pos)


@dataclasses.dataclass
class Call:
    """The inputs of one fused_rounds call over every lane of a frame."""
    inst: str  # its instantiation
    state: torch.Tensor  # (16, Npad), left untouched: each call runs on a clone
    alive: torch.Tensor
    args: tuple  # (cell, flags, table, block_act, seed, grid)
    kw: dict  # stokes_on, inner_rounds, block_lanes, variant, cheb_base, nt, aux

    def run(self, fn, state=None):
        """``fn`` (fused_rounds, fused_rounds_reference, or a launch through
        another build) on a clone of the state: (state after, out-flags)."""
        s = self.state.clone() if state is None else state
        return s, fn(s, *self.args, **self.kw)


def call_inputs(prob, stokes_on, idle_block=None, pool_lanes=False, s_rows=128,
                seed=20240917, state=None, cell=None, flags=None, block_act=None):
    """The :class:`Call` of one fused_rounds call (inner_rounds=4) over every
    lane of ``prob``, as the frame's glue sets it up (aux planes from
    transport.aux_planes where the frame's path takes them);
    ``pool_lanes`` marks every 7th live lane as a CS pool photon.  ``state``,
    ``cell``, ``flags`` and ``block_act`` replace the frame's own (lane
    masks made on the host)."""
    from mcrat_tpu_torch import transport
    from mcrat_tpu_torch.ops import fused_round as fr

    cfg, photons, frame, index = prob.cfg, prob.photons, prob.frame, prob.index
    device = photons.device
    t_rem = transport.frame_time(photons, 0.2)
    st, alive, pool = transport.lane_planes(photons, t_rem, s_rows)
    if pool_lanes:
        pool = alive & (torch.arange(alive.numel(), device=device) % 7 == 3)
    state = st if state is None else state
    if cell is None:
        cell, in_grid = lane_cells(prob, state)
        cell = torch.clamp(cell, 0, frame.num_elements - 1).to(torch.int32)
        flags = transport.lane_flags(alive, pool, in_grid)
    alive = (flags & fr.FLAG_ALIVE) != 0
    block_lanes = s_rows * fr.LANES
    if block_act is None:
        block_act = torch.ones(state.shape[1] // block_lanes, dtype=torch.int32, device=device)
    if idle_block is not None:
        block_act[idle_block] = 0
    grid = transport.grid_scalars(frame, index)
    variant, table, kflags = transport.select_variant(cfg, frame, index, prob.xsec)
    inst = fr.instantiation(variant, kflags.cheb_base, kflags.nt, stokes_on,
                            kflags.aux is not None)
    aux = (None if kflags.aux is None else
           transport.aux_planes(cfg, kflags.aux, frame, cell, state[fr.SP_C0]).contiguous())
    kw = dict(stokes_on=stokes_on, inner_rounds=4, block_lanes=block_lanes, variant=variant,
              cheb_base=kflags.cheb_base, nt=kflags.nt, aux=aux)
    return Call(inst, state, alive, (cell, flags, table, block_act, seed, grid), kw)


# the compaction edge cases (edge_call): in CUDA blocks 0-6 of logical block
# 0, the lanes the Klein-Nishina draw accepts in round 0 (None: every lane;
# block 6 also marks every third of its accepted lanes as a pool photon);
# block 7's lanes all stall in round 0; logical block 1 is idle
EDGE_ACCEPTS = (0, 1, 31, 32, 33, None, 100)


def edge_call(prob, stokes_on, seed=11):
    """A :class:`Call` of four logical blocks of ``prob``'s lanes, the first
    rebuilt on the host (seeded) for the edge cases of the kernel's
    block-local scatter queue (EDGE_ACCEPTS).  A lane meant to scatter takes
    an alive in-grid lane's state with its momenta scaled by 1e-10 (its
    electron-frame energy is then far below 2^-26, so sigma_KN rounds to 1
    and every acceptance draw passes) and 1e3 s of frame time; the others
    of those blocks attempt nothing in round 0 (dead, outside the grid, or
    without time).  Block 7's lanes carry 1e3 s and a cell that does not
    hold them.  The twin's round 0 is held to the plan before the call is
    returned."""
    from mcrat_tpu_torch.ops import fused_round as fr

    base = call_inputs(prob, stokes_on)
    kw = base.kw
    L = kw["block_lanes"]
    tau = fr.tau_family(kw["cheb_base"], kw["nt"], kw["aux"] is not None)
    B = fr.cuda_block(kw["variant"], tau, stokes_on)
    dev = base.state.device
    n, ncell = 4 * L, base.args[2].shape[1]
    state, cell, flags = base.state[:, :n].clone(), base.args[0][:n].clone(), base.args[1][:n].clone()
    rs = np.random.default_rng(seed)
    ok = ((base.args[1] & fr.FLAG_ALIVE) != 0) & ((base.args[1] & fr.FLAG_INGRID) != 0)
    donors = torch.nonzero(ok).flatten().cpu().numpy()

    def put(lanes, scale, pool=(), far=False):
        dst = torch.as_tensor(lanes, device=dev)
        src = torch.as_tensor(rs.choice(donors, len(lanes)), device=dev)
        state[:, dst] = base.state[:, src]
        for p in (*range(fr.SP_P0, fr.SP_P3 + 1), *range(fr.SP_C0, fr.SP_C3 + 1)):
            state[p, dst] *= scale
        state[fr.SP_TREM, dst] = 1e3
        cell[dst] = (base.args[0][src] + (ncell // 2 if far else 0)) % ncell
        fl = torch.full((len(lanes),), fr.FLAG_ALIVE | fr.FLAG_INGRID, dtype=torch.int32,
                        device=dev)
        fl[list(pool)] |= fr.FLAG_POOL
        flags[dst] = fl

    want = []
    for b, k in enumerate(EDGE_ACCEPTS):
        lanes = np.arange(b * B, (b + 1) * B)
        k = B if k is None else k
        acc = np.sort(rs.choice(lanes, k, replace=False))
        rest = torch.as_tensor(np.setdiff1d(lanes, acc), device=dev)
        if k:
            put(acc, 1e-10, pool=range(0, k, 3) if b == 6 else ())
        # the rest: dead, alive outside the grid, alive in the grid with no time
        kind = torch.arange(rest.numel(), device=dev) % 3
        flags[rest] = torch.where(kind == 0, 0, torch.where(
            kind == 1, fr.FLAG_ALIVE, fr.FLAG_ALIVE | fr.FLAG_INGRID)).to(torch.int32)
        state[fr.SP_TREM, rest[kind == 2]] = 1e-30
        want.append(k)
    put(np.arange(7 * B, 8 * B), 1.0, far=True)
    block_act = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=dev)
    call = call_inputs(prob, stokes_on, state=state, cell=cell, flags=flags, block_act=block_act)

    one = dataclasses.replace(call, kw={**call.kw, "inner_rounds": 1})
    st, out = one.run(fr.fused_rounds_reference)
    got = ((st[fr.SP_NS] - state[fr.SP_NS])[:7 * B].view(7, B) > 0).sum(1).tolist()
    stalled = int(((out[7 * B:8 * B] & fr.OUT_STALLED) != 0).sum())
    promoted = int(((out[6 * B:7 * B] & fr.OUT_PROMOTED) != 0).sum())
    if got != want or stalled != B or promoted != len(range(0, 100, 3)):
        raise RuntimeError(f"edge cases off plan: accepted {got} (want {want}), stalled "
                           f"{stalled} of {B}, promoted {promoted}")
    return call


def kernel_vs_twin(name, prob, stokes_on, idle_block=None, pool_lanes=False, time_it=False,
                   call=None):
    """One fused_rounds call (inner_rounds=4) over every lane, kernel and
    twin on the same inputs (``call``, else :func:`call_inputs` of
    ``prob``).  Fails unless NS, out-flags and every state plane are
    identical.  Returns (instantiation, max_abs_err, kernel ms, twin ms,
    (bound ms, bound by), the twin's work tally)."""
    from mcrat_tpu_torch.ops import fused_round as fr

    c = call or call_inputs(prob, stokes_on, idle_block, pool_lanes)
    inst, state, alive = c.inst, c.state, c.alive
    safe, _, _, block_act, _, _ = c.args
    block_lanes, variant = c.kw["block_lanes"], c.kw["variant"]
    device = state.device
    sk, ok_ = c.run(fr.fused_rounds)
    fr.fused_rounds_reference.work = collections.Counter()
    st, ot_ = c.run(fr.fused_rounds_reference)
    work = {k: float(v) for k, v in fr.fused_rounds_reference.work.items()}
    fr.fused_rounds_reference.work = None
    lane_on = torch.repeat_interleave(block_act != 0, block_lanes)
    live = lane_on & alive
    same = (sk[fr.SP_NS] == st[fr.SP_NS]) & (ok_ == ot_)
    n_live = int(live.sum())
    n_diff = int((~same & live).sum())
    err = (sk[:, live] - st[:, live]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    idle_ok = bool(torch.equal(sk[:, ~lane_on], state[:, ~lane_on])
                   and torch.equal(st[:, ~lane_on], state[:, ~lane_on])
                   and not ok_[~lane_on].any())
    print(f"[kernel-vs-twin] {name} ({inst}): live lanes {n_live}, scatterings kernel "
          f"{int(sk[fr.SP_NS].sum() - state[fr.SP_NS].sum())} twin "
          f"{int(st[fr.SP_NS].sum() - state[fr.SP_NS].sum())}; lanes differing in NS/out-flags "
          f"{n_diff}; max abs err {max_abs:.3e}; idle lanes untouched {idle_ok}", flush=True)
    if n_diff or max_abs != 0.0 or not idle_ok:
        raise RuntimeError(f"kernel disagrees with its twin ({name}, {inst})")
    k_ms = t_ms = bnd = None
    if time_it:
        def twin():  # host ms of one twin call on a fresh clone of the state
            s = state.clone()
            return timed(lambda: c.run(fr.fused_rounds_reference, s), device)

        def kernel(s):
            fr.fused_rounds(s, *c.args, **c.kw)

        kernel_ms(c, kernel, 3)  # warm-up
        twin()
        k_ms = float(np.median(kernel_ms(c, kernel)))
        t_ms = float(np.median([twin() for _ in range(5)]))
        runs = live & (state[fr.SP_TREM] > 0)
        n_cells = int(torch.unique(safe[runs]).numel())
        bnd = bound(inst, variant, state.shape[1], int(runs.sum()), n_cells, work,
                    c.kw["stokes_on"])
        print(f"[kernel-vs-twin] {name} ({inst}): one fused_rounds call ({state.shape[1]} lanes, "
              f"4 rounds): kernel {k_ms:.4f} ms (device, median of 20 launches), twin {t_ms:.3f} "
              f"ms (host clock, median of 5); bound {bnd[0]:.4f} ms ({bnd[2]}; work {work})",
              flush=True)
        print(f"[warps] {name} ({inst}): {warp_line(work)}", flush=True)
    return inst, max_abs, k_ms, t_ms, bnd, work


def run_frame(prob, seed, rounds_fn, dt_max=0.2, stokes_on=True):
    from mcrat_tpu_torch import transport

    # the kernel's path: on the card by default (fused=None), on the CPU
    # (a rehearsal) through the twin
    return transport.transport_frame(
        prob.cfg, prob.photons, prob.frame, prob.index, dt_max,
        torch.Generator().manual_seed(seed), stokes_on=stokes_on, chunk_rounds=64,
        rounds_fn=rounds_fn, xsec_table=prob.xsec,
        fused=True if prob.photons.device.type == "cpu" else None)


def frame_checks(photons, res):
    """Weight conserved exactly, finite state, frame finished, scatterings."""
    ph = res.photons
    alive = ph.alive
    checks = {
        "weight conserved": bool(torch.equal(ph.weight, photons.weight)),
        "finite p/pos/s/comv_p": all(bool(torch.isfinite(x).all())
                                     for x in (ph.p, ph.pos, ph.s, ph.comv_p)),
        "frame finished": bool((res.t_rem[alive] <= 0).all()),
        "n_scatt > 0": res.n_scatt > 0,
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise RuntimeError(f"frame checks failed: {bad}")
    return checks


def frame_summary(photons, res):
    ph = res.photons
    alive = ph.alive
    s = ph.s[alive]
    return dict(
        w=float(ph.weight.double().sum()), n_scatt=res.n_scatt,
        e=float(ph.p[alive, 0].double().mean()),
        ns=float(ph.num_scatt[alive].double().mean()),
        q=float(s[:, 1].double().mean()), u=float(s[:, 2].double().mean()),
    )


def zero_launches():
    from mcrat_tpu_torch.ops import fused_round as fr

    fr.fused_rounds.launches = 0
    fr.fused_rounds.variant_launches.clear()
    fr.fused_rounds_reference.launches = 0


def read_launches():
    """(kernel launches by instantiation, twin launches) since zero_launches."""
    from mcrat_tpu_torch.ops import fused_round as fr

    return dict(fr.fused_rounds.variant_launches), fr.fused_rounds_reference.launches


def frame_once(prob, seed, rounds_fn, device, stokes_on=True):
    """One transport_frame of a path through ``rounds_fn``, its launch counts
    zeroed just before and read just after.  Returns (ms, FrameResult,
    kernel launches by instantiation, twin launches)."""
    zero_launches()
    out = []
    ms = timed(lambda: out.append(run_frame(prob, seed, rounds_fn, dt_max=prob.dt_max,
                                            stokes_on=stokes_on)), device)
    return (ms, out[0], *read_launches())


def instantiation_of(prob, stokes_on=True):
    from mcrat_tpu_torch import transport
    from mcrat_tpu_torch.ops import fused_round as fr

    variant, _, kflags = transport.select_variant(prob.cfg, prob.frame, prob.index, prob.xsec)
    return fr.instantiation(variant, kflags.cheb_base, kflags.nt, stokes_on,
                            kflags.aux is not None)


def check_launches(name, inst, launches, twin_launches, device, engine="kernel"):
    print(f"[{name}] launches: kernel {launches}, twin {twin_launches}", flush=True)
    if device.type == "cuda" and engine != "kernel":
        raise RuntimeError(f"the {name} path ran on the {engine} engine, not the kernel")
    if device.type == "cuda" and (launches.get(inst, 0) == 0 or twin_launches != 0
                                  or set(launches) != {inst}):
        raise RuntimeError(f"the {name} path did not run through the {inst} kernel alone")


def report_frame(name, prob, res, elapsed_ms, card, what):
    from mcrat_tpu_torch import transport

    n_ph = prob.photons.capacity
    el = elapsed_ms / 1e3
    pr = n_ph * res.n_rounds
    print(f"[{name}] {card}: n_photons {n_ph}, n_scatt {res.n_scatt}, n_rounds "
          f"{res.n_rounds}, elapsed {el:.4f} s ({what}), {res.n_scatt / el:.6e} "
          f"scatterings/s, {pr / el:.6e} photon-rounds/s, "
          f"{1e9 * el / max(pr, 1):.4f} ns/photon-round", flush=True)
    print(f"[{name}] {card}: frame_stats {transport.frame_stats(res.photons).tolist()}",
          flush=True)


def main_path(name, prob, card, device):
    """One warm-up + the median of 3 frames through the kernel, the frame
    checks, then the same frame (seed 2: the same random numbers) once
    through the twin, statistics held against the kernel's, and once with
    Stokes off.  Returns the kernel launches by instantiation and the median
    frame's result."""
    from mcrat_tpu_torch.ops import fused_round as fr

    photons = prob.photons
    inst = instantiation_of(prob)
    frame_once(prob, 0, fr.fused_rounds, device)  # warm-up
    runs = {}  # seed -> (ms, FrameResult)
    launches, twin_launches = {}, 0
    for seed in (1, 2, 3):
        ms, res, lk, lt = frame_once(prob, seed, fr.fused_rounds, device)
        runs[seed] = (ms, res)
        launches = {k: launches.get(k, 0) + lk[k] for k in lk}
        twin_launches += lt
    elapsed_ms, res = sorted(runs.values(), key=lambda s: s[0])[1]
    check_launches(name, inst, launches, twin_launches, device, res.engine)
    checks = frame_checks(photons, res)
    report_frame(name, prob, res, elapsed_ms, card, "median of 3")
    print(f"[{name}] checks {checks}", flush=True)

    twin_ms, tres, _, _ = frame_once(prob, 2, fr.fused_rounds_reference, device)
    kres = runs[2][1]
    a, b = frame_summary(photons, kres), frame_summary(photons, tres)
    print(f"[{name}/twin] {card}: the frame through the twin {twin_ms / 1e3:.4f} s (once), "
          f"through the kernel {runs[2][0] / 1e3:.4f} s (same seed), median kernel "
          f"{elapsed_ms / 1e3:.4f} s", flush=True)
    print(f"[{name}/twin] kernel {a}\n[{name}/twin] twin   {b}", flush=True)
    # the kernel is bit-identical to its twin, and the glue is the same code:
    # the two frames must agree photon for photon
    differ = [k for k, v in kres.photons.fields().items()
              if not torch.equal(v, getattr(tres.photons, k))]
    if not torch.equal(kres.t_rem, tres.t_rem):
        differ.append("t_rem")
    if (kres.n_scatt, kres.n_rounds) != (tres.n_scatt, tres.n_rounds):
        differ.append("n_scatt/n_rounds")
    print(f"[{name}/twin] frames identical photon for photon: {not differ}", flush=True)
    if differ:
        raise RuntimeError(f"{name}: the twin frame differs from the kernel frame in {differ}")
    return {**launches, **frame_stokes_off(name, prob, card, device)}, res


def frame_stokes_off(name, prob, card, device):
    """The frame once through the kernel with Stokes off, with the frame
    checks.  Returns its kernel launches by instantiation."""
    from mcrat_tpu_torch.ops import fused_round as fr

    ms, res, lk, lt = frame_once(prob, 1, fr.fused_rounds, device, stokes_on=False)
    check_launches(f"{name}/stokes_off", instantiation_of(prob, False), lk, lt, device,
                   res.engine)
    checks = frame_checks(prob.photons, res)
    report_frame(f"{name}/stokes_off", prob, res, ms, card, "once")
    print(f"[{name}/stokes_off] checks {checks}", flush=True)
    return lk


def f6_check(device):
    """The kernel's Klein-Nishina cross section (float64 closed form, rounded
    once) against float64 on a geomspace of e in [1e-3, 1e3], and against
    its twin; the float32 closed form shown beside it."""
    from mcrat_tpu_torch.ops import compton
    from mcrat_tpu_torch.ops import fused_round as fr

    e = torch.tensor(np.geomspace(1e-3, 1e3, 200_001), dtype=torch.float32, device=device)
    fr.kn_cross_section.launches = 0
    got = fr.kn_cross_section(e)
    twin = fr._kn_cross_section(e)
    ref = compton.kn_cross_section(e.double())
    se = e.clamp(min=1e-10)
    f32 = 0.75 * (2.0 / (se * se) + (1.0 / (2.0 * se) - (1.0 + se) / (se * (se * se)))
                  * torch.log1p(2.0 * se) + (1.0 + se) / ((1.0 + 2.0 * se) * (1.0 + 2.0 * se)))
    err = float((got.double() - ref).abs().max())
    err32 = float((f32.double() - ref).abs().max())
    print(f"[f6] sigma_KN on {e.numel()} energies in [1e-3, 1e3]: kernel max abs err vs "
          f"float64 {err:.3e} (float32 closed form: {err32:.3e}); kernel == twin "
          f"{bool(torch.equal(got, twin))}; launches {fr.kn_cross_section.launches}", flush=True)
    if err > 1e-6 or not torch.equal(got, twin) or (
            device.type == "cuda" and fr.kn_cross_section.launches != 1):
        raise RuntimeError("the kernel's Klein-Nishina cross section fails the F6 check")


def amr_lookup_check(prob):
    """find_cell_rows on the card against the same lookup on the CPU: the
    injected photons with their cached cells, 2^20 random points and points
    on the block seams and level boundaries with none.  Fails unless every
    cell and in-grid flag is identical."""
    from mcrat_tpu_torch import geometry as geo
    from mcrat_tpu_torch.grid import find_cell_rows

    cfg, frame, index, ph = prob.cfg, prob.frame, prob.index, prob.photons
    rs = np.random.default_rng(5)
    n = 1 << 20
    r0 = rs.uniform(-1e10, 3.3e11, n)
    r1 = rs.uniform(1.75e12, 2.95e12, n)
    # a quarter on block edges of every level: r0 and r1 multiples of the
    # finest block size, the level boundaries among them
    q = n // 4
    r0[:q] = rs.integers(0, 41, q) * 8e9
    r1[q:2 * q] = 1.8e12 + rs.integers(0, 129, q) * (1.1e12 / 128)
    phi = rs.uniform(0.0, 2 * np.pi, n)
    pts = np.stack(geo.hydro_to_mcrat(cfg, r0, r1, phi), axis=1).astype(np.float32)
    pos = torch.cat([ph.pos, torch.from_numpy(pts).to(ph.device)])
    cached = torch.cat([ph.cell, torch.full((n,), -1, dtype=torch.int32, device=ph.device)])
    t0 = time.perf_counter()
    cell, in_grid = find_cell_rows(cfg, index, frame, pos, cached)
    if pos.device.type == "cuda":
        torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)

    def cpu(obj):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu()
                                           for f in dataclasses.fields(obj)
                                           if torch.is_tensor(getattr(obj, f.name))})

    cell_c, in_c = find_cell_rows(cfg, cpu(index), cpu(frame), pos.cpu(), cached.cpu())
    differ = int(((cell.cpu() != cell_c) | (in_grid.cpu() != in_c)).sum())
    print(f"[amr lookup] {pos.shape[0]} points ({ph.capacity} photons with their cached "
          f"cells, {n} searched): {int(in_c.sum())} in the grid, cells differing card vs "
          f"CPU {differ}; card {card_ms:.2f} ms; index dims {index.dims}, max_slab "
          f"{index.max_slab}", flush=True)
    if differ:
        raise RuntimeError("the AMR cell lookup on the card differs from the CPU's")


# lanes of one carried lookup's search in the benchmark's amr_jet.frame
# (~237k, PERF.md section 5)
SEARCH_LANES = 237_000


def binned_search_check(prob, k=50):
    """The search kernel (``grid.BinnedIndex.find`` on the card) against its
    plain version (``find_reference``) on the AMR frame: ``SEARCH_LANES`` of
    the injected photons moved by up to 8 finest cells along r0 and r1 (the
    lanes a lookup searches have left their cells).  Prints the kernel's
    device ms a call (CUDA events around each of ``k`` launches, a spin
    kernel holding the stream), the plain version's ms a call at the same
    shapes (host clock ending in a synchronize, median of 5) and the lanes
    found; fails unless the two give the same cells.  Returns (kernel ms,
    None on the CPU, plain ms)."""
    from mcrat_tpu_torch import geometry as geo

    cfg, frame, index, ph = prob.cfg, prob.frame, prob.index, prob.photons
    pos = ph.pos[:SEARCH_LANES]
    n = pos.shape[0]
    r0, r1, r2 = geo.mcrat_to_hydro(cfg, pos[:, 0], pos[:, 1], pos[:, 2])
    step = torch.as_tensor(np.random.default_rng(7).uniform(-8e9, 8e9, (2, n)), dtype=r0.dtype,
                           device=r0.device)
    r0, r1, r2 = (r0 + step[0]).contiguous(), (r1 + step[1]).contiguous(), r2.contiguous()
    got = index.find(r0, r1, r2, frame)
    want = index.find_reference(r0, r1, r2, frame)
    differ = int((got != want).sum())
    device = r0.device
    plain_ms = statistics.median(
        timed(lambda: index.find_reference(r0, r1, r2, frame), device) for _ in range(5))
    if device.type == "cuda":
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(k)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        for a, b in ev:
            a.record()
            index.find(r0, r1, r2, frame)
            b.record()
        torch.cuda.synchronize()
        k_ms = statistics.median(a.elapsed_time(b) for a, b in ev)
        kernel = f"kernel {k_ms:.4f} ms a call (device, median of {k})"
    else:
        k_ms, kernel = None, "no kernel on the CPU (find runs the plain version)"
    print(f"[binned search] {n} lanes on {frame.num_elements} cells (index dims {index.dims}, "
          f"max_slab {index.max_slab}): {int((want >= 0).sum())} found, cells differing kernel "
          f"vs plain version {differ}; {kernel}, plain version {plain_ms:.3f} ms (host clock, "
          f"median of 5)", flush=True)
    if differ:
        raise RuntimeError("the search kernel's cells differ from its plain version's")
    return k_ms, plain_ms


def direct_lookup_check(prob, k=50):
    """The direct lookup kernel (``grid.find_cell_direct`` on the card)
    against its plain version (``find_cell_direct_reference``) on a
    rectilinear frame: the injected photons (~1M on the main paths) moved
    by up to 4e9 cm along each axis.  Prints the kernel's device ms a call
    (CUDA events around each of ``k`` launches, a spin kernel holding the
    stream) and the plain version's ms a call at the same shapes (host
    clock ending in a synchronize, median of 5), then the second entry's
    (the cells, their clamp and the lane flags) device ms; fails unless the
    kernel's cells, in-grid flags, clamp and flags equal the plain
    version's.  Returns (kernel ms, None on the CPU, plain ms)."""
    from mcrat_tpu_torch import grid as tgrid
    from mcrat_tpu_torch import transport as tt

    cfg, frame, index, ph = prob.cfg, prob.frame, prob.index, prob.photons
    n = ph.capacity
    step = torch.as_tensor(np.random.default_rng(8).uniform(-4e9, 4e9, (n, 3)),
                           dtype=ph.pos.dtype, device=ph.pos.device)
    pos = ph.pos + step
    alive, pool = ph.alive, torch.zeros_like(ph.alive)
    cell, in_grid = tgrid.find_cell_direct(cfg, index, frame, pos)
    want, want_in = tgrid.find_cell_direct_reference(cfg, index, frame, pos)
    lanes = tt.direct_lane_inputs(cfg, index, frame, pos, alive, pool)
    differ = int((cell != want).sum()) + int((in_grid != want_in).sum()) + int(
        (lanes[0] != want).sum()) + int(
        (lanes[1] != torch.clamp(want, 0, frame.num_elements - 1)).sum()) + int(
        (lanes[2] != tt.lane_flags(alive, pool, want_in)).sum())
    device = pos.device
    plain_ms = statistics.median(
        timed(lambda: tgrid.find_cell_direct_reference(cfg, index, frame, pos), device)
        for _ in range(5))
    if device.type == "cuda":
        times = []
        for fn in (lambda: tgrid.find_cell_direct(cfg, index, frame, pos),
                   lambda: tt.direct_lane_inputs(cfg, index, frame, pos, alive, pool)):
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(k)]
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            for a, b in ev:
                a.record()
                fn()
                b.record()
            torch.cuda.synchronize()
            times.append(statistics.median(a.elapsed_time(b) for a, b in ev))
        k_ms = times[0]
        kernel = (f"kernel {times[0]:.4f} ms a call, with the clamp and flags {times[1]:.4f} "
                  f"(device, median of {k})")
    else:
        k_ms, kernel = None, "no kernel on the CPU (find_cell_direct runs the plain version)"
    print(f"[direct lookup] {n} lanes on {frame.num_elements} cells ({cfg.dims.name} "
          f"{cfg.geometry.name}, uniform axes {index.uniform}): {int(want_in.sum())} in the "
          f"grid, values differing kernel vs plain version {differ}; {kernel}, plain version "
          f"{plain_ms:.3f} ms (host clock, median of 5)", flush=True)
    if differ:
        raise RuntimeError("the direct lookup kernel's cells differ from its plain version's")
    return k_ms, plain_ms


def frame_cols(res):
    """Lab energy (units of m_e c), scatterings and Stokes Q, U of the live
    photons of a FrameResult, float64 numpy."""
    ph = res.photons
    alive = ph.alive
    return {k: v.double().cpu().numpy() for k, v in dict(
        e=ph.p[alive, 0], ns=ph.num_scatt[alive], q=ph.s[alive, 1], u=ph.s[alive, 2]).items()}


def dump_cols(data):
    """The same columns of a merged npz dump (P0 is p0 x ME_C)."""
    from mcrat_tpu_torch import ME_C

    return dict(e=data["P0"] / ME_C, ns=data["NS"], q=data["S1"], u=data["S2"])


def same_outflow_check(a, b, keys=("e", "ns", "q"), limit=4.0):
    """Two frames of one outflow (``a`` and ``b``: (name, columns) pairs):
    the means of ``keys`` agree within ``limit`` sigma (standard errors of
    the two means); the scattered fraction ``scattered`` compares the share
    of photons with a scattering.  Prints each beside its limit."""
    bad = []
    (name_a, ca), (name_b, cb) = a, b
    for k in keys:
        xa, xb = ((c["ns"] > 0).astype(np.float64) if k == "scattered" else c[k]
                  for c in (ca, cb))
        ma, mb = xa.mean(), xb.mean()
        sa, sb = xa.std() / len(xa) ** 0.5, xb.std() / len(xb) ** 0.5
        z = abs(ma - mb) / max(np.hypot(sa, sb), 1e-30)
        print(f"[{name_b} vs {name_a}] mean {k}: {name_a} {ma:.6e} +- {sa:.2e}, {name_b} "
              f"{mb:.6e} +- {sb:.2e}: {z:.2f} sigma (limit {limit:g})", flush=True)
        if z > limit:
            bad.append(k)
    if bad:
        raise RuntimeError(f"{name_b}'s statistics differ from {name_a}'s: {bad}")


# the driver phase's run directory (git-ignored)
DRIVER_DIR = os.path.join(ROOT, "build", "driver_run")
DRIVER_LAST_FRAME = 4


class FrameTimings(logging.Handler):
    """Collects the driver's per-frame ``frame_timing`` log records."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        timing = getattr(record, "frame_timing", None)
        if timing is not None:
            self.rows.append(timing)


def driver_mcpar(path, n_inject, n_min, n_max, restart="i"):
    """mc.par of the driver phase: chip_smoke's spherical main frame and
    injection (r_inj 8e12 cm, theta 0-6 deg, fps 1, a blackbody) through
    the driver's default synthetic grid, injections at frames 0 ..
    n_inject, frames to DRIVER_LAST_FRAME."""
    from mcrat_tpu_torch import McPar, Spectrum, write_mcpar

    par = McPar(fps=1.0, last_frame=DRIVER_LAST_FRAME, r0_domain=(1e12, 9e13),
                r1_domain=(0.0, 0.31416), r2_domain=(0.0, 0.0), theta_min_deg=0.0,
                theta_max_deg=6.0, n_theta_bins=1, frm0=(0,), frm2=(n_inject,),
                inj_radius=(8e12,), spect=Spectrum.BLACKBODY, min_photons=n_min,
                max_photons=n_max, restart=restart)
    write_mcpar(par, path)
    return par


# the driver phase's frame: the 2-D spherical outflow on the default synthetic grid
DRIVER_CLI = ["--sim", "synthetic", "--geometry", "spherical", "--dims", "2",
              "--simulation-type", "spherical_outflow"]


def cli_run(run_dir, mcpar, device, *extra, base=DRIVER_CLI):
    """``mcrat_tpu_torch.cli run`` of ``base``'s frame (the driver phase's,
    unless given), npz dumps, ``extra`` options after; returns (stdout
    lines, wall s)."""
    import contextlib
    import io

    from mcrat_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["run", "--mcpar", mcpar, "--filepath", run_dir + "/", "--mc-path", "MC/",
                       *base, "--device", device.type, "--output", "npz", *extra])
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli run exited {rc}")
    return out.getvalue().splitlines(), wall


def cli_status(base):
    """``cli status`` of an MC directory, parsed."""
    import contextlib
    import io

    from mcrat_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["status", base, "--last-frame", str(DRIVER_LAST_FRAME)])
    return json.loads(out.getvalue())


def merged(mc_dir, frame):
    from mcrat_tpu_torch.io.photons_h5 import read_frame

    return read_frame(os.path.join(mc_dir, f"mcdata_{frame}.npz"))


def driver_phase(device, card, n_min, n_max):
    """The driver's main path (``cli run`` -> run_rank -> npz dumps -> merge,
    then ``status`` and ``analysis``) on the 2-D spherical default frame,
    injections at frames 0 and 1, frames 0-4, with its launch counts zeroed
    just before and read just after.  Prints each frame's ``frame_timing``
    record (transport, the wait for the writer, and the writer's fetch,
    checkpoint and dump).  Checks: frames 0-4 dumped; each merged frame
    holds the photons of the injections that reach it, its weight sum
    theirs to float32 rounding; frame 0 equals a hand-sequenced inject +
    transport_frame bit for bit; a run resumed from the ``.old`` checkpoint
    of a crash after frame 2 equals the main run's first injection on
    frames 0-4 bit for bit (the checkpoint carries both random streams);
    every rank done.  Returns the kernel's launches by instantiation in the
    main run."""
    import shutil

    from mcrat_tpu_torch import (ME_C, Config, Dims, Geometry, SimType, analysis, transport)
    from mcrat_tpu_torch.convert import photons_to_numpy
    from mcrat_tpu_torch.driver import decompose_work, default_synthetic_factory
    from mcrat_tpu_torch.io.hydro import HydroPaths, build_index, get_hydro_data
    from mcrat_tpu_torch.io.photons_h5 import discover_frames, dump_arrays, list_proc_files
    from mcrat_tpu_torch.ops import fused_round as fr

    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    main_dir, resume_dir = (os.path.join(DRIVER_DIR, d) for d in ("main", "resume"))
    for d in (main_dir, resume_dir):
        os.makedirs(d)
    mcpar = os.path.join(main_dir, "mc.par")
    par = driver_mcpar(mcpar, 1, n_min, n_max)
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW)
    work = decompose_work(par, 0, 1, os.path.join(main_dir, "MC/"))
    timings = FrameTimings()
    logger = logging.getLogger("mcrat_tpu_torch")
    logger.addHandler(timings)

    # the main run, its launch counts zeroed just before and read just after
    before = peak = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    zero_launches()
    lines, wall = cli_run(main_dir, mcpar, device, "--merge")
    launches, twin_launches = read_launches()
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
    rows = list(timings.rows)
    inst = fr.instantiation("packed_sph2", 0, None, True)
    for t in rows:
        print(f"[driver] {card}: injection {t['frame']} frame {t['scatt_frame']}: photons "
              f"{t['n_photons']}, scatterings {t['n_scatt']}, rounds {t['n_rounds']}, transport "
              f"{t['transport_s']:.4f} s, persistence wait {t['persist_wait_s']:.4f} s; the "
              f"writer: fetch {t['fetch_s']:.4f} s, checkpoint {t['checkpoint_s']:.4f} s, "
              f"npz dump {t['dump_s']:.4f} s", flush=True)
    print(f"[driver] {card}: cli run, {len(rows)} frames: {wall:.3f} s; peak device memory "
          f"{peak / 2**20:.1f} MiB, {(peak - before) / 2**20:.1f} MiB above the "
          f"{before / 2**20:.1f} MiB held before the run; merge {lines[-1] if lines else None}",
          flush=True)
    check_launches("driver", inst, launches, twin_launches, device)

    # what the merged frames must hold: the injections of a hand-sequenced
    # run of the same code (the same rng, frame 0's transport)
    paths = HydroPaths(filepath=main_dir + "/", mc_path="MC/")
    host, edges = default_synthetic_factory(cfg, par)(0)
    rng = np.random.default_rng(9876)
    injected = []
    for frame in (0, 1):
        host = get_hydro_data(cfg, paths, frame, par.fps, work.r_inj, True, synthetic_frame=host)
        injected.append(transport.inject_photons(
            host, work.r_inj, 1e50, par.min_photons, par.max_photons, par.spect,
            work.theta_min, work.theta_max, par.fps, rng)[0])
    n0, n1 = (len(a["weight"]) for a in injected)
    w0, w1 = (float(np.sum(a["weight"])) for a in injected)
    frames = discover_frames(list_proc_files(work.mc_dir))
    bad = [] if frames == list(range(DRIVER_LAST_FRAME + 1)) else [f"frames {frames}"]
    main_data = {f: merged(work.mc_dir, f) for f in frames}
    for f, data in main_data.items():
        n_want, w_want = (n0, w0) if f == 0 else (n0 + n1, w0 + w1)
        w_got = float(data["PW"].sum())
        print(f"[driver] merged frame {f}: {len(data['PW'])} photons (injected {n_want}), sum PW "
              f"{w_got:.9e} (injected {w_want:.9e})", flush=True)
        if len(data["PW"]) != n_want or abs(w_got - w_want) > 1e-6 * w_want:
            bad.append(f"frame {f} count/weight")

    cap = int(2 ** np.ceil(np.log2(n0 * cfg.capacity_factor)))
    photons, meta = transport.photons_from_arrays(injected[0], capacity=cap, device=device)
    res = transport.transport_frame(
        cfg, photons, host.to_device(device), build_index(cfg, host, edges, device=device), 1.0,
        torch.Generator().manual_seed(1234), stokes_on=True, chunk_rounds=256,
        fused=True if device.type == "cpu" else None)
    hand = dump_arrays(cfg, photons_to_numpy(res.photons), meta)
    differ = [k for k in hand if not np.array_equal(hand[k], main_data[0][k])]
    differ += [k for k in main_data[0] if k not in hand]
    print(f"[driver] frame 0 against a hand-sequenced inject + transport_frame (float64 x ME_C "
          f"= {ME_C:.6e}): {len(hand['P0'])} photons, datasets differing {differ}", flush=True)
    if differ:
        bad.append(f"frame 0 differs from the hand-sequenced frame in {differ}")

    # a crash just after frame 2's checkpoint: only mc_chkpt_0.npz.old
    # (restart c, scatt_frame 3) is left; the continued run resumes there
    mcpar_r = os.path.join(resume_dir, "mc.par")
    driver_mcpar(mcpar_r, 0, n_min, n_max)
    cli_run(resume_dir, mcpar_r, device, "--last-frame", "2")
    rdir = decompose_work(par, 0, 1, os.path.join(resume_dir, "MC/")).mc_dir
    os.remove(os.path.join(rdir, "mc_chkpt_0.npz"))
    driver_mcpar(mcpar_r, 0, n_min, n_max, restart="c")
    _, wall_r = cli_run(resume_dir, mcpar_r, device, "--merge")
    logger.removeHandler(timings)
    resumed = [t["scatt_frame"] for t in timings.rows[len(rows):]]
    print(f"[driver] resume: frames run {resumed} ({wall_r:.3f} s after the crash)", flush=True)
    if resumed != [0, 1, 2, 3, 4]:
        bad.append(f"resume ran frames {resumed}")
    for f in range(DRIVER_LAST_FRAME + 1):
        got, want = merged(rdir, f), {k: v[:n0] for k, v in main_data[f].items()}
        differ = sorted(set(got) ^ set(want)) + [
            k for k in want if k in got and not np.array_equal(got[k], want[k])]
        print(f"[driver] resume frame {f} ({'before' if f <= 2 else 'after'} the crash): "
              f"{len(got['PW'])} photons (main {n0}), datasets differing from the main run's "
              f"injection 0: {differ}", flush=True)
        if differ or len(got["PW"]) != n0:
            bad.append(f"resumed frame {f}")

    for base in (main_dir, resume_dir):
        report = cli_status(os.path.join(base, "MC"))
        ranks = [r for angle in report.values() for r in angle.values()]
        print(f"[driver] status {os.path.relpath(base, ROOT)}: {report}", flush=True)
        if not ranks or not all(r["done"] for r in ranks):
            bad.append(f"status of {base}")
    data = main_data[DRIVER_LAST_FRAME]
    band = (0.0, np.radians(6.0))
    print(f"[driver] analysis, merged frame {DRIVER_LAST_FRAME}, 0-6 deg: peak energy "
          f"{analysis.peak_energy_kev(data, *band):.6e} keV, polarization (Pi, Q/I, U/I) "
          f"{analysis.polarization(data, *band)}", flush=True)
    if bad:
        raise RuntimeError(f"driver phase failed: {bad}")
    return launches


# the cyclo-synchrotron phase's run directory (git-ignored) and its physics:
# bench.py:414-438's configuration
CS_DIR = os.path.join(ROOT, "build", "cs_run")
CS_CLI = ["--sim", "synthetic", "--geometry", "spherical", "--dims", "2", "--simulation-type",
          "cylindrical_outflow", "--cyclosynchrotron", "--b-field", "total_e", "--epsilon-b",
          "0.5", "--no-comv", "--chunk-rounds", "256", "--synthetic-grid", "256", "48"]


def cs_mcpar(path, n_min, n_max, fps, r_max, restart="i"):
    """mc.par of a cyclo-synchrotron run: one injection at frame 10 (r_inj
    8e12 cm, theta 0-6 deg, a blackbody), frames to 12."""
    from mcrat_tpu_torch import McPar, Spectrum, write_mcpar

    par = McPar(fps=fps, last_frame=12, r0_domain=(1e12, r_max), r1_domain=(0.0, 1.0),
                r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0, n_theta_bins=1,
                frm0=(10,), frm2=(10,), inj_radius=(8e12,), spect=Spectrum.BLACKBODY,
                min_photons=n_min, max_photons=n_max, restart=restart)
    write_mcpar(par, path)
    return par


def cs_frame_line(card, t, tag="cs"):
    print(f"[{tag}] {card}: injection {t['frame']} frame {t['scatt_frame']}: photons "
          f"{t['n_photons']}, scatterings {t['n_scatt']}, rounds {t['n_rounds']}; pool emitted "
          f"{t['n_pool_emitted']}, promoted {t['n_promoted']}, replaced {t['n_pool_replaced']}; "
          f"merged mid-frame {t['n_merged_mid']}, end of frame {t['n_merged_end']}; absorbed "
          f"{t['n_absorbed']}; transport {t['transport_s']:.4f} s, emission "
          f"{t['emission_s']:.4f} s, rebin {t['rebin_s']:.4f} s, absorption "
          f"{t['absorption_s']:.4f} s, persistence wait {t['persist_wait_s']:.4f} s", flush=True)


def proc_dumps(mc_dir):
    """Every per-process npz dump of a directory: (frame, batch) -> arrays."""
    out = {}
    for proc in sorted(glob.glob(os.path.join(mc_dir, "mc_proc_*"))):
        for path in sorted(glob.glob(os.path.join(proc, "*", "*.npz"))):
            frame, batch = path.split(os.sep)[-2], os.path.basename(path)
            with np.load(path) as z:
                out[os.path.basename(proc), frame, batch] = {k: z[k] for k in z.files}
    return out


def dumps_differ(a, b):
    """The dump files and datasets that differ between two proc_dumps."""
    return sorted(set(a) ^ set(b)) + [
        (key, k) for key in a if key in b for k in sorted(set(a[key]) | set(b[key]))
        if k not in a[key] or k not in b[key] or not np.array_equal(a[key][k], b[key][k])]


class RebinChecks:
    """Wraps ``ops.cyclosynch.rebin_population``, ``place_in_cells``,
    ``cell_nu_c`` and ``apply_absorption`` (the driver calls them through
    the module) to hold each rebin that fires to its weight (population +
    merged against the population before, relative 1e-6) and each
    absorption to F10: no photon that a rebin merged and placed, and that
    has not moved since, is absorbed while its comoving frequency,
    recomputed from its lab momentum and its cell's fluid velocity (the
    frame ``cell_nu_c`` was given, uploaded again here), is above nu_c.
    Each absorption records (such merged photons, those above nu_c, those
    absorbed above nu_c, every scattered-CS photon absorbed above nu_c):
    the last counts the photons whose ``comv_p``, written by their last
    round before their last move, puts them at or below nu_c, which the
    JAX package's absorption reads the same way."""

    NAMES = ("rebin_population", "place_in_cells", "cell_nu_c", "apply_absorption")

    def __init__(self, cfg):
        from mcrat_tpu_torch.ops import cyclosynch

        self.cfg, self.mod = cfg, cyclosynch
        self.orig = {k: getattr(cyclosynch, k) for k in self.NAMES}
        self.weight_err, self.rebins, self.f10, self.frame = [], 0, [], None
        self.placed = set()  # (pos, p) of the photons placed since the last absorption

    def __enter__(self):
        for k in self.NAMES:
            setattr(self.mod, k, getattr(self, "_" + k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.mod, k, fn)

    @staticmethod
    def _keys(photons, lanes):
        return [bytes(r) for r in torch.cat([photons.pos, photons.p], 1)[lanes].cpu().numpy()]

    def _rebin_population(self, cfg, photons, max_photons, n_cs, t_rem=None):
        out = self.orig["rebin_population"](cfg, photons, max_photons, n_cs=n_cs, t_rem=t_rem)
        if out[1] is not None:
            before = float(photons.weight.double().sum())
            after = float(out[0].weight.double().sum()) + float(out[1]["weight"].sum())
            self.weight_err.append(abs(after - before) / before)
            self.rebins += 1
        return out

    def _place_in_cells(self, cfg, frame, index, photons):
        out = self.orig["place_in_cells"](cfg, frame, index, photons)
        self.placed.update(self._keys(out, out.alive))
        return out

    def _cell_nu_c(self, cfg, host, device, dtype=torch.float32):
        self.frame = host.to_device(device, dtype=dtype)
        return self.orig["cell_nu_c"](cfg, host, device, dtype)

    def _apply_absorption(self, photons, nu_c):
        from mcrat_tpu_torch import H_OVER_MEC2, PhotonType
        from mcrat_tpu_torch.grid import fluid_beta_from_rows, gather_rows
        from mcrat_tpu_torch.ops import fused_round as fr

        out = self.orig["apply_absorption"](photons, nu_c)
        p, cell = photons.p, photons.cell
        beta = fluid_beta_from_rows(self.cfg, gather_rows(self.frame, cell), photons.pos[:, 0],
                                    photons.pos[:, 1])
        c0 = fr._boost(beta[:, 0], beta[:, 1], beta[:, 2], p[:, 0], p[:, 1], p[:, 2], p[:, 3])[0]
        nu = c0.double() / H_OVER_MEC2
        nu_cell = nu_c[torch.clamp(cell, 0, nu_c.shape[0] - 1).long()].double()
        is_cs = photons.alive & (cell >= 0) & (
            (photons.ptype == int(PhotonType.COMPTONIZED))
            | (photons.ptype == int(PhotonType.UNABSORBED_CS)))
        lanes = torch.nonzero(is_cs).flatten()
        hit = [k in self.placed for k in self._keys(photons, lanes)]
        merged = torch.zeros_like(is_cs)
        merged[lanes[torch.tensor(hit, dtype=torch.bool, device=lanes.device)]] = True
        self.placed = set()
        above = is_cs & (nu > 1.001 * nu_cell)
        absorbed = out[0].weight == 0
        self.f10.append((int(merged.sum()), int((merged & above).sum()),
                         int((merged & above & absorbed).sum()), int((above & absorbed).sum())))
        return out


def forced_runs(main_n):
    """The forced-rebin runs.  "main": the main run's configuration (CS_CLI,
    ``main_n`` photons), max_photons lowered to 2/3 of the fewest injected,
    the default 0.5-degree rebin angle; its 256-round chunks outlast a
    frame, so only the end-of-frame rebin can fire.  "toy":
    tests/test_cyclosynch.py:258-270's (fps 5, 300-1,200 photons, the
    128 x 24 grid, 8-round chunks, max_photons 200, a 0.1-degree rebin
    angle), where both rebins fire.  name -> (Config keywords, cs_mcpar's
    n_min, n_max, fps and r_max, the synthetic grid, chunk_rounds, the
    resume's max_photons)."""
    return {
        "main": (dict(comv=False), *main_n, 1.0, 9e13, (256, 48), 256, 2 * main_n[0] // 3),
        "toy": (dict(cs_rebin_ang=0.1), 300, 1200, 5.0, 5e13, (128, 24), 8, 200),
    }


def forced_rebin_run(device, fn, run_dir, spec, checks=True):
    """A forced-rebin run of ``spec`` (a :func:`forced_runs` entry) through
    ``fn`` (the kernel wrapper or its twin, as run_rank's rounds_fn), on
    ``device``: frame 10, then a crash after its checkpoint; the resume
    from the .old file, its photons marked scattered-CS (UNABSORBED_CS, as
    a checkpoint stores them) and max_photons lowered, runs frames 11-12.
    (In these configurations the pool gives 1-3 photons a frame and the
    scattered-CS population is its promoted photons, so no max_photons
    fires a rebin by itself.)  ``checks`` wraps the run in RebinChecks.
    Returns a namespace: dumps, frame_timing rows, (kernel, twin) launches,
    the RebinChecks or None, the photons marked, the resume's wall."""
    import contextlib
    import shutil
    import types

    from mcrat_tpu_torch import BFieldCalc, Config, Dims, Geometry, PhotonType, SimType
    from mcrat_tpu_torch.driver import default_synthetic_factory, run_rank
    from mcrat_tpu_torch.io import checkpoint as ck
    from mcrat_tpu_torch.io.hydro import HydroPaths
    from mcrat_tpu_torch.io.mcpar import read_mcpar

    cfg_kw, n_min, n_max, fps, r_max, (nr, ntheta), chunk_rounds, max_photons = spec
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, cyclosynchrotron=True,
                 b_field_calc=BFieldCalc.TOTAL_E, epsilon_b=0.5, **cfg_kw)
    mcpar = os.path.join(run_dir, "mc.par")
    cs_mcpar(mcpar, n_min, n_max, fps, r_max)
    par = read_mcpar(mcpar)  # as cli run reads it
    paths = HydroPaths(filepath=run_dir + "/", mc_path="MC/")
    kw = dict(chunk_rounds=chunk_rounds, device=device.type, output="npz", rounds_fn=fn,
              synthetic_frame_factory=default_synthetic_factory(cfg, par, nr=nr, ntheta=ntheta))
    timings = FrameTimings()
    logging.getLogger("mcrat_tpu_torch").addHandler(timings)
    chk = RebinChecks(cfg) if checks else None
    zero_launches()
    try:
        with chk if chk is not None else contextlib.nullcontext():
            work = run_rank(cfg, par, paths, last_frame_override=10, **kw)
            os.remove(ck.checkpoint_path(work.mc_dir, 0))
            state, photons = ck.read_checkpoint(work.mc_dir, 0)
            injected = photons["ptype"] == int(PhotonType.INJECTED)
            photons["ptype"][injected] = int(PhotonType.UNABSORBED_CS)
            ck.save_checkpoint(work.mc_dir, 0, state, photons)
            t0 = time.perf_counter()
            run_rank(cfg, dataclasses.replace(par, restart="c", max_photons=max_photons),
                     paths, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        logging.getLogger("mcrat_tpu_torch").removeHandler(timings)
    return types.SimpleNamespace(dumps=proc_dumps(work.mc_dir), rows=timings.rows,
                                 launches=read_launches(), checks=chk,
                                 n_marked=int(injected.sum()), wall=wall)


def cs_phase(device, card, n_min=150_000, n_max=400_000):
    """The cyclo-synchrotron driver (phase 8b).  The main run is bench.py's
    cyclo-synchrotron configuration through ``cli run --cyclosynchrotron``:
    the cylindrical outflow on default_synthetic_factory's 2-D spherical grid
    at 256 x 48 cells, TOTAL_E field with eps_B = 0.5, comv off, fps 1,
    injection at frame 10, frames 10-12, n_min-n_max photons, 256-round
    chunks, npz dumps, merged; its launch counts zeroed just before and read
    just after.  Then the forced-rebin runs (:func:`forced_runs`), each once
    through the kernel and once through the twin on the card; the main
    configuration's kernel pass runs without RebinChecks, so that its
    seconds are the driver's own.  Checks: every frame dumped with no pool
    photon; the main run through the kernel alone; each forced run's dumps
    identical bit for bit between kernel and twin, the main configuration's
    frame 10 identical to the main run's; the end-of-frame rebin fired in
    both forced runs and the mid-frame rebin in the toy one, the weight
    conserved across each rebin (relative 1e-6), merged photons reaching
    absorption and none absorbed above nu_c (F10), the kernel runs launching the kernel alone
    and the twin runs the twin alone; pool lanes promoted.  Returns the
    main run's kernel launches by instantiation."""
    import shutil

    from mcrat_tpu_torch.io.photons_h5 import discover_frames, list_proc_files
    from mcrat_tpu_torch.ops import fused_round as fr

    t_phase = time.perf_counter()
    shutil.rmtree(CS_DIR, ignore_errors=True)
    main_dir = os.path.join(CS_DIR, "main")
    os.makedirs(main_dir)
    mcpar = os.path.join(main_dir, "mc.par")
    cs_mcpar(mcpar, n_min, n_max, 1.0, 9e13)
    timings = FrameTimings()
    logger = logging.getLogger("mcrat_tpu_torch")
    logger.addHandler(timings)
    before = peak = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    zero_launches()
    try:
        lines, wall = cli_run(main_dir, mcpar, device, "--merge", base=CS_CLI)
    finally:
        logger.removeHandler(timings)
    launches, twin_launches = read_launches()
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
    for t in timings.rows:
        cs_frame_line(card, t)
    print(f"[cs] {card}: cli run --cyclosynchrotron, {len(timings.rows)} frames: {wall:.3f} s; "
          f"peak device memory {peak / 2**20:.1f} MiB, {(peak - before) / 2**20:.1f} MiB above "
          f"the {before / 2**20:.1f} MiB held before the run; merge "
          f"{lines[-1] if lines else None}", flush=True)
    inst = fr.instantiation("packed_sph2", 0, None, True)
    check_launches("cs", inst, launches, twin_launches, device)
    mc_dir = os.path.join(main_dir, "MC", "0-6")
    bad = []
    frames = discover_frames(list_proc_files(mc_dir))
    main_dumps = proc_dumps(mc_dir)
    if frames != [10, 11, 12]:
        bad.append(f"main run frames {frames}")
    pool = sum(int((d["PT"] == b"p").sum()) for d in main_dumps.values())
    pool += sum(int((merged(mc_dir, f)["PT"] == b"p").sum()) for f in frames)
    print(f"[cs] main run: frames {frames}, pool photons in the dumps {pool}", flush=True)
    if pool:
        bad.append("pool photons in the main run's dumps")

    # the forced-rebin runs, each through the kernel and through the twin
    promoted = sum(t["n_promoted"] for t in timings.rows)
    for size, spec in forced_runs((n_min, n_max)).items():
        runs = {}
        for name, fn in (("kernel", fr.fused_rounds), ("twin", fr.fused_rounds_reference)):
            tag = f"cs {size} forced, {name}"
            t0 = time.perf_counter()
            run = runs[name] = forced_rebin_run(
                device, fn, os.path.join(CS_DIR, f"forced_{size}_{name}"), spec,
                checks=(size, name) != ("main", "kernel"))
            for t in run.rows:
                cs_frame_line(card, t, tag)
            (lk, lt), chk = run.launches, run.checks
            mid, end = (sum(t[k] for t in run.rows) for k in ("n_merged_mid", "n_merged_end"))
            lanes = 1 << max(run.n_marked - 1, 0).bit_length()
            print(f"[{tag}] {card}: {time.perf_counter() - t0:.3f} s, the resume (frames "
                  f"11-12) {run.wall:.3f} s; {run.n_marked} photons marked scattered-CS, "
                  f"max_photons {spec[-1]}, the first rebin's fetch {lanes} lanes x 18 float32 "
                  f"= {lanes * 72 / 2**20:.1f} MiB; launches kernel {lk}, twin {lt}; merged "
                  f"mid-frame {mid}, end of frame {end}" + (
                      f"; rebins {chk.rebins}, weight error per rebin {chk.weight_err}; "
                      f"absorption (merged photons, above nu_c, absorbed above nu_c; every "
                      f"scattered-CS photon absorbed above nu_c) {chk.f10}"
                      if chk else " (no checks on this pass)"), flush=True)
            if not end or (size == "toy" and not mid):
                bad.append(f"{tag}: a rebin did not fire (mid {mid}, end {end})")
            if chk and (not chk.weight_err or max(chk.weight_err) > 1e-6):
                bad.append(f"{tag}: weight across the rebins {chk.weight_err}")
            if chk and (any(a[2] for a in chk.f10) or not any(a[0] for a in chk.f10)):
                bad.append(f"{tag}: merged photons absorbed above nu_c, or none reached "
                           f"absorption (F10)")
            if device.type == "cuda" and ((name == "kernel") != bool(sum(lk.values()))
                                          or (name == "twin") != bool(lt)):
                bad.append(f"{tag} launches: kernel {lk}, twin {lt}")
            pool = sum(int((d["PT"] == b"p").sum()) for d in run.dumps.values())
            got = sorted({k[1] for k in run.dumps})
            if pool or got != ["10", "11", "12"]:
                bad.append(f"{tag}: frames {got}, pool photons {pool}")
        promoted += sum(t["n_promoted"] for t in runs["kernel"].rows)
        differ = dumps_differ(runs["kernel"].dumps, runs["twin"].dumps)
        print(f"[cs {size} forced] dumps, kernel against twin: {len(runs['kernel'].dumps)} "
              f"files, differing {differ}", flush=True)
        if differ:
            bad.append(f"{size} forced-rebin dumps differ between kernel and twin")
        if size == "main":
            frame10 = {k: v for k, v in runs["kernel"].dumps.items() if k[1] == "10"}
            differ = dumps_differ(frame10, {k: v for k, v in main_dumps.items() if k[1] == "10"})
            print(f"[cs main forced] frame 10 against the main run's: {len(frame10)} files, "
                  f"differing {differ}", flush=True)
            if differ or not frame10:
                bad.append("the main configuration's frame 10 differs from the main run's")
    if not promoted:
        bad.append("no pool lane was promoted")
    print(f"[cs] phase 8b: {time.perf_counter() - t_phase:.3f} s", flush=True)
    if bad:
        raise RuntimeError(f"cyclo-synchrotron phase failed: {bad}")
    return launches


# phase 8c: the XLA engine (float64 and fused=False runs) and the PLUTO and
# RIKEN readers; run directories git-ignored
XLA_DIR = os.path.join(ROOT, "build", "xla_run")
READERS_DIR = os.path.join(ROOT, "build", "readers")


def count_syncs(fn):
    """(fn(), the device-to-host synchronizations it made): torch's sync
    debug mode warns at each; None off the card."""
    import warnings

    if not torch.cuda.is_available():
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def peak_run(fn, device):
    """(fn(), wall s, peak device memory above what was held before, bytes)."""
    before = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before if device.type == "cuda" else 0
    return out, wall, peak


XLA_KEYS = ("e", "ns", "scattered", "q", "u")


def xla_frames(device, card, n_min, n_max, prob32, kernel_res):
    """Phase 8c (a): the flagship frame through the XLA engine on the card,
    in float64 (``transport_frame(fused=None)`` on a float64 population of
    the same injection) and in float32 (``fused=False`` on the kernel
    path's photons), each held against the float32 kernel frame: mean lab
    energy, scatterings a photon, scattered fraction, mean Q and U within 5
    standard errors of the two means.  No kernel or twin launch may run.
    Prints the wall, rounds, ms a round, device-to-host syncs and peak
    device memory of each."""
    from mcrat_tpu_torch import transport
    from mcrat_tpu_torch.ops.prng import Key

    t0 = time.perf_counter()
    prob64 = problem("flagship", device, n_min, n_max, seed=0, dtype=torch.float64)
    print(f"[xla] flagship float64 frame + injection of {prob64.photons.capacity} photons: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if prob64.photons.capacity != prob32.photons.capacity:
        raise RuntimeError("the float64 injection differs from the float32 one")
    for label, prob, fused in (("float64, fused=None", prob64, None),
                               ("float32, fused=False", prob32, False)):
        zero_launches()
        (res, syncs), wall, peak = peak_run(lambda: count_syncs(lambda: transport.transport_frame(
            prob.cfg, prob.photons, prob.frame, prob.index, prob.dt_max,
            torch.Generator().manual_seed(2), chunk_rounds=64, fused=fused,
            key=Key.from_seed(2, device=device))), device)
        launches, twin = read_launches()
        print(f"[xla] flagship ({label}) {card}: engine {res.engine}, n_photons "
              f"{prob.photons.capacity}, n_scatt {res.n_scatt}, n_rounds {res.n_rounds}, wall "
              f"{wall:.4f} s, {1e3 * wall / max(res.n_rounds, 1):.3f} ms a round, "
              f"device-to-host syncs {syncs}, peak device memory {peak / 2**20:.1f} MiB above "
              f"the run's inputs; launches: kernel {launches}, twin {twin}", flush=True)
        if res.engine != "xla" or launches or twin:
            raise RuntimeError(f"the flagship ({label}) run did not take the XLA engine alone")
        print(f"[xla] flagship ({label}) checks {frame_checks(prob.photons, res)}", flush=True)
        same_outflow_check(("flagship kernel, float32", frame_cols(kernel_res)),
                           (f"flagship XLA, {label}", frame_cols(res)), XLA_KEYS, limit=5.0)
        del res
    del prob64


def xla_driver(device, card, n_min, n_max):
    """Phase 8c (b): ``cli run --dtype float64 --output npz --merge`` of the
    driver phase's configuration (one injection at frame 0, frames 0-2)
    through the XLA engine: every frame holds the injected photons with
    finite fields and positive weights, their weight conserved; a resume
    from the ``.old`` checkpoint a crash after frame 1 leaves equals the
    uninterrupted run bit for bit (the checkpoint carries the threefry
    key).  No kernel or twin launch may run."""
    import shutil

    from mcrat_tpu_torch.driver import decompose_work

    shutil.rmtree(XLA_DIR, ignore_errors=True)
    main_dir, resume_dir = (os.path.join(XLA_DIR, d) for d in ("main", "resume"))
    for d in (main_dir, resume_dir):
        os.makedirs(d)
    mcpar = os.path.join(main_dir, "mc.par")
    par = driver_mcpar(mcpar, 0, n_min, n_max)
    timings = FrameTimings()
    logger = logging.getLogger("mcrat_tpu_torch")
    logger.addHandler(timings)
    zero_launches()
    (lines, _), wall, peak = peak_run(lambda: cli_run(
        main_dir, mcpar, device, "--dtype", "float64", "--last-frame", "2", "--merge"), device)
    launches, twin = read_launches()
    for t in timings.rows:
        print(f"[xla driver] {card}: frame {t['scatt_frame']}: photons {t['n_photons']}, "
              f"scatterings {t['n_scatt']}, rounds {t['n_rounds']}, transport "
              f"{t['transport_s']:.4f} s, persistence wait {t['persist_wait_s']:.4f} s",
              flush=True)
    print(f"[xla driver] {card}: cli run --dtype float64, {len(timings.rows)} frames: "
          f"{wall:.3f} s, peak device memory {peak / 2**20:.1f} MiB above the run's start; "
          f"merge {lines[-1] if lines else None}; launches: kernel {launches}, twin {twin}",
          flush=True)
    bad = [] if not launches and not twin else ["kernel or twin launches"]
    counts = json.loads(lines[-1])
    mc_dir = decompose_work(par, 0, 1, os.path.join(main_dir, "MC/")).mc_dir
    main_data = {f: merged(mc_dir, f) for f in (0, 1, 2)}
    n0 = counts.get("0", 0)
    w0 = float(main_data[0]["PW"].sum())
    for f, data in main_data.items():
        finite = all(bool(np.isfinite(v).all()) for v in data.values() if v.dtype.kind == "f")
        w = float(data["PW"].sum())
        print(f"[xla driver] merged frame {f}: {len(data['PW'])} photons, sum PW {w:.9e}, "
              f"finite {finite}, mean NS {data['NS'].mean():.4f}", flush=True)
        if (len(data["PW"]) != n0 or not finite or not (data["PW"] > 0).all()
                or abs(w - w0) > 1e-9 * w0):
            bad.append(f"frame {f}")
    if not n_min <= n0 <= n_max:
        bad.append(f"{n0} photons injected")

    mcpar_r = os.path.join(resume_dir, "mc.par")
    driver_mcpar(mcpar_r, 0, n_min, n_max)
    cli_run(resume_dir, mcpar_r, device, "--dtype", "float64", "--last-frame", "1")
    rdir = decompose_work(par, 0, 1, os.path.join(resume_dir, "MC/")).mc_dir
    os.remove(os.path.join(rdir, "mc_chkpt_0.npz"))
    driver_mcpar(mcpar_r, 0, n_min, n_max, restart="c")
    n_rows = len(timings.rows)
    _, wall_r = cli_run(resume_dir, mcpar_r, device, "--dtype", "float64", "--last-frame", "2",
                        "--merge")
    logger.removeHandler(timings)
    resumed = [t["scatt_frame"] for t in timings.rows[n_rows:]]
    print(f"[xla driver] resume: frames run {resumed} ({wall_r:.3f} s after the crash)",
          flush=True)
    if resumed != [2]:
        bad.append(f"resume ran frames {resumed}")
    for f in (0, 1, 2):
        got, want = merged(rdir, f), main_data[f]
        differ = sorted(set(got) ^ set(want)) + [
            k for k in want if k in got and not np.array_equal(got[k], want[k])]
        print(f"[xla driver] resume frame {f}: datasets differing from the uninterrupted "
              f"run's: {differ}", flush=True)
        if differ:
            bad.append(f"resumed frame {f}")
    if bad:
        raise RuntimeError(f"float64 driver phase failed: {bad}")


def write_pluto_frames(directory, host, edges, frames, p_scale):
    """A PLUTO frame set of a 2-D host frame on the cell edges ``edges``
    (r0 slowest in the host's order), with numpy alone: grid.out (cell
    edges), dbl.out (rho vx1 vx2 prs) and data.NNNN.dbl (float64, x1
    fastest), pressures divided by ``p_scale`` as PLUTO stores them
    (tests/test_io.py:113-135)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "grid.out"), "w") as f:
        f.write("# PLUTO grid file\n# dimensions: 2\n")
        for e in edges:
            f.write(f"{len(e) - 1}\n")
            f.writelines(f"{i + 1} {float(e[i])!r} {float(e[i + 1])!r}\n"
                         for i in range(len(e) - 1))
        f.write("1\n1 0.0 1.0\n")
    with open(os.path.join(directory, "dbl.out"), "w") as f:
        f.write("0 0.0 1e-3 0 single_file little rho vx1 vx2 prs\n")
    shape = (len(edges[0]) - 1, len(edges[1]) - 1)
    data = np.concatenate([np.asarray(a, np.float64).reshape(shape).T.ravel() for a in (
        host.dens, host.v0, host.v1, host.pres / p_scale)])
    for frame in frames:
        data.tofile(os.path.join(directory, f"data.{frame:04d}.dbl"))


def write_riken_2d_frames(directory, host, edges, frames, p_scale):
    """A RIKEN 2-D frame set of a 2-D spherical host frame, with numpy alone:
    grid-x1.data and grid-x2.data (cell centres, comma-separated) and, per
    frame, u01/u02/u03/u08 (density, v_r, v_theta, pressure over
    ``p_scale``) as Fortran records: a float32 marker, six int32 slice
    indexes (1-based), two float32, float32 data with r fastest
    (tests/test_io.py:331-338)."""
    os.makedirs(directory, exist_ok=True)
    centres = [0.5 * (e[:-1] + e[1:]) for e in edges]
    for axis, c in zip((1, 2), centres):
        np.savetxt(os.path.join(directory, f"grid-x{axis}.data"), c[None], delimiter=", ")
    nr, nt = (len(c) for c in centres)
    idx = np.array([1, 1, 1, nt, 1, nr], np.int32)
    for frame in frames:
        for var, a in ((1, host.dens), (2, host.v0), (3, host.v1), (8, host.pres / p_scale)):
            with open(os.path.join(directory, f"u0{var}-{frame:04d}small.data"), "wb") as f:
                np.float32(0.0).tofile(f)
                idx.tofile(f)
                np.zeros(2, np.float32).tofile(f)
                np.asarray(a, np.float32).reshape(nr, nt).T.tofile(f)


def reader_mcpar(path, name, n_min, n_max):
    """mc.par of a reader run: the injection of the frame it holds (the
    flagship's for PLUTO, the 2-D spherical main path's for RIKEN), one
    injection at frame 0, frames 0-1."""
    from mcrat_tpu_torch import McPar, Spectrum, write_mcpar

    dt_max, fps, _ = PATHS[name]
    r_inj = 2e12 if name == "flagship" else 8e12
    par = McPar(fps=fps, last_frame=1, r0_domain=(0.0, 0.0), r1_domain=(0.0, 0.0),
                r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0, n_theta_bins=1,
                frm0=(0,), frm2=(0,), inj_radius=(r_inj,), spect=Spectrum.BLACKBODY,
                min_photons=n_min, max_photons=n_max, restart="i")
    write_mcpar(par, path)
    return par


def reader_phase(device, card, n_min, n_max, results):
    """Phase 8c (c): the PLUTO (.dbl) and RIKEN (2-D) readers through ``cli
    run`` on the card.  chip_smoke writes the flagship outflow on its 160 x
    512 grid as a PLUTO set and the 2-D spherical main frame (384 x 64) as a
    RIKEN set, two frames each, under build/readers/; each run (SCIENCE:
    the fields are the files') injects at frame 0 and transports frames 0
    and 1 on the readers' decimated cell lists behind a BinnedIndex (the
    carried path), launching its kernel instantiation alone (the twin 0).
    The same run then goes once more through the twin on the card (the same
    ``cli run``, its ``driver.run_rank`` given ``rounds_fn=
    fused_rounds_reference``, into MC_twin/): it launches the twin alone and
    its per-process npz dumps equal the kernel run's bit for bit.  Frame 0
    is held against the synthetic main path of the same outflow (mean
    energy, scatterings, Q within 4 sigma).  Returns the kernel launches by
    instantiation of each run."""
    import functools
    import shutil

    from mcrat_tpu_torch import Config, Dims, Geometry, HydroSim, SimType
    from mcrat_tpu_torch import driver
    from mcrat_tpu_torch.driver import decompose_work
    from mcrat_tpu_torch.grid import frame_from_numpy
    from mcrat_tpu_torch.models.analytic import (apply_simulation_type, make_grid_2d,
                                                 synthetic_spherical_frame)
    from mcrat_tpu_torch.ops import fused_round as fr

    shutil.rmtree(READERS_DIR, ignore_errors=True)
    out = {}
    for sim in ("pluto", "riken"):
        run_dir = os.path.join(READERS_DIR, sim)
        t0 = time.perf_counter()
        if sim == "pluto":
            name, geom, inst = "flagship", Geometry.CYLINDRICAL, "packed_cyl2"
            cfg = Config(sim_switch=HydroSim.PLUTO, dims=Dims.TWO, geometry=geom,
                         simulation_type=SimType.CYLINDRICAL_OUTFLOW)
            edges = (np.linspace(0.0, 3.2e11, 161), np.linspace(1.8e12, 2.9e12, 513))
            host = frame_from_numpy(cfg, make_grid_2d(cfg, *edges))
            apply_simulation_type(host)
            write_pluto_frames(run_dir, host, edges, (0, 1), cfg.hydro_p_scale)
            extra = ["--fileroot", "data."]
        else:
            name, geom, inst = "spherical", Geometry.SPHERICAL, "packed_sph2"
            cfg = Config(sim_switch=HydroSim.RIKEN, dims=Dims.TWO, geometry=geom,
                         simulation_type=SimType.SPHERICAL_OUTFLOW)
            host, edges = synthetic_spherical_frame(cfg, r_min=1e12, r_max=9e13, nr=384,
                                                    ntheta=64, theta_max=0.31416)
            write_riken_2d_frames(run_dir, host, edges, (0, 1), cfg.hydro_p_scale)
            extra = []
        mcpar = os.path.join(run_dir, "mc.par")
        par = reader_mcpar(mcpar, name, n_min, n_max)
        print(f"[{sim}] wrote {host.num_elements} cells x 2 frames: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        timings = FrameTimings()
        logger = logging.getLogger("mcrat_tpu_torch")
        logger.addHandler(timings)
        zero_launches()
        base = ["--sim", sim, "--geometry", geom.value, "--dims", "2", *extra]
        (lines, _), wall, peak = peak_run(lambda: cli_run(run_dir, mcpar, device, "--merge",
                                                          base=base), device)
        launches, twin = read_launches()
        logger.removeHandler(timings)
        for t in timings.rows:
            print(f"[{sim}] {card}: frame {t['scatt_frame']}: photons {t['n_photons']}, "
                  f"scatterings {t['n_scatt']}, rounds {t['n_rounds']}, transport "
                  f"{t['transport_s']:.4f} s, persistence wait {t['persist_wait_s']:.4f} s",
                  flush=True)
        print(f"[{sim}] {card}: cli run --sim {sim}, {len(timings.rows)} frames: {wall:.3f} s, "
              f"peak device memory {peak / 2**20:.1f} MiB above the run's start; merge "
              f"{lines[-1] if lines else None}", flush=True)
        check_launches(sim, fr.instantiation(inst), launches, twin, device)
        mc_dir = decompose_work(par, 0, 1, os.path.join(run_dir, "MC/")).mc_dir

        # the same run through the twin: cli run builds run_rank's inputs
        # as above, and run_rank takes the twin as its rounds_fn
        run_rank = driver.run_rank
        driver.run_rank = functools.partial(run_rank, rounds_fn=fr.fused_rounds_reference)
        zero_launches()
        try:
            _, twin_wall = cli_run(run_dir, mcpar, device, base=base + ["--mc-path", "MC_twin/"])
        finally:
            driver.run_rank = run_rank
        twin_lk, twin_lt = read_launches()
        twin_dir = decompose_work(par, 0, 1, os.path.join(run_dir, "MC_twin/")).mc_dir
        dumps, twin_dumps = proc_dumps(mc_dir), proc_dumps(twin_dir)
        differ = dumps_differ(dumps, twin_dumps)
        print(f"[{sim}] {card}: the same run through the twin: {twin_wall:.3f} s, launches "
              f"kernel {twin_lk}, twin {twin_lt}; dumps, kernel against twin: {len(dumps)} "
              f"files, differing {differ}", flush=True)
        if device.type == "cuda" and (sum(twin_lk.values()) or not twin_lt):
            raise RuntimeError(f"{sim}: the twin run launched kernel {twin_lk}, twin {twin_lt}")
        if differ or not dumps:
            raise RuntimeError(f"{sim}: the kernel run's dumps differ from the twin run's")
        del dumps, twin_dumps

        data = merged(mc_dir, 0)
        if not n_min <= len(data["PW"]) <= n_max:
            raise RuntimeError(f"{sim}: {len(data['PW'])} photons in frame 0")
        same_outflow_check((f"{name} (synthetic)", frame_cols(results[name, "direct"])),
                           (f"{sim} reader", dump_cols(data)))
        out[sim] = launches
    return out


# ---------------------------------------------------------------------------
# 8d. the photon axis over a mesh of shards and of processes; the serial oracle
# ---------------------------------------------------------------------------

# the mesh phase's run directories (git-ignored)
MESH_DIR = os.path.join(ROOT, "build", "mesh_run")
# each process of the two-process runs
MESH_PROCESS_TIMEOUT_S = 300

# the run directory's writes made by a process other than 0 (audit events)
MESH_AUDIT = r"""
import json, os, sys
WRITES = []


def _audit(root):
    root = os.path.realpath(root)
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def under(path):
        try:
            return os.path.realpath(os.fsdecode(path)).startswith(root)
        except TypeError:
            return False

    def hook(event, args):
        if event == "open" and args and args[0] is not None and not isinstance(args[0], int):
            mode, flags = args[1], args[2] or 0
            writes = (isinstance(mode, str) and any(c in mode for c in "wax+")) or (
                flags & write_flags)
            if writes and under(args[0]):
                WRITES.append((event, os.fsdecode(args[0])))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir",
                       "shutil.rmtree") and args and under(args[0]):
            WRITES.append((event, os.fsdecode(args[0])))

    sys.addaudithook(hook)
"""

# one process of the two-process driver run: gloo (two processes on one
# card), one shard each, the driver phase's frame through run_rank(mesh=)
MESH_WORKER = MESH_AUDIT + r"""
pid, port, outdir, phase, device = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                    sys.argv[5])
sys.path.insert(0, {root!r})
if pid != 0:
    _audit(outdir)
import logging, time
import torch
from mcrat_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed
TIMINGS = []
handler = logging.Handler()
handler.emit = lambda record: TIMINGS.append(getattr(record, "frame_timing", None))
logging.getLogger("mcrat_tpu_torch").addHandler(handler)
init_distributed(f"127.0.0.1:{{port}}", 2, pid, backend="gloo", device=device, timeout_s=240)
mesh = make_mesh(devices=[device])
from mcrat_tpu_torch import Config, Dims, Geometry, SimType, read_mcpar
from mcrat_tpu_torch.driver import default_synthetic_factory, merge_rank_outputs, run_rank
from mcrat_tpu_torch.io.hydro import HydroPaths
cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
             simulation_type=SimType.SPHERICAL_OUTFLOW)
par = read_mcpar(os.path.join(outdir, "mc.par"))
t0 = time.perf_counter()
work = run_rank(cfg, par, HydroPaths(filepath=outdir + "/", mc_path="MC/"),
                synthetic_frame_factory=default_synthetic_factory(cfg, par), device=device,
                output="npz", mesh=mesh, last_frame_override=1 if phase == "start" else 2)
if device.startswith("cuda"):
    torch.cuda.synchronize()
wall = time.perf_counter() - t0
if phase == "resume" and pid == 0:
    print("MERGED " + json.dumps(merge_rank_outputs(work, par, last_frame=2)), flush=True)
print("LAUNCHES " + json.dumps(dict(mesh.launches)), flush=True)
print(f"WALL {{wall:.3f}}", flush=True)
print("TIMING " + json.dumps([{{k: t[k] for k in ("scatt_frame", "n_photons", "transport_s",
                                                 "gather_s", "persist_wait_s")}}
                             for t in TIMINGS if t is not None]), flush=True)
shutdown_distributed()
print("WRITES " + json.dumps(WRITES), flush=True)
print(f"WORKER_OK pid={{pid}} phase={{phase}}", flush=True)
"""


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mesh_frames(device, card, prob, kernel_res):
    """8d (a): the flagship frame on a two-shard mesh of one device (the
    card twice), 64-round chunks with compaction: the kernel on both shards,
    the same call through the twin bit for bit, weight conserved, within 5
    sigma of the one-device kernel frame (mean energy, scatterings,
    scattered fraction, Q, U); a one-shard mesh bit for bit
    transport_frame.  Returns the kernel's launches by instantiation in the
    two-shard run."""
    from types import SimpleNamespace

    from mcrat_tpu_torch.ops import fused_round as fr
    from mcrat_tpu_torch.parallel import mesh as pm

    from mcrat_tpu_torch import transport

    fused = True if device.type == "cpu" else None
    photons = prob.photons
    if photons.capacity % 2:
        photons = transport.grow_photons(photons, photons.capacity + 1)[0]

    def run(mesh, rounds_fn, seed):
        return pm.sharded_transport_frame(
            prob.cfg, mesh, photons, prob.frame, prob.index, prob.dt_max,
            torch.Generator().manual_seed(seed), stokes_on=True, chunk_rounds=64,
            rounds_fn=rounds_fn, fused=fused)

    def same(a, b):
        a, b = (pm.fetch_global(x) for x in (a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return all(torch.equal(getattr(a, k), getattr(b, k)) for k in a.fields())

    bad = []
    mesh = pm.make_mesh(devices=[device, device])
    inst = instantiation_of(prob)
    zero_launches()
    res, wall, peak = peak_run(lambda: run(mesh, fr.fused_rounds, 11), device)
    launches, twin = read_launches()
    shards = [mesh.launches[i] for i in range(2)]
    got = pm.fetch_global(res.photons)
    print(f"[mesh] {card}: flagship frame, {prob.photons.capacity} photons over 2 shards of "
          f"{device}: {wall:.4f} s, {res.n_scatt} scatterings, {res.n_rounds} rounds, engine "
          f"{res.engine}; peak device memory {peak / 2**20:.1f} MiB; launches by shard "
          f"{shards}, by instantiation {launches}, twin {twin}", flush=True)
    if device.type == "cuda" and (res.engine != "kernel" or set(launches) != {inst} or twin
                                  or min(shards) == 0):
        bad.append("the two-shard frame did not launch the kernel on both shards alone")
    alive = got.alive
    if not (torch.equal(got.weight, photons.weight.cpu())
            and all(bool(torch.isfinite(x).all()) for x in (got.p, got.pos, got.s))
            and bool((pm.fetch_global(res.t_rem)[alive] <= 0).all()) and res.n_scatt > 0):
        bad.append("two-shard frame checks (weight, finite, finished, scatterings)")

    zero_launches()
    mesh.launches.clear()
    twin_res, twin_wall, _ = peak_run(lambda: run(mesh, fr.fused_rounds_reference, 11), device)
    lk, lt = read_launches()
    identical = same(twin_res.photons, res.photons) and same(twin_res.t_rem, res.t_rem)
    print(f"[mesh] {card}: the same two-shard frame through the twin: {twin_wall:.4f} s, "
          f"launches kernel {lk}, twin {lt}; identical photon for photon: {identical}",
          flush=True)
    if lk or not lt or not identical:
        bad.append("two-shard twin frame")
    same_outflow_check(("flagship one-device kernel frame", frame_cols(kernel_res)),
                       ("flagship 2-shard mesh", frame_cols(SimpleNamespace(photons=got))),
                       keys=XLA_KEYS, limit=5.0)

    one = pm.make_mesh(devices=[device])
    r1, wall1, _ = peak_run(lambda: run(one, fr.fused_rounds, 13), device)
    plain, wall0, _ = peak_run(lambda: run_frame(prob, 13, fr.fused_rounds,
                                                 dt_max=prob.dt_max), device)
    identical = same(r1.photons, plain.photons) and (r1.n_scatt, r1.n_rounds) == (
        plain.n_scatt, plain.n_rounds)
    print(f"[mesh] {card}: one-shard mesh {wall1:.4f} s, transport_frame {wall0:.4f} s, "
          f"identical photon for photon: {identical}", flush=True)
    if not identical:
        bad.append("one-shard mesh differs from transport_frame")
    if bad:
        raise RuntimeError(f"mesh frames failed: {bad}")
    return launches


def mesh_cli(device, card, n_min, n_max):
    """8d (b): ``cli run --mesh 1 --coordinator 127.0.0.1:<port> --num-hosts
    1 --host-id 0`` of the driver phase's configuration, frames 0-2 (NCCL at
    world size 1 on the card, gloo on the CPU): its per-process dumps equal
    the plain ``cli run``'s of the same frames bit for bit.  Returns the
    kernel's launches by instantiation in the mesh run."""
    import shutil

    from mcrat_tpu_torch.ops import fused_round as fr

    inst = fr.instantiation("packed_sph2", 0, None, True)
    dumps = {}
    for name, extra in (("plain", ()), ("cli", ("--mesh", "1", "--coordinator",
                                                f"127.0.0.1:{free_port()}", "--num-hosts", "1",
                                                "--host-id", "0"))):
        run_dir = os.path.join(MESH_DIR, name)
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        mcpar = os.path.join(run_dir, "mc.par")
        driver_mcpar(mcpar, 1, n_min, n_max)
        zero_launches()
        _, wall = cli_run(run_dir, mcpar, device, "--last-frame", "2", *extra)
        launches, twin = read_launches()
        print(f"[mesh cli] {card}: cli run {' '.join(extra)} (the {name} run), frames 0-2: "
              f"{wall:.3f} s", flush=True)
        check_launches(f"mesh cli ({name})", inst, launches, twin, device)
        dumps[name] = proc_dumps(os.path.join(run_dir, "MC", "0-6"))
    differ = dumps_differ(dumps["cli"], dumps["plain"])
    print(f"[mesh cli] {len(dumps['cli'])} dumps of cli run --mesh 1 against the plain cli "
          f"run's: differing {differ}", flush=True)
    if differ or not dumps["cli"]:
        raise RuntimeError(f"cli run --mesh 1 dumps differ from the plain run's: {differ}")
    return launches


def mesh_processes(device, card, n_min, n_max):
    """8d (c): two processes on one device (gloo), one shard each, the
    driver phase's frame with one injection, frames 0-2, npz: an
    uninterrupted run and, beside it, a run killed after frame 1 (its
    ``.old`` checkpoint restored), then resumed and merged.  Checks: every
    process exits 0 within its timeout; process 1 writes nothing under the
    run directory; the kernel launched in both processes; the resumed
    dumps equal the uninterrupted run's bit for bit; the merged frames
    within 4 sigma of the plain driver run's first injection."""
    import shutil

    dirs = {name: os.path.join(MESH_DIR, name) for name in ("full", "run")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        driver_mcpar(os.path.join(d, "mc.par"), 0, n_min, n_max)
    script = os.path.join(MESH_DIR, "worker.py")
    with open(script, "w") as f:
        f.write(MESH_WORKER.format(root=ROOT))
    dev = "cuda:0" if device.type == "cuda" else "cpu"

    def start(outdir, phase):
        port = free_port()
        return [subprocess.Popen([sys.executable, script, str(pid), str(port), outdir, phase,
                                  dev], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for pid in (0, 1)]

    def finish(procs, tag):
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH_PROCESS_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for pid, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or "WORKER_OK" not in out:
                raise RuntimeError(f"{tag} process {pid} exited {p.returncode}:\n{out[-3000:]}")
        field = {key: [json.loads(line.split(" ", 1)[1]) for out in outs
                       for line in out.splitlines() if line.startswith(key + " ")]
                 for key in ("LAUNCHES", "WALL", "WRITES", "MERGED", "TIMING")}
        print(f"[mesh processes] {card}: {tag}: run_rank walls {field['WALL']} s, kernel "
              f"launches by shard {field['LAUNCHES']}, process 1's writes under the run "
              f"directory {field['WRITES'][1]}; process 0's frames (transport, persistence "
              f"gather and wait, s) {field['TIMING'][0]}", flush=True)
        if field["WRITES"][1]:
            raise RuntimeError(f"{tag}: process 1 wrote {field['WRITES'][1]}")
        if device.type == "cuda" and not all(
                sum(launches.values()) > 0 for launches in field["LAUNCHES"]):
            raise RuntimeError(f"{tag}: the kernel did not launch in both processes")
        return field

    t0 = time.perf_counter()
    full, started = start(dirs["full"], "full"), start(dirs["run"], "start")
    finish(full, "uninterrupted run, frames 0-2")
    finish(started, "run to frame 1 (the kill)")
    mc_dir = os.path.join(dirs["run"], "MC", "0-6")
    chk = os.path.join(mc_dir, "mc_chkpt_0.npz")
    os.replace(chk + ".old", chk)
    driver_mcpar(os.path.join(dirs["run"], "mc.par"), 0, n_min, n_max, restart="c")
    resumed = finish(start(dirs["run"], "resume"), "resume from frame 2, merge")
    wall = time.perf_counter() - t0
    bad = []
    got, want = proc_dumps(mc_dir), proc_dumps(os.path.join(dirs["full"], "MC", "0-6"))
    differ = dumps_differ(got, want)
    print(f"[mesh processes] {card}: three two-process runs {wall:.3f} s; resumed dumps "
          f"{sorted(got)} against the uninterrupted run's: differing {differ}", flush=True)
    if differ or len(got) != 3:
        bad.append(f"resumed dumps {differ}")
    if len(resumed["MERGED"]) != 1:
        bad.append(f"merge {resumed['MERGED']}")
    main_dir = os.path.join(DRIVER_DIR, "main", "MC", "0-6")
    n0 = len(merged(main_dir, 0)["PW"])
    for f in range(3):
        data = merged(mc_dir, f)
        plain = {k: v[:n0] for k, v in merged(main_dir, f).items()}
        print(f"[mesh processes] merged frame {f}: {len(data['PW'])} photons (plain run's "
              f"first injection {n0})", flush=True)
        if len(data["PW"]) != n0:
            bad.append(f"frame {f} count")
        same_outflow_check((f"plain driver frame {f}", dump_cols(plain)),
                           (f"two-process mesh frame {f}", dump_cols(data)))
    if bad:
        raise RuntimeError(f"two-process mesh runs failed: {bad}")


def serial_phase(device, card):
    """8d (e): the serial oracle in float64 on tests/test_serial_equivalence.py's
    frame (the uniform cylindrical outflow on 64 x 128 cells, 300-1,200
    photons, a 0.03 s window) against the XLA engine on the same device, by
    that test's checks: scatterings within 5 sigma, mean energy within 5 %,
    mean scatterings within 5 standard errors, mean radius within 1e-3."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType, Spectrum, serial, transport
    from mcrat_tpu_torch.grid import build_rectilinear_index, frame_from_numpy
    from mcrat_tpu_torch.models.analytic import apply_simulation_type, make_grid_2d
    from mcrat_tpu_torch.ops.prng import Key

    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float64")
    r0_edges, r1_edges = np.linspace(0.0, 3.2e11, 65), np.linspace(1.8e12, 2.6e12, 129)
    host = frame_from_numpy(cfg, make_grid_2d(cfg, r0_edges, r1_edges))
    apply_simulation_type(host)
    arrays, _ = transport.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=300, max_photons=1200,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30, fps=5.0,
        rng=np.random.default_rng(0))
    frame = host.to_device(device, dtype=torch.float64)
    index = build_rectilinear_index(r0_edges, r1_edges, dtype=torch.float64, device=device)
    photons, _ = transport.photons_from_arrays(arrays, dtype=torch.float64, device=device)
    res_b, wall_b, _ = peak_run(lambda: transport.transport_frame(
        cfg, photons, frame, index, 0.03, key=Key.from_seed(11)), device)
    res_s, wall_s, _ = peak_run(lambda: serial.transport_frame_serial(
        cfg, photons, frame, index, 0.03, Key.from_seed(22)), device)
    nb, ns = res_b.n_scatt, res_s.n_scatt
    e_b, e_s = (float(transport.average_photon_energy(r.photons)) for r in (res_b, res_s))
    ns_b, ns_s = (r.photons.num_scatt.cpu().numpy() for r in (res_b, res_s))
    se = np.sqrt(ns_b.var() / len(ns_b) + ns_s.var() / len(ns_s))
    r_b, r_s = (float(r.photons.pos.norm(dim=1).mean()) for r in (res_b, res_s))
    checks = {
        "scatterings > 50": nb > 50 and ns > 50,
        "scatterings within 5 sigma": abs(nb - ns) < 5.0 * np.sqrt(nb + ns),
        "mean energy within 5 %": abs(e_b - e_s) / e_s < 0.05,
        "mean scatterings within 5 se": abs(ns_b.mean() - ns_s.mean()) < 5.0 * se + 1e-9,
        "mean radius within 1e-3": abs(r_b - r_s) / r_s < 1e-3,
    }
    print(f"[serial] {card}: {len(arrays['weight'])} photons, float64 on {device}: the XLA "
          f"engine {wall_b:.3f} s ({nb} scatterings, engine {res_b.engine}), the serial "
          f"oracle {wall_s:.3f} s ({ns} scatterings, {res_s.n_events_attempted} candidates "
          f"walked); checks {checks}", flush=True)
    if res_b.engine != "xla" or not all(checks.values()):
        raise RuntimeError(f"serial oracle checks failed: {checks}")


def mesh_phase(device, card, n_min, n_max, flagship, flagship_res):
    """Phase 8d: the photon axis over a mesh (mesh_frames, mesh_cli,
    mesh_processes, dryrun_multichip(4)) and the serial oracle.  Returns the
    kernel's launches by instantiation in the in-process mesh runs (the
    two-shard flagship frame, the mesh cli run and the dry run's, each
    counted from 0 just before it and read just after)."""
    from mcrat_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    launches = collections.Counter(mesh_frames(device, card, flagship, flagship_res))
    launches.update(mesh_cli(device, card, n_min, n_max))
    mesh_processes(device, card, n_min, n_max)
    zero_launches()
    out, wall, _ = peak_run(lambda: dryrun_multichip(4, device.type), device)
    lk, lt = read_launches()
    print(f"[mesh dryrun] {card}: dryrun_multichip(4, {device.type!r}): {wall:.3f} s, {out}; "
          f"launches kernel {lk}, twin {lt}", flush=True)
    if device.type == "cuda" and (not lk or lt):
        raise RuntimeError("dryrun_multichip did not run through the kernel alone")
    launches.update(lk)
    serial_phase(device, card)
    print(f"[mesh] phase 8d: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return dict(launches)


def main(device_name="cuda", n_min=600_000, n_max=1_400_000, hot_n=(150_000, 300_000),
         side_n=(150_000, 450_000), cs_n=(150_000, 400_000), xla_n=(100_000, 200_000)):
    # 0. device
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[device] nvidia-smi: {smi}", flush=True)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)
    if device_name == "cuda" and not torch.cuda.is_available():
        print("[device] no CUDA device: nothing runs on the CPU", file=sys.stderr)
        return 1
    device = torch.device(device_name)
    card = f"{torch.cuda.get_device_name(0)} ({smi})" if device.type == "cuda" else "cpu"

    from mcrat_tpu_torch import Config, _build
    from mcrat_tpu_torch.ops import fused_round as fr
    from mcrat_tpu_torch.ops.binned_search import binned_search
    from mcrat_tpu_torch.ops.direct_lookup import direct_lookup

    # 1. build, tables, F6
    resources = {}  # instantiation -> threads, registers, local memory, shared memory
    if device.type == "cuda":
        print(f"[build] {sh([_build.find_nvcc(), '--version']).splitlines()[-1]}", flush=True)
        info = _build.build()
        print(f"[build] {info['path'].name}: built={info['built']}, six concurrent nvcc over "
              f"{len(fr.instantiations())} instantiations: {info['seconds']:.2f} s", flush=True)
        resources = library_resources(_build.load_fused_round())
    tables = xsec_tables(Config(), device)
    f6_check(device)

    # 2. kernel vs twin on the card, every instantiation on a frame that selects it
    probs, errs, times, bounds = {}, {}, {}, {}
    for name, mode in CASES:
        big = mode == "direct" and name in ("flagship", "spherical", "cartesian_3d")
        t0 = time.perf_counter()
        prob = probs[name, mode] = problem(name, device, *((n_min, n_max) if big else side_n),
                                           mode=mode, tables=tables, spread=mode != "direct")
        print(f"[setup] {name} ({mode}) frame + injection of {prob.photons.capacity} photons: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for stokes_on in (True, False):
            inst, err, k_ms, t_ms, bnd, _ = kernel_vs_twin(
                f"{name} ({mode}), Stokes {'on' if stokes_on else 'off'}", prob, stokes_on,
                time_it=True)
            errs[inst] = max(errs.get(inst, 0.0), err)
            times.setdefault(inst, (k_ms, t_ms))
            bounds.setdefault(inst, bnd)
        if (name, mode) == ("flagship", "direct"):
            hot = problem("flagship", device, *hot_n, seed=1, hot=True)
            inst, err, *_ = kernel_vs_twin("hot 5e8 K, block 1 idle, pool lanes", hot, True,
                                           idle_block=1, pool_lanes=True)
            errs[inst] = max(errs[inst], err)
            del hot

    # the main paths' own frames, kernel vs twin (the DIRECT main paths'
    # rectilinear frames are the flagship and spherical cases above; the
    # TABLE case there is a spread-temperature side frame, not bench.py's)
    mains = {}
    for (name, mode), (seed, hot) in MAIN.items():
        if mode == "direct" and (name, mode) in probs:
            mains[name, mode] = probs[name, mode]
            continue
        t0 = time.perf_counter()
        prob = mains[name, mode] = problem(name, device, n_min, n_max, seed=seed, hot=hot,
                                           mode=mode, tables=tables)
        print(f"[setup] {name} ({mode}) main path, {prob.frame.num_elements} cells, "
              f"{prob.photons.capacity} photons: {time.perf_counter() - t0:.2f} s", flush=True)
        for stokes_on in (True, False):
            inst, err, *_ = kernel_vs_twin(
                f"{name} ({mode}) main path, Stokes {'on' if stokes_on else 'off'}", prob,
                stokes_on)
            errs[inst] = max(errs[inst], err)
    # the scatter queue's edge cases, on the lead instantiations' main
    # frames and on the flagship's
    for key in (("flagship", "nt"), ("amr_cyl2", "aux_nt"), ("flagship", "direct")):
        for stokes_on in (True, False):
            call = edge_call(mains[key], stokes_on)
            inst, err, *_ = kernel_vs_twin(
                f"{key[0]} ({key[1]}) compaction edge cases {EDGE_ACCEPTS}, all-stall block, "
                f"idle block between active ones, Stokes {'on' if stokes_on else 'off'}",
                None, stokes_on, call=call)
            errs[inst] = max(errs[inst], err)
    amr_lookup_check(mains["amr_cyl2", "direct"])
    binned_search_check(mains["amr_cyl2", "direct"])
    for name in ("flagship", "spherical"):
        direct_lookup_check(mains[name, "direct"])

    # 3.-6b. the main paths: flagship, 2-D spherical, TABLE, nonthermal, AMR
    launches, owner = {}, {}  # instantiation -> launches, the path they come from

    def count(path, lk):
        for k, v in lk.items():
            if k not in launches:
                launches[k], owner[k] = v, path

    results = {}
    for (name, mode), prob in mains.items():
        path = name if mode == "direct" else f"{name} ({mode})"
        searched, looked_up = binned_search.launches, direct_lookup.launches
        lk, results[name, mode] = main_path(path, prob, card, device)
        count(f"{path} main path", lk)
        if (name, mode) == ("flagship", "direct"):
            lookup_launches = direct_lookup.launches - looked_up
            print(f"[{path}] direct lookup kernel launches on the main path: {lookup_launches}",
                  flush=True)
            if device.type == "cuda" and not lookup_launches:
                raise RuntimeError("the flagship main path never launched the direct lookup "
                                   "kernel")
        if (name, mode) == ("amr_cyl2", "direct"):
            search_launches = binned_search.launches - searched
            print(f"[{path}] search kernel launches on the main path: {search_launches}",
                  flush=True)
            if device.type == "cuda" and not search_launches:
                raise RuntimeError("the AMR main path never launched the search kernel")
    same_outflow_check(("flagship", frame_cols(results["flagship", "direct"])),
                       ("amr_cyl2", frame_cols(results["amr_cyl2", "direct"])))

    # 7. every other frame once, Stokes on and off
    for (name, mode), prob in probs.items():
        if (name, mode) in MAIN:
            continue
        ms, res, lk, lt = frame_once(prob, 1, fr.fused_rounds, device)
        check_launches(f"{name} ({mode})", instantiation_of(prob), lk, lt, device, res.engine)
        checks = frame_checks(prob.photons, res)
        report_frame(f"{name} ({mode})", prob, res, ms, card, "once")
        print(f"[{name} ({mode})] checks {checks}", flush=True)
        count(f"{name} ({mode})", lk)
        count(f"{name} ({mode}), Stokes off", frame_stokes_off(f"{name} ({mode})", prob, card,
                                                                device))

    # 8. the driver's main path; 8b. the cyclo-synchrotron driver; 8c. the
    # XLA engine and the PLUTO and RIKEN readers
    driver_launches = driver_phase(device, card, n_min, n_max)
    cs_launches = cs_phase(device, card, *cs_n)
    xla_frames(device, card, n_min, n_max, mains["flagship", "direct"],
               results["flagship", "direct"])
    xla_driver(device, card, *xla_n)
    reader_launches = reader_phase(device, card, n_min, n_max, results)
    # 8d. the photon axis over a mesh of shards and of processes; the serial oracle
    mesh_launches = mesh_phase(device, card, n_min, n_max, mains["flagship", "direct"],
                               results["flagship", "direct"])

    # 9. result lines
    names = fr.instantiations()
    missing = [n for n in names if n not in errs or n not in times or (
        device.type == "cuda" and not launches.get(n))]
    if missing:
        raise RuntimeError(f"instantiations not checked or not launched on a path: {missing}")
    for n in names:
        print(f"[launches] {n}: {launches.get(n, 0)}, from the {owner.get(n)} run", flush=True)

    def replaces(inst):
        var = fr.VARIANTS[inst.split("+")[0].split("/")[0]]
        nt = "+nt" in inst
        if "+cheb" in inst:
            extra = ",890-944,968-985" if nt else ",890-931,968-985"
        else:
            extra = ",71-75,784-788,879-888,1072-1080" if "+aux" in inst else ""
        return (f"mcrat_tpu/ops/pallas_round.py:1185 ({var.replaces}{extra}"
                f"{',318-406,1019-1035' if nt else ''})")

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": f"fused_rounds[{n}]", "route": "cuda",
        "source": "mcrat_tpu_torch/csrc/fused_round.cu", "replaces": replaces(n),
        "launches": launches.get(n, 0), "driver_launches": driver_launches.get(n, 0),
        "cs_launches": cs_launches.get(n, 0),
        "pluto_launches": reader_launches["pluto"].get(n, 0),
        "riken_launches": reader_launches["riken"].get(n, 0),
        "mesh_launches": mesh_launches.get(n, 0),
        "max_abs_err": errs[n],
        "ms": times[n][0], "plain_ms": times[n][1],
        "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "bound_pipe": bounds[n][2],
        "library_ms": None,
        **({"threads": resources[n]["threads"], "registers": resources[n]["registers"],
            "local_bytes": resources[n]["local_bytes"],
            "smem_bytes": resources[n]["dyn_smem"] + resources[n]["static_smem"]}
           if n in resources else {}),
    } for n in names]}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "binned_search", "route": "cuda", "source": "mcrat_tpu_torch/csrc/binned_search.cu",
        "replaces": None, "launches": search_launches}, {
        "name": "direct_lookup", "route": "cuda", "source": "mcrat_tpu_torch/csrc/direct_lookup.cu",
        "replaces": None, "launches": lookup_launches}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "count": torch.cuda.device_count() if device.type == "cuda" else 0,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
