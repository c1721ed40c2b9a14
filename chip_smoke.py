#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcrat_tpu_torch) on one NVIDIA GPU.

Drives the port's paths -- inject_photons -> photons_from_arrays ->
transport_frame, DIRECT optical depth, thermal electrons, Stokes on, float32
-- through the hand-written CUDA fused-round kernel, and checks them:

  0. device: nvidia-smi name/power limit, torch, CUDA and nvcc versions;
     exits non-zero without a CUDA device;
  1. build: compiles csrc/fused_round.cu with nvcc (wall time, ptxas report);
  2. kernel vs its plain twin on the card, for every kernel variant, on real
     lanes of a frame that selects it (Stokes on, timed, and Stokes off):
     the flagship (ultra_cyl2, plus a hot 5e8 K frame with one idle block),
     the 2-D spherical main grid (packed_sph2) and the same grid with linear
     radii (ultra_sph2), the flagship grid with geomspace z edges (slim_cyl2)
     and with a phi-hat velocity (packed_cyl2), 2.5-D cylindrical and
     spherical frames (packed_cyl25, packed_sph25), the bench 3-D cartesian
     frame (ultra_cart3) and the same with geomspace z edges (packed_cart3),
     3-D spherical 128x32x32 (packed_sph3) and 3-D polar 64x32x128
     (packed_pol3) frames;
  3. the flagship path -- the 2-D cylindrical Gamma=100 outflow, 160x512
     uniform grid, ~1M photons, 64-round chunks with compaction: one warm-up
     + median of 3 transport_frame runs, with the kernel's launch count (the
     twin's must stay 0) and the frame checks;
  4. the flagship frame with the twin on the card, timed once, statistics held
     against the kernel's;
  5. the 2-D spherical main path -- the JAX driver's default synthetic grid
     (384 log-spaced radii x 64 theta cells), spherical outflow, ~1M photons,
     fps = 1: the same as 3. and 4.;
  6. the 3-D cartesian frame of bench.py (64^3 cells, ~1M photons) once
     through the kernel, with the frame checks;
  7. every other variant's frame once through the kernel, with the frame
     checks;
  8. prints the kernels' JSON line, then {"ok": true, "device": {...}} last.

Each path's launch counts are set to 0 just before it runs and read just
after.  Run from the repository root: ``python3 chip_smoke.py``.  Imports no
JAX.
"""
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# lane-for-lane match on the card: NS and out-flags identical, every state
# plane within this tolerance (same CUDA math functions, FMA contraction off
# in the kernel, so agreement is expected to the last bits)
MATCH_RTOL, MATCH_ATOL = 1e-4, 1e-6
MIN_MATCH = 0.999


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
}


def problem(name, device, n_min, n_max, seed=0, hot=False):
    """(cfg, photons, frame, index) of one path's frame, set up as the
    repository sets it up: the flagship as bench.py:63-92, the spherical
    main grid as mcrat_tpu/driver.py:901-921 for the mc.par of
    bench.py:424-430, the 3-D cartesian frame as bench.py:95-127, the 3-D
    spherical and polar frames as tests/test_pallas_round.py:281-324 at
    128x32x32 and 64x32x128 cells."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType, Spectrum, transport
    from mcrat_tpu_torch.grid import build_rectilinear_index, frame_from_numpy
    from mcrat_tpu_torch.models.analytic import (
        apply_simulation_type, make_grid_2d, synthetic_spherical_frame)

    inj = dict(r_inj=2e12, theta_max=np.pi / 30)
    if name.startswith("spherical") and "3d" not in name:
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
    index = build_rectilinear_index(*edges, device=device)
    arrays, _ = transport.inject_photons(
        host, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, fps=PATHS[name][1],
        rng=np.random.default_rng(seed), **inj)
    photons, _ = transport.photons_from_arrays(arrays, device=device)
    frame = host.to_device(device)
    variant = transport.select_variant(cfg, frame, index)[0]
    if variant != PATHS[name][2]:
        raise RuntimeError(f"{name} selects {variant}, not {PATHS[name][2]}")
    return cfg, photons, frame, index


def kernel_vs_twin(name, cfg, photons, frame, index, stokes_on, idle_block=None,
                   pool_lanes=False, time_it=False, s_rows=128, seed=20240917):
    """One fused_rounds call (inner_rounds=4) over every lane, kernel and
    twin on the same inputs; ``pool_lanes`` marks every 7th live lane as a
    CS pool photon.  Returns (max_abs_err over matching lanes, kernel ms,
    twin ms)."""
    from mcrat_tpu_torch import transport
    from mcrat_tpu_torch.grid import find_cell_direct
    from mcrat_tpu_torch.ops import fused_round as fr

    device = photons.device
    t_rem = transport.frame_time(photons, 0.2)
    state, alive, pool = transport.lane_planes(photons, t_rem, s_rows)
    if pool_lanes:
        pool = alive & (torch.arange(alive.numel(), device=device) % 7 == 3)
    cell, in_grid = find_cell_direct(cfg, index, frame, state[fr.SP_X: fr.SP_Z + 1].T)
    safe = torch.clamp(cell, 0, frame.num_elements - 1).to(torch.int32)
    flags = transport.lane_flags(alive, pool, in_grid)
    block_lanes = s_rows * fr.LANES
    block_act = torch.ones(state.shape[1] // block_lanes, dtype=torch.int32, device=device)
    if idle_block is not None:
        block_act[idle_block] = 0
    grid = transport.grid_scalars(frame, index)
    variant, table = transport.select_variant(cfg, frame, index)
    args = (safe, flags, table, block_act, seed, grid)
    kw = dict(stokes_on=stokes_on, inner_rounds=4, block_lanes=block_lanes, variant=variant)
    sk, st = state.clone(), state.clone()
    ok_ = fr.fused_rounds(sk, *args, **kw)
    ot_ = fr.fused_rounds_reference(st, *args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    lane_on = torch.repeat_interleave(block_act != 0, block_lanes)
    live = lane_on & alive
    same = (sk[fr.SP_NS] == st[fr.SP_NS]) & (ok_ == ot_)
    close = torch.isclose(sk, st, rtol=MATCH_RTOL, atol=MATCH_ATOL).all(dim=0)
    n_live = int(live.sum())
    frac_same = float((same & live).sum()) / max(n_live, 1)
    frac_match = float((same & close & live).sum()) / max(n_live, 1)
    agree = same & live
    err = (sk[:, agree] - st[:, agree]).abs()
    rel = err / st[:, agree].abs().clamp(min=1e-30)
    max_abs = float(err.max()) if err.numel() else 0.0
    idle_ok = bool(torch.equal(sk[:, ~lane_on], state[:, ~lane_on])
                   and torch.equal(st[:, ~lane_on], state[:, ~lane_on])
                   and not ok_[~lane_on].any())
    print(f"[kernel-vs-twin] {name} ({variant}): live lanes {n_live}, scatterings kernel "
          f"{int(sk[fr.SP_NS].sum() - state[fr.SP_NS].sum())} twin "
          f"{int(st[fr.SP_NS].sum() - state[fr.SP_NS].sum())}; lanes differing in NS/out-flags "
          f"{1.0 - frac_same:.3e}; lanes outside rtol {MATCH_RTOL}/atol {MATCH_ATOL} "
          f"{1.0 - frac_match:.3e}; max abs err {max_abs:.3e}, max rel err "
          f"{float(rel.max()) if rel.numel() else 0.0:.3e}; idle lanes untouched {idle_ok}",
          flush=True)
    if frac_match < MIN_MATCH or not idle_ok:
        raise RuntimeError(f"kernel disagrees with its twin ({name})")
    k_ms = t_ms = None
    if time_it:
        def run(fn):
            s = state.clone()
            return lambda: fn(s, *args, **kw)
        for fn in (fr.fused_rounds, fr.fused_rounds_reference):
            run(fn)()  # warm-up
        k_ms = float(np.median([timed(run(fr.fused_rounds), device) for _ in range(5)]))
        t_ms = float(np.median([timed(run(fr.fused_rounds_reference), device) for _ in range(5)]))
        print(f"[kernel-vs-twin] {name} ({variant}): one fused_rounds call ({state.shape[1]} lanes, "
              f"4 rounds): kernel {k_ms:.3f} ms, twin {t_ms:.3f} ms (median of 5)", flush=True)
    return max_abs, k_ms, t_ms


def run_frame(cfg, photons, frame, index, seed, rounds_fn, dt_max=0.2):
    from mcrat_tpu_torch import transport

    return transport.transport_frame(
        cfg, photons, frame, index, dt_max, torch.Generator().manual_seed(seed),
        chunk_rounds=64, rounds_fn=rounds_fn)


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


def frame_once(name, prob, seed, rounds_fn, card, device):
    """One transport_frame of a path through ``rounds_fn``, its launch counts
    zeroed just before and read just after.  Returns (ms, FrameResult,
    kernel launches by variant, twin launches)."""
    from mcrat_tpu_torch.ops import fused_round as fr

    cfg, photons, frame, index = prob
    fr.fused_rounds.launches = 0
    fr.fused_rounds.variant_launches.clear()
    fr.fused_rounds_reference.launches = 0
    out = []
    ms = timed(lambda: out.append(run_frame(cfg, photons, frame, index, seed, rounds_fn,
                                            dt_max=PATHS[name][0])), device)
    return ms, out[0], dict(fr.fused_rounds.variant_launches), fr.fused_rounds_reference.launches


def check_launches(name, launches, twin_launches, device):
    variant = PATHS[name][2]
    print(f"[{name}] launches: kernel {launches}, twin {twin_launches}", flush=True)
    if device.type == "cuda" and (launches.get(variant, 0) == 0 or twin_launches != 0
                                  or set(launches) != {variant}):
        raise RuntimeError(f"the {name} path did not run through the {variant} kernel alone")


def report_frame(name, prob, res, elapsed_ms, card, what):
    from mcrat_tpu_torch import transport

    n_ph = prob[1].capacity
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
    through the twin, statistics held against the kernel's.  Returns the
    kernel launches of the timed runs."""
    from mcrat_tpu_torch.ops import fused_round as fr

    photons = prob[1]
    frame_once(name, prob, 0, fr.fused_rounds, card, device)  # warm-up
    runs = {}  # seed -> (ms, FrameResult)
    launches, twin_launches = {}, 0
    for seed in (1, 2, 3):
        ms, res, lk, lt = frame_once(name, prob, seed, fr.fused_rounds, card, device)
        runs[seed] = (ms, res)
        launches = {k: launches.get(k, 0) + lk[k] for k in lk}
        twin_launches += lt
    check_launches(name, launches, twin_launches, device)
    elapsed_ms, res = sorted(runs.values(), key=lambda s: s[0])[1]
    checks = frame_checks(photons, res)
    report_frame(name, prob, res, elapsed_ms, card, "median of 3")
    print(f"[{name}] checks {checks}", flush=True)

    twin_ms, tres, _, _ = frame_once(name, prob, 2, fr.fused_rounds_reference, card, device)
    a, b = frame_summary(photons, runs[2][1]), frame_summary(photons, tres)
    print(f"[{name}/twin] {card}: the frame through the twin {twin_ms / 1e3:.4f} s (once), "
          f"through the kernel {runs[2][0] / 1e3:.4f} s (same seed), median kernel "
          f"{elapsed_ms / 1e3:.4f} s", flush=True)
    print(f"[{name}/twin] kernel {a}\n[{name}/twin] twin   {b}", flush=True)
    rel = {k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-30) for k in ("n_scatt", "e", "ns")}
    if (a["w"] != b["w"] or max(rel.values()) > 0.01
            or abs(a["q"] - b["q"]) > 0.01 or abs(a["u"] - b["u"]) > 0.01):
        raise RuntimeError(f"{name}: twin frame disagrees with the kernel frame: {rel}")
    return launches.get(PATHS[name][2], 0)


def main(device_name="cuda", n_min=600_000, n_max=1_400_000, hot_n=(150_000, 300_000),
         side_n=(150_000, 450_000)):
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

    from mcrat_tpu_torch import _build
    from mcrat_tpu_torch.ops import fused_round as fr

    # 1. build
    if device.type == "cuda":
        print(f"[build] {sh([_build.find_nvcc(), '--version']).splitlines()[-1]}", flush=True)
        t0 = time.perf_counter()
        info = _build.build()
        print(f"[build] {info['path'].name}: built={info['built']}, wall "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        # one line per instantiation: <STOKES, GEO, SRC, V2>, registers, spills
        entry = None
        for line in info["log"].splitlines():
            if "entry function" in line:
                m = re.search(r"fused_rounds_kernelILb(\d)ELi(\d+)ELi(\d)ELb(\d)E", line)
                entry = "<stokes %s, geo %s, src %s, v2 %s>" % m.groups() if m else line
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                regs = re.search(r"Used (\d+) registers", line)
                print(f"[build] ptxas {entry}: {regs.group(1) if regs else '?'} registers, "
                      f"{spill}", flush=True)
                entry = None
        _build.load_fused_round()

    # 2. kernel vs twin on the card, every variant on its own frame
    probs, errs, times = {}, {}, {}
    for name in PATHS:
        big = name in ("flagship", "spherical", "cartesian_3d")
        t0 = time.perf_counter()
        probs[name] = problem(name, device, *((n_min, n_max) if big else side_n))
        print(f"[setup] {name} frame + injection of {probs[name][1].capacity} photons: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        variant = PATHS[name][2]
        err_on, k_ms, t_ms = kernel_vs_twin(f"{name}, Stokes on", *probs[name], True,
                                            time_it=True)
        err_off, _, _ = kernel_vs_twin(f"{name}, Stokes off", *probs[name], False)
        errs[variant] = max(err_on, err_off)
        times[variant] = (k_ms, t_ms)
        if name == "flagship":
            cfg_h, ph_h, frame_h, index_h = problem("flagship", device, *hot_n, seed=1, hot=True)
            err_hot, _, _ = kernel_vs_twin("hot 5e8 K, block 1 idle, pool lanes", cfg_h, ph_h,
                                           frame_h, index_h, True, idle_block=1,
                                           pool_lanes=True)
            errs[variant] = max(errs[variant], err_hot)
            del ph_h, frame_h

    # 3.-4. the flagship path; 5. the 2-D spherical main path
    launches = {}
    for name in ("flagship", "spherical"):
        launches[PATHS[name][2]] = main_path(name, probs[name], card, device)

    # 6.-7. the 3-D cartesian frame and every other variant's frame, once each
    for name in PATHS:
        if name in ("flagship", "spherical"):
            continue
        ms, res, lk, lt = frame_once(name, probs[name], 1, fr.fused_rounds, card, device)
        check_launches(name, lk, lt, device)
        checks = frame_checks(probs[name][1], res)
        report_frame(name, probs[name], res, ms, card, "once")
        print(f"[{name}] checks {checks}", flush=True)
        launches[PATHS[name][2]] = lk.get(PATHS[name][2], 0)

    # 8. result lines
    print(json.dumps({"kernels": [{
        "name": f"fused_rounds[{v}]", "route": "cuda",
        "source": "mcrat_tpu_torch/csrc/fused_round.cu",
        "replaces": f"mcrat_tpu/ops/pallas_round.py:1185 ({fr.VARIANTS[v].replaces})",
        "launches": launches[v], "max_abs_err": errs[v],
        "ms": times[v][0], "plain_ms": times[v][1],
    } for v in fr.VARIANTS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "count": torch.cuda.device_count() if device.type == "cuda" else 0,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
