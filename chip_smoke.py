#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcrat_tpu_torch) on one NVIDIA GPU.

Drives the port's flagship path -- inject_photons -> photons_from_arrays ->
transport_frame on the 2-D cylindrical Gamma=100 outflow, 160x512 uniform
grid, DIRECT optical depth, thermal electrons, Stokes on, float32, ~1M
photons, 64-round chunks with compaction -- through the hand-written CUDA
fused-round kernel, and checks it:

  0. device: nvidia-smi name/power limit, torch, CUDA and nvcc versions;
     exits non-zero without a CUDA device;
  1. build: compiles csrc/fused_round.cu with nvcc (wall time, ptxas report);
  2. kernel vs its plain twin on the card, on the flagship's real lanes
     (Stokes on, Stokes off) and on a hot 5e8 K frame with one idle block;
     times both on the 1M-lane call;
  3. the main path: one warm-up + median of 3 transport_frame runs, with the
     kernel's launch count (the twin's must stay 0) and the frame checks;
  4. the same frame with the twin on the card, timed once, statistics held
     against the kernel's;
  5. prints the kernels' JSON line, then {"ok": true, "device": {...}} last.

Run from the repository root: ``python3 chip_smoke.py``.  Imports no JAX.
"""
import json
import os
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


def flagship_problem(device, n_min=600_000, n_max=1_400_000, hot=False, seed=0):
    """The flagship frame, set up as bench.py:63-92 does."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType, Spectrum, transport
    from mcrat_tpu_torch.grid import build_rectilinear_index, frame_from_numpy
    from mcrat_tpu_torch.models.analytic import apply_simulation_type, make_grid_2d

    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
    r0e = np.linspace(0.0, 3.2e11, 161)
    r1e = np.linspace(1.8e12, 2.9e12, 513)
    host = frame_from_numpy(cfg, make_grid_2d(cfg, r0e, r1e))
    apply_simulation_type(host)
    if hot:
        host.temp[:] = 5e8
    index = build_rectilinear_index(r0e, r1e, device=device)
    arrays, _ = transport.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30, fps=5.0,
        rng=np.random.default_rng(seed),
    )
    photons, _ = transport.photons_from_arrays(arrays, device=device)
    return cfg, photons, host.to_device(device), index


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
    args = (safe, flags, frame.phys, block_act, seed, grid)
    kw = dict(stokes_on=stokes_on, inner_rounds=4, block_lanes=block_lanes)
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
    print(f"[kernel-vs-twin] {name}: live lanes {n_live}, scatterings kernel "
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
        print(f"[kernel-vs-twin] {name}: one fused_rounds call ({state.shape[1]} lanes, "
              f"4 rounds): kernel {k_ms:.3f} ms, twin {t_ms:.3f} ms (median of 5)", flush=True)
    return max_abs, k_ms, t_ms


def run_frame(cfg, photons, frame, index, seed, rounds_fn):
    from mcrat_tpu_torch import transport

    return transport.transport_frame(
        cfg, photons, frame, index, 1.0 / 5.0, torch.Generator().manual_seed(seed),
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


def main(device_name="cuda", n_min=600_000, n_max=1_400_000, hot_n=(150_000, 300_000)):
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

    from mcrat_tpu_torch import _build, transport
    from mcrat_tpu_torch.ops import fused_round as fr

    # 1. build
    if device.type == "cuda":
        print(f"[build] {sh([_build.find_nvcc(), '--version']).splitlines()[-1]}", flush=True)
        t0 = time.perf_counter()
        info = _build.build()
        print(f"[build] {info['path'].name}: built={info['built']}, wall "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"[build] ptxas: {line.strip()}", flush=True)
        _build.load_fused_round()

    # 2. kernel vs twin on the card
    t0 = time.perf_counter()
    cfg, photons, frame, index = flagship_problem(device, n_min, n_max)
    print(f"[setup] flagship frame + injection of {photons.capacity} photons: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    err_on, k_ms, t_ms = kernel_vs_twin("flagship, Stokes on", cfg, photons, frame, index,
                                        True, time_it=True)
    err_off, _, _ = kernel_vs_twin("flagship, Stokes off", cfg, photons, frame, index, False)
    cfg_h, ph_h, frame_h, index_h = flagship_problem(device, *hot_n, hot=True, seed=1)
    err_hot, _, _ = kernel_vs_twin("hot 5e8 K, block 1 idle, pool lanes", cfg_h, ph_h,
                                   frame_h, index_h, True, idle_block=1, pool_lanes=True)
    del ph_h, frame_h

    # 3. the main path
    fr.fused_rounds.launches = 0
    fr.fused_rounds_reference.launches = 0
    run_frame(cfg, photons, frame, index, 0, fr.fused_rounds)  # warm-up
    runs = {}  # seed -> (ms, FrameResult)
    for seed in (1, 2, 3):
        out = []
        ms = timed(lambda: out.append(
            run_frame(cfg, photons, frame, index, seed, fr.fused_rounds)), device)
        runs[seed] = (ms, out[0])
    launches, twin_launches = fr.fused_rounds.launches, fr.fused_rounds_reference.launches
    elapsed_ms, res = sorted(runs.values(), key=lambda s: s[0])[1]
    print(f"[main] launches during the main path: kernel {launches}, twin {twin_launches}",
          flush=True)
    if device.type == "cuda" and (launches == 0 or twin_launches != 0):
        raise RuntimeError("the main path did not run through the kernel alone")
    checks = frame_checks(photons, res)
    n_ph = photons.capacity
    el = elapsed_ms / 1e3
    pr = n_ph * res.n_rounds
    stats = transport.frame_stats(res.photons).tolist()
    print(f"[main] {card}: n_photons {n_ph}, n_scatt {res.n_scatt}, n_rounds {res.n_rounds}, "
          f"elapsed {el:.4f} s (median of 3), {res.n_scatt / el:.6e} scatterings/s, "
          f"{pr / el:.6e} photon-rounds/s, {1e9 * el / max(pr, 1):.4f} ns/photon-round",
          flush=True)
    print(f"[main] {card}: frame_stats {stats}", flush=True)
    print(f"[main] checks {checks}", flush=True)

    # 4. the same frame (seed 2: the same random numbers) through the twin
    out = []
    twin_ms = timed(lambda: out.append(
        run_frame(cfg, photons, frame, index, 2, fr.fused_rounds_reference)), device)
    a, b = frame_summary(photons, runs[2][1]), frame_summary(photons, out[0])
    print(f"[twin] {card}: the frame through the twin {twin_ms / 1e3:.4f} s (once), through "
          f"the kernel {runs[2][0] / 1e3:.4f} s (same seed), median kernel {el:.4f} s",
          flush=True)
    print(f"[twin] kernel {a}\n[twin] twin   {b}", flush=True)
    rel = {k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-30) for k in ("n_scatt", "e", "ns")}
    if (a["w"] != b["w"] or max(rel.values()) > 0.01
            or abs(a["q"] - b["q"]) > 0.01 or abs(a["u"] - b["u"]) > 0.01):
        raise RuntimeError(f"twin frame disagrees with the kernel frame: {rel}")

    # 5. result lines
    print(json.dumps({"kernels": [{
        "name": "fused_rounds", "route": "cuda",
        "source": "mcrat_tpu_torch/csrc/fused_round.cu",
        "replaces": "mcrat_tpu/ops/pallas_round.py:1185",
        "launches": launches, "max_abs_err": max(err_on, err_off, err_hot),
        "ms": k_ms, "plain_ms": t_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "count": torch.cuda.device_count() if device.type == "cuda" else 0,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
