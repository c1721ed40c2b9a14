#!/usr/bin/env python3
"""Builds of the fused-round kernel, timed in turns in one process.

Loads each ``--parent`` (a copy of another revision's
``csrc/fused_round.cu``, kept in a git-ignored place such as ``build/ab/``)
and the tree's own ``mcrat_tpu_torch/csrc/fused_round.cu``, all through the
same C entry point (``_build.bind_fused_round``; the builds run side by
side).  A source split into translation units (``MCRAT_FAMILY``) builds as
the port builds it (``_build.build``); an older, unsplit one with one nvcc.
For each case -- a chip_smoke.py frame and mode, Stokes on and off -- it
builds the lanes of one 4-round call as chip_smoke.py does
(``call_inputs``), checks that every build leaves every state plane and
out-flag identical, then times them in turns (the parents, the tree, the
tree, the parents in reverse), each turn ``--launches`` launches timed alone
on the device (``chip_smoke.kernel_ms``).  Each case also gets the twin's
work tally, the call's bound (``chip_smoke.bound``) and the warp tally.
The tree's instantiations report their block, registers, local and shared
memory (``fused_round.kernel_attributes``).  Writes JSON to ``--out``.

Cases: the lead instantiations -- packed_cyl2+cheb+nt on the nonthermal
main path's frame (``flagship/nt``) and on chip_smoke's side frame
(``flagship_phi_velocity/nt``), packed_cyl2+aux+nt on the AMR nonthermal
frame (``amr_cyl2/aux_nt``) and on the side frame
(``flagship_phi_velocity/aux_nt``) -- and ultra_cyl2 on the flagship
(``flagship/direct``); ``--all`` adds every case of chip_smoke.py's phase 2
(all 86 instantiations).  Needs a CUDA device; imports no JAX.

    mkdir -p build/ab && git show HEAD~1:mcrat_tpu_torch/csrc/fused_round.cu \\
        > build/ab/fused_round.cu
    python3 tools/kernel_ab.py --parent build/ab/fused_round.cu --out build/kernel_ab.json
"""
import argparse
import collections
import concurrent.futures
import ctypes
import hashlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LEAD = [("flagship", "nt"), ("flagship_phi_velocity", "nt"), ("amr_cyl2", "aux_nt"),
        ("flagship_phi_velocity", "aux_nt"), ("flagship", "direct")]


def problem(name, mode, tables, device):
    """chip_smoke.py's frame of a case: a main path's own frame where one
    runs (name, mode), else its phase-2 side frame."""
    if (name, mode) in cs.MAIN:
        seed, hot = cs.MAIN[name, mode]
        return cs.problem(name, device, 600_000, 1_400_000, seed=seed, hot=hot, mode=mode,
                          tables=tables)
    big = mode == "direct" and name in ("flagship", "spherical", "cartesian_3d")
    return cs.problem(name, device, *((600_000, 1_400_000) if big else (150_000, 450_000)),
                      mode=mode, tables=tables, spread=mode != "direct")


def build(src: Path) -> dict:
    """Build ``src``: as the port builds it where it is split into
    translation units, else (a revision before the split) whole, with one
    nvcc.  Returns _build.build's dict and whether the source is ``split``."""
    from mcrat_tpu_torch import _build

    if b"MCRAT_FAMILY" in src.read_bytes():
        return dict(_build.build(src), split=True)
    tag = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"lib{src.stem}_whole_{tag}.so"
    t0 = time.perf_counter()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        _build.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)])
    return dict(path=lib, built=True, seconds=time.perf_counter() - t0, split=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, action="append",
                    help="another revision's fused_round.cu (repeatable)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "kernel_ab.json"))
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--all", action="store_true", help="every chip_smoke.py phase-2 case")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from mcrat_tpu_torch import Config, _build
    from mcrat_tpu_torch.ops import fused_round as fr

    device = torch.device("cuda")
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    srcs = {f"parent{i}": Path(p).resolve() for i, p in enumerate(args.parent)}
    srcs["tree"] = _build.FUSED_ROUND_SRC
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        infos = dict(zip(srcs, ex.map(build, srcs.values())))
    libs = {k: _build.bind_fused_round(ctypes.CDLL(str(v["path"]))) for k, v in infos.items()}
    builds = {}
    for k, info in infos.items():
        attrs = ({name: fr.kernel_attributes(libs[k], v, tau, s)
                  for name, v, tau, s in fr.instantiation_specs()} if k == "tree" else None)
        builds[k] = dict(source=str(srcs[k]), seconds=info["seconds"], split=info["split"],
                         attributes=attrs)
        print(f"[build] {k} ({srcs[k]}): {info['seconds']:.2f} s, "
              f"{'split' if info['split'] else 'whole'}", flush=True)
    tables = cs.xsec_tables(Config(), device)

    order = [*libs][:-1]  # the parents
    turns = [*order, "tree", "tree", *order[::-1]]
    cases = list(dict.fromkeys(LEAD + (list(cs.CASES) if args.all else [])))
    results = []
    for name, mode in cases:
        t0 = time.perf_counter()
        prob = problem(name, mode, tables, device)
        print(f"[setup] {name}/{mode}: {prob.photons.capacity} photons, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for stokes_on in (True, False):
            call = cs.call_inputs(prob, stokes_on)

            def launcher(k):
                return lambda s: fr.launch(libs[k], torch.cuda.current_stream().cuda_stream, s,
                                           *call.args, **call.kw)

            outs = {k: call.run(lambda s, *a, **kw: launcher(k)(s)) for k in libs}
            st_, ot = outs["tree"]
            identical = all(torch.equal(sp.view(torch.int32), st_.view(torch.int32))
                            and torch.equal(op, ot) for sp, op in outs.values())
            if not identical:
                raise RuntimeError(f"{name}/{mode} ({call.inst}): the builds differ")
            fr.fused_rounds_reference.work = collections.Counter()
            call.run(fr.fused_rounds_reference)
            work = {k: float(v) for k, v in fr.fused_rounds_reference.work.items()}
            fr.fused_rounds_reference.work = None
            runs = call.alive & (call.state[fr.SP_TREM] > 0)
            bnd = cs.bound(call.inst, call.kw["variant"], call.state.shape[1], int(runs.sum()),
                           int(torch.unique(call.args[0][runs]).numel()), work, stokes_on)
            for k in libs:  # warm-up
                cs.kernel_ms(call, launcher(k), 3)
            ms = {k: [] for k in libs}
            for k in turns:
                ms[k].append(cs.kernel_ms(call, launcher(k), args.launches))
            med = {k: float(np.median(np.concatenate(v))) for k, v in ms.items()}
            r = dict(case=f"{name}/{mode}", inst=call.inst, lanes=call.state.shape[1],
                     run_lanes=int(runs.sum()), identical=identical, ms=med,
                     ratio={k: med["tree"] / med[k] for k in order},
                     turn_medians_ms={k: [float(np.median(t)) for t in v] for k, v in ms.items()},
                     bound_ms=bnd[0], bound_pipe=bnd[2],
                     share_of_bound={k: bnd[0] / med[k] for k in med}, work=work)
            results.append(r)
            print(f"[ab] {r['case']} ({r['inst']}, {r['lanes']} lanes, {r['run_lanes']} "
                  f"running): " + ", ".join(f"{k} {med[k]:.4f} ms" for k in libs)
                  + " (tree/" + ", tree/".join(f"{k} x{r['ratio'][k]:.3f}" for k in order)
                  + f"); bound {bnd[0]:.4f} ms ({bnd[2]}); identical {identical}", flush=True)
            print(f"[ab] {r['case']} ({r['inst']}) warps: {cs.warp_line(work)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, torch=torch.__version__, launches=args.launches,
                       builds=builds, cases=results), f, indent=1)
    print(f"[ab] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
