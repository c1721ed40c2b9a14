#!/usr/bin/env python3
"""The photons of a benchmark cell's first frame window, hashed field by field.

For each cell and seed: the cell's set-up as ``benchmark/run.py`` makes it
(``kind.setup``: the configuration's frame and index, the population
injected from the seed) and its first window (``kind.window`` with the
run's generator, ``manual_seed(seed mod 2^63)``), then a SHA-256 of each
photon field's bytes (``p``, ``pos``, ``s``, ``comv_p``, ``num_scatt``,
``cell``, ``ptype``, ``weight``, ``t_rem``) and the window's scatter and
round counts.  Two trees that give the same hashes for a cell and seed give
that window's photons bit for bit.  ``--root`` runs another checkout's
program and benchmark (a copy of a parent commit), so one call can hold two
trees side by side:

    python3 tools/window_hashes.py --cells sph2_fireball.frame --seeds 7 11 \\
        --out build/hashes_tree.json
    python3 tools/window_hashes.py --root build/parent --cells sph2_fireball.frame \\
        --seeds 7 11 --out build/hashes_parent.json

Needs a CUDA device (``--device cpu`` runs the plain twin, for a small
rehearsal with ``--photons``); imports no JAX.
"""
import argparse
import hashlib
import json
import os
import sys
import time

FIELDS = ("p", "pos", "s", "comv_p", "num_scatt", "cell", "ptype", "weight")


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--photons", nargs=2, type=int, default=None,
                    help="override the mix's min_photons, max_photons")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from benchmark import spec as sp

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("window_hashes: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    override = (None if args.photons is None
                else dict(min_photons=args.photons[0], max_photons=args.photons[1]))
    bench = sp.load_benchmark()
    out = dict(root=root, device=str(device), results=[])
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    for name in args.cells:
        cell = sp.workload(bench, name)
        spec, config = sp.config(cell["config"])
        mix, kind = sp.mix(cell["traffic"], override=override)
        for seed in args.seeds:
            t0 = time.perf_counter()
            prob = kind.setup(spec, config, mix, seed, device)
            g = torch.Generator().manual_seed(int(seed) % (1 << 63))
            res = kind.window(prob, g)
            ph = res.photons
            row = dict(cell=name, seed=seed, n_photons=prob.n_photons, n_scatt=int(res.n_scatt),
                       n_rounds=int(res.n_rounds),
                       hashes={k: digest(getattr(ph, k)) for k in FIELDS},
                       seconds=time.perf_counter() - t0)
            row["hashes"]["t_rem"] = digest(res.t_rem)
            out["results"].append(row)
            print(f"[hashes] {name} seed {seed}: {row['n_photons']} photons, n_scatt "
                  f"{row['n_scatt']}, rounds {row['n_rounds']}, "
                  f"{hashlib.sha256(json.dumps(row['hashes'], sort_keys=True).encode()).hexdigest()[:16]}"
                  f" ({row['seconds']:.1f} s)", flush=True)
            del prob, res, ph
            if device.type == "cuda":
                torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
