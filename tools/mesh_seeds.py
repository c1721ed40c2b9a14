#!/usr/bin/env python3
"""The flagship frame on one device against the same frame on a two-shard
mesh, over several seeds, on one NVIDIA GPU.

Each seed runs chip_smoke.py's flagship frame (the 2-D cylindrical outflow,
~1M photons, 64-round chunks, the CUDA fused-round kernel) once through
``transport.transport_frame`` and once through
``parallel.sharded_transport_frame`` on a mesh of two shards of the card,
with the same generator seed (different streams: each shard draws its own
seed).  Prints, for each engine layout, the mean and the seed-to-seed
standard deviation of three frame statistics over the live photons: the
scattered fraction (photons with a scattering), the mean scatterings and
the mean lab energy (m_e c), then every seed's scattered fraction; and the
card's name and power limit.  A bias of the mesh would show as a difference
of the means beyond their spread; the spread beside one frame's standard
error says how far a single frame's error bar holds.

    python3 tools/mesh_seeds.py --seeds 12
"""
import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mcrat_tpu_torch import _build
    from mcrat_tpu_torch.ops import fused_round as fr
    from mcrat_tpu_torch.parallel import mesh as pm

    _build.build()
    dev = torch.device("cuda")
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]),
          flush=True)
    prob = cs.problem("flagship", dev, 600_000, 1_400_000)
    mesh = pm.make_mesh(devices=[dev, dev])

    def stats(ph):
        alive = ph.alive
        ns = ph.num_scatt[alive].double()
        return [float((ns > 0).double().mean()), float(ns.mean()),
                float(ph.p[alive, 0].double().mean())]

    out = {"one device": [], "two shards": []}
    for seed in range(1, args.seeds + 1):
        res = cs.run_frame(prob, seed, fr.fused_rounds, dt_max=prob.dt_max)
        out["one device"].append(stats(res.photons))
        res = pm.sharded_transport_frame(prob.cfg, mesh, prob.photons, prob.frame, prob.index,
                                         prob.dt_max, torch.Generator().manual_seed(seed),
                                         chunk_rounds=64)
        out["two shards"].append(stats(pm.fetch_global(res.photons)))
    for name, rows in out.items():
        a = np.array(rows)
        print(f"{name}: scattered fraction {a[:, 0].mean():.7f} sd {a[:, 0].std(ddof=1):.7f}; "
              f"scatterings {a[:, 1].mean():.6f} sd {a[:, 1].std(ddof=1):.6f}; energy "
              f"{a[:, 2].mean():.8e} sd {a[:, 2].std(ddof=1):.3e}; by seed "
              f"{a[:, 0].tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
