"""The comparison of a cell of nonthermal electrons (``cyl2_nt.frame``, or
``amr_table.frame`` with ``--cell``) with the program's nonthermal
electrons dropped: each window runs the same frame, tables and packed
variant with TABLE thermal electrons alone (``transport.select_variant``'s
setup without the nonthermal constants: ``packed_cyl2+cheb`` on the grid;
on a cell list ``packed_cyl2+aux``, its aux planes computed as for thermal
electrons alone), held against the reference with them.  A comparison that
guards the nonthermal mechanism fails it.

    python3 tools/nt_dropped.py --seeds <n> ... [--cell <cell>] [--out <file>]

Needs a CUDA device (``--device cpu`` for a rehearsal, with
``--photons <min> <max>`` and ``--cells <n0> <n1>`` to shrink the cell:
the grid to n0 x n1 cells, or each refinement band of a cell list to n0 x
n1 blocks).
Prints one JSON line a seed: ``benchmark/control.py``'s readings of the
program so run.
"""
import argparse
import contextlib
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "cyl2_nt.frame"


@contextlib.contextmanager
def nonthermal_dropped():
    """``transport.select_variant`` returning its setup with the nonthermal
    constants taken out, and ``transport.aux_planes`` computing the planes
    of a configuration without nonthermal electrons (the thermal rate, a
    thermal probability of 1), while active."""
    import dataclasses

    from mcrat_tpu_torch import NonthermalDist, transport

    real_select, real_aux = transport.select_variant, transport.aux_planes

    def select(*args, **kw):
        return real_select(*args, **kw)._replace(nt=None)

    def aux_planes(cfg, *args, **kw):
        return real_aux(dataclasses.replace(cfg, nonthermal_e_dist=NonthermalDist.OFF), *args,
                        **kw)

    transport.select_variant, transport.aux_planes = select, aux_planes
    try:
        yield
    finally:
        transport.select_variant, transport.aux_planes = real_select, real_aux


@contextlib.contextmanager
def cells(n0: int, n1: int):
    """The configuration's grid cut to ``n0`` x ``n1`` cells, or each band of
    its AMR blocks to ``n0`` x ``n1`` blocks, while active (a rehearsal's
    size)."""
    from benchmark import spec

    real = spec.config

    def config(name, *args, **kw):
        data, module = real(name, *args, **kw)
        data = copy.deepcopy(data)
        if "blocks" in data:
            data["blocks"]["bands"] = [[*b[:2], n0, n1] for b in data["blocks"]["bands"]]
        else:
            data["grid"] = {axis: [*data["grid"][axis][:2], n + 1]
                            for axis, n in (("r0", n0), ("r1", n1))}
        return data, module

    spec.config = config
    try:
        yield
    finally:
        spec.config = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cell", default=CELL)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--photons", type=int, nargs=2)
    ap.add_argument("--cells", type=int, nargs=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from benchmark import control

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[nt_dropped] needs a CUDA device", file=sys.stderr)
        return 3
    override = None
    if args.photons:
        override = dict(min_photons=args.photons[0], max_photons=args.photons[1])
    lines = []
    with contextlib.ExitStack() as stack:
        if args.cells:
            stack.enter_context(cells(*args.cells))
        stack.enter_context(nonthermal_dropped())
        for seed in args.seeds:
            line = control.readings(args.cell, seed, False, device=args.device,
                                    mix_override=override)
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
