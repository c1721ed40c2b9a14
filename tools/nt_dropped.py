"""The comparison of the ``cyl2_nt.frame`` cell with the program's
nonthermal electrons dropped: each window runs the same frame, tables and
packed variant with TABLE thermal electrons alone (``packed_cyl2+cheb``:
``transport.select_variant``'s setup without the nonthermal constants),
held against the reference with them.  A comparison that guards the
nonthermal mechanism fails it.

    python3 tools/nt_dropped.py --seeds <n> ... [--out <file>]

Needs a CUDA device (``--device cpu`` for a rehearsal, with
``--photons <min> <max>`` and ``--cells <n0> <n1>`` to shrink the cell).
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
    constants taken out, while active."""
    from mcrat_tpu_torch import transport

    real = transport.select_variant

    def select(*args, **kw):
        return real(*args, **kw)._replace(nt=None)

    transport.select_variant = select
    try:
        yield
    finally:
        transport.select_variant = real


@contextlib.contextmanager
def cells(n0: int, n1: int):
    """The configuration's grid cut to ``n0`` x ``n1`` cells, while active
    (a rehearsal's size)."""
    from benchmark import spec

    real = spec.config

    def config(name, *args, **kw):
        data, module = real(name, *args, **kw)
        data = copy.deepcopy(data)
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
            line = control.readings(CELL, seed, False, device=args.device, mix_override=override)
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
