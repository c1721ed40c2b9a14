"""The readings the comparison's limits are set from, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]
        [--out <file>]

For each seed: set-up as a run makes it, one warm-up window, then one frame
window of the program, kept with the generator's state before it; then,
once the program's state is freed, the reference's window (float32) from
the same inputs on its own stream.  The program against it gives the sound
reading.  For each control seed also: each fault of ``faults.py`` planted
under the program's timed path, and the control, the reference computed in
bfloat16 (the precision below the configuration's float32) in the
program's place, on the program's stream; each against the float32
reference.  Needs a CUDA device; the benchmark's own runs never run this.
Prints one JSON line a seed.
"""
import argparse
import dataclasses
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "benchmark"):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

# rounds the control may take: in bfloat16 a photon's frame time stops
# falling once its steps round away against it, so the control is cut at
# over twice the rounds (44-48) of the float32 frame window in these cells
CONTROL_ROUNDS = 128


def readings(workload: str, seed: int, control: bool, device="cuda",
             mix_override=None) -> dict:
    """One seed's line: the program's numbers and, with ``control``, each
    fault's and the control's (``mix_override`` resizes the mix for a
    test)."""
    import torch

    from benchmark import compare, faults, spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, workload)
    cfg_spec, config = spec.config(cell["config"])
    mix, kind = spec.mix(cell["traffic"], override=mix_override)
    device = torch.device(device)
    prob = kind.setup(cfg_spec, config, mix, seed, device)
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))

    def window():
        res = kind.window(prob, g)
        return kind.fields(res), int(res.n_scatt)

    window()
    state = g.get_state()
    outputs = {"program": window()}
    for name in faults.FAULTS if control else ():
        g.set_state(state)
        with faults.planted(name):
            outputs[name] = window()
    before = kind.before(prob, config, device)
    inp, n_photons = prob.inputs, prob.n_photons
    del window
    prob.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = config.reference

    def reference(gen, dtype, max_rounds=None):
        t0 = time.perf_counter()
        i = inp if max_rounds is None else dataclasses.replace(inp, max_rounds=max_rounds)
        ph, t_rem = ref.transport_window(i, gen, device, dtype)
        out = {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in ph.items()}
        out["t_rem"] = t_rem.to(torch.float32)
        return out, time.perf_counter() - t0

    ref32, ref_s = reference(kind.reference_generator(seed), torch.float32)

    def judge(fields, n_scatt):
        return compare.compare(before, fields, ref32, n_scatt, inp.dt_max,
                               lambda pos, c: ref.cell_holds(inp, pos, c))

    line = dict(workload=workload, seed=seed, photons=n_photons, reference_s=ref_s)
    for name, (fields, n_scatt) in outputs.items():
        line[name] = judge(fields, n_scatt)
    if control:
        gen = torch.Generator()
        gen.set_state(state)
        ctl, line["control_s"] = reference(gen, torch.bfloat16, CONTROL_ROUNDS)
        n_scatt = int((ctl["num_scatt"].double() - before["num_scatt"].double()).sum().round())
        line["control_bfloat16"] = judge(ctl, n_scatt)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 3
    lines = []
    for seed in args.seeds + args.control_seeds:
        line = readings(args.workload, seed, seed in args.control_seeds)
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
