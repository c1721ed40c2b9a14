#!/usr/bin/env python3
"""Instructions of the CUDA math functions the fused-round kernel calls, as
nvcc compiles them for sm_90a with the kernel's flags (``--fmad=false``).

Compiles one small kernel a function -- ``out[i] = f(in[i])``; ``a / b`` for
the divisions; ``sinf`` and ``cosf`` of one argument together, as the kernel
calls them; the double ``log1p`` and division of the Klein-Nishina form --
disassembles them with ``cuobjdump -sass`` and counts the instructions on
each function's common path: the shortest path from the kernel's entry to
its ``EXIT`` (a ``CALL`` costs its callee's shortest path to ``RET``), which
branches past the slow paths for large, tiny or special arguments; an
early exit for special values (a predicated branch after instructions under
the same predicate) is not taken.  Counts by pipe: ``mufu`` (the SFU:
MUFU.*), ``fp32`` operations (FFMA two, FADD and FMUL one), ``fp64``
instructions (DFMA, DADD, DMUL) and ``other``; the whole function's static
counts beside them.  A copy kernel's counts are
subtracted.  Writes JSON (with the listing and each path's instructions) to
``--out``; ``--listing`` analyses the listing of an earlier output instead
of compiling.  ``chip_smoke.py``'s bound takes its per-function counts from
this output.

    python3 tools/sass_counts.py --out build/sass_counts.json

Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""
import argparse
import heapq
import json
import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mcrat_tpu_torch import _build  # noqa: E402

SOURCE = r"""
#define K(name, T, expr) \
  extern "C" __global__ void name(const T* a, const T* b, T* o, T* o2) { \
    const int i = blockIdx.x * blockDim.x + threadIdx.x; \
    expr; \
  }
K(k_copy, float, o[i] = a[i])
K(k_logf, float, o[i] = logf(a[i]))
K(k_expf, float, o[i] = expf(a[i]))
K(k_sinf, float, o[i] = sinf(a[i]))
K(k_cosf, float, o[i] = cosf(a[i]))
K(k_sincosf, float, const float x = a[i]; o[i] = sinf(x); o2[i] = cosf(x))
K(k_sqrtf, float, o[i] = sqrtf(a[i]))
K(k_rsqrtf, float, o[i] = rsqrtf(a[i]))
K(k_divf, float, o[i] = a[i] / b[i])
K(k_copy64, double, o[i] = a[i])
K(k_log1p64, double, o[i] = log1p(a[i]))
K(k_div64, double, o[i] = a[i] / b[i])
"""
FUNCS = dict(log="k_logf", exp="k_expf", sin="k_sinf", cos="k_cosf", sincos="k_sincosf",
             sqrt="k_sqrtf", rsqrt="k_rsqrtf", div="k_divf", log1p64="k_log1p64",
             div64="k_div64")
BASE = dict(k_log1p64="k_copy64", k_div64="k_copy64")

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*([.\w$]+):\s*$")
FUNC = re.compile(r"Function\s*:\s*(\S+)")
PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
TARGET = re.compile(r"`\(([^)]+)\)|\b(0x[0-9a-f]+)\b")


def parse(sass):
    """{function: (instructions [(opcode, predicated, target, text)], labels
    {name: index})} of a cuobjdump -sass listing."""
    funcs, cur, pending = {}, None, []
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if not m:
            continue
        ins, labels = cur
        addr, text = int(m.group(1), 16), m.group(2)
        for name in pending:
            labels[name] = len(ins)
        labels[hex(addr)] = len(ins)
        pending = []
        pred = bool(PRED.match(text))
        body = PRED.sub("", text)
        op = body.split()[0] if body else ""
        t = TARGET.search(body) if op.startswith(("BRA", "CALL")) else None
        target = (t.group(1) or t.group(2)) if t else None
        ins.append((op, pred, target, text))
    return funcs


def classify(op):
    if op.startswith("MUFU"):
        return "mufu", 1
    if op.startswith("FFMA"):
        return "fp32", 2
    if op.startswith(("FADD", "FMUL")):
        return "fp32", 1
    if op.startswith(("DFMA", "DADD", "DMUL")):
        return "fp64", 1
    return "other", 1


def shortest(ins, labels, start, stop, cost_of_call):
    """The shortest path (by instruction count) from ``start`` to an
    unpredicated instruction whose opcode starts with ``stop``: the list of
    instruction indices, or None."""
    def early_exit(i):  # @P ...; @P BRA: a special value's way out
        return i > 0 and ins[i][3].split()[0] == ins[i - 1][3].split()[0] and ins[i][1]

    def nxt(i):
        op, pred, target, _ = ins[i]
        out = []
        if op.startswith("BRA") and target in labels and not (pred and early_exit(i)):
            out.append(labels[target])
            if not pred:
                return out
        if op.startswith(("EXIT", "RET")) and not pred:
            return out
        if i + 1 < len(ins):
            out.append(i + 1)
        return out

    def weight(i):
        op, _, target, _ = ins[i]
        return 1 + (cost_of_call(target) if op.startswith("CALL") else 0)

    dist, prev, heap = {start: weight(start)}, {}, [(weight(start), start)]
    while heap:
        d, i = heapq.heappop(heap)
        if d > dist.get(i, 1 << 60):
            continue
        op, pred, _, _ = ins[i]
        if op.startswith(stop) and not pred:
            path = [i]
            while path[-1] in prev:
                path.append(prev[path[-1]])
            return path[::-1]
        for j in nxt(i):
            nd = d + weight(j)
            if nd < dist.get(j, 1 << 60):
                dist[j], prev[j] = nd, i
                heapq.heappush(heap, (nd, j))
    return None


def count(ins, labels, path):
    """Counts by class of the instructions on ``path``, callees included."""
    out = dict(mufu=0, fp32=0, fp64=0, other=0)
    for i in path:
        op, _, target, _ = ins[i]
        cls, n = classify(op)
        out[cls] += n
        if op.startswith("CALL") and target in labels:
            sub = shortest(ins, labels, labels[target], "RET", lambda t: 0)
            for k, v in count(ins, labels, sub or []).items():
                out[k] += v
    return out


def analyse(ins, labels):
    def call_cost(target):
        if target not in labels:
            return 0
        sub = shortest(ins, labels, labels[target], "RET", lambda t: 0)
        return len(sub) if sub else 0

    path = shortest(ins, labels, 0, "EXIT", call_cost)
    whole = dict(mufu=0, fp32=0, fp64=0, other=0)
    for op, *_ in ins:
        cls, n = classify(op)
        whole[cls] += n
    return dict(path=count(ins, labels, path), whole=whole,
                path_sass=[ins[i][3] for i in path])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sass_counts.json"))
    ap.add_argument("--listing", help="an earlier output whose listing to analyse")
    args = ap.parse_args()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    if args.listing:
        with open(args.listing) as f:
            old = json.load(f)
        flags, version, sass = old["flags"], old["nvcc"], old["sass"]
    else:
        nvcc = _build.find_nvcc()
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        with tempfile.TemporaryDirectory() as tmp:
            src, cubin = os.path.join(tmp, "math.cu"), os.path.join(tmp, "math.cubin")
            with open(src, "w") as f:
                f.write(SOURCE)
            _build.run([nvcc, *flags, "-cubin", "-o", cubin, src])
            sass = _build.run([cuobjdump, "-sass", cubin]).stdout
        version = _build.run([nvcc, "--version"]).stdout.splitlines()[-1]
    funcs = parse(sass)
    res = {name: analyse(*funcs[name]) for name in set(FUNCS.values()) | {"k_copy", "k_copy64"}}
    out = {}
    for fn, kname in FUNCS.items():
        base = res[BASE.get(kname, "k_copy")]
        r = res[kname]
        out[fn] = dict(kernel=kname,
                       **{k: r["path"][k] - base["path"][k] for k in r["path"]},
                       whole={k: r["whole"][k] - base["whole"][k] for k in r["whole"]},
                       path_sass=r["path_sass"])
        print(f"[sass] {fn:8s} common path: mufu {out[fn]['mufu']}, fp32 {out[fn]['fp32']}, "
              f"fp64 {out[fn]['fp64']}, other {out[fn]['other']}; whole function "
              f"{out[fn]['whole']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(flags=flags, nvcc=version, functions=out, sass=sass), f, indent=1)
    print(f"[sass] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
