"""The fused-round kernel's least time for a frame window, from its photons.

Frozen copy of ``chip_smoke.py``'s peaks (:173-176), per-unit operation
counts ``OPS``, ``OPS_GEO``, ``MATH``, ``CALLS``, ``CALLS_GEO``,
``INT_OPS_PER_UNIFORM``, ``UNIFORMS`` and the per-SM rates (:464-546); the
rows a cell's table read takes (``table_rows_read``, :549-568) are each
configuration's own (``configs/<name>.py``), as are its geometry's counts.  The counts per unit were made by hand from the
kernel's source (``csrc/fused_round.cu``) and, for the math functions, from
the instructions nvcc 12.9 emits for sm_90a (``tools/sass_counts.py``).

The work is counted from the frame's photons, not from the program's
launches, so any implementation of the same frame reads the same work:

- bytes: each photon's 16-float state read once and written once, and the
  table rows of each cell that holds a photon at the window's start read
  once;
- a scattering (the change in the scatter counts) is one accepted attempt
  (the electron's Maxwell-Boltzmann draw, the rest-frame boost), one scatter
  (with Stokes: the Fano matrix and its rotations), one accepted theta and
  one accepted phi trial, and one round (free path, move, comoving boost);
  each photon takes one more round, its last.

Rejected Klein-Nishina attempts, null rounds and rejected trials are left
out, so the least time is a lower bound and the share of it a kernel
reaches is too.  The least time is the largest of the per-pipe times.
"""
from __future__ import annotations

import collections

# NVIDIA H100 SXM data sheet: HBM bytes/s and float32 operations/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# per-SM results a clock for compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instructions) x 132 SMs x 1.98 GHz (H100 SXM boost)
SM_RATE = 132 * 1.98e9
PEAK_INT32_S = 64 * SM_RATE
PEAK_SFU_S = 16 * SM_RATE

# FP32 operations per unit: each +, -, *, /, sqrt, rsqrt, min, max and each
# math function call one operation; selects, compares and the hash not
OPS = dict(
    lane_round=41,  # cos(beta, p) 20, rate 3, free path + move 18
    in_grid_round=37,  # the comoving boost
    attempt=107,  # electron direction 57, rest-frame boost + axes 50
    attempt_stokes=167,  # + three Stokes rotations in the attempt
    mb=22,  # Maxwell-Boltzmann speed draw
    scatter=96,  # outgoing photon, two boosts
    scatter_stokes=434,  # + Fano matrix, four rotations, polarized angle set-up
    theta_trial=16,
    phi_trial=9,
    phi_trial_stokes=23,
)
# per round of a cyl2 frame: fluid velocity at the photon, membership test
OPS_GEO_CYL2 = (8, 12)
# (SFU instructions, FP32 operations, FP64 instructions) of one call
MATH = dict(sqrt=(1, 6, 0), rsqrt=(1, 2, 0), div=(1, 10, 0), exp=(1, 10, 0), log=(0, 27, 0),
            cos=(0, 20, 0), sincos=(0, 33, 0))
CALLS = dict(
    lane_round=dict(sqrt=2, div=3, log=1),
    in_grid_round=dict(rsqrt=1, sqrt=1, div=2),
    attempt=dict(div=8, sqrt=5, rsqrt=1, sincos=1),
    attempt_stokes=dict(div=8, sqrt=8, rsqrt=4, sincos=1),
    mb=dict(cos=1, log=2, rsqrt=1, sqrt=1),
    scatter=dict(sqrt=5, div=9, rsqrt=3),
    scatter_stokes=dict(sqrt=10, div=15, rsqrt=7),
    theta_trial=dict(div=2),
    phi_trial={},
    phi_trial_stokes=dict(div=3),
)
CALLS_GEO_CYL2 = (dict(sqrt=1, div=2), dict(sqrt=1))
# the counter hash: 12 integer operations a uniform, times the uniforms a
# unit draws
INT_OPS_PER_UNIFORM = 12
UNIFORMS = dict(lane_round=1, attempt=3, mb=3, theta_trial=2, phi_trial=2)
STATE_BYTES = 16 * 4


def frame_units(n_photons: int, n_scatt: int, stokes: bool) -> dict:
    """The units of work a DIRECT window needs (see the module's docstring)."""
    st = "_stokes" if stokes else ""
    rounds = n_photons + n_scatt
    return {"lane_round": rounds, "in_grid_round": rounds, "attempt" + st: n_scatt,
            "mb": n_scatt, "scatter" + st: n_scatt, "theta_trial": n_scatt,
            "phi_trial" + st: n_scatt}


def frame_bytes(n_photons: int, n_cells: int, rows_per_cell: int) -> int:
    """Each photon's state read and written once, each cell that holds a
    photon read once (``rows_per_cell`` float32 rows of the cell table)."""
    return n_photons * 2 * STATE_BYTES + n_cells * rows_per_cell * 4


def least_time(units: dict, nbytes: int, geo_ops: tuple, geo_calls: tuple, ops: dict = OPS,
               calls: dict = CALLS) -> tuple:
    """(seconds, pipe): the largest of the bytes over the HBM rate and of
    the work on each pipe over its rate.  ``units`` maps a unit of ``ops``
    and ``calls`` to its count, its ``lane_round`` count the rounds, which
    each also take the geometry's ``geo_ops`` operations and ``geo_calls``
    math calls (a configuration of another geometry or optical depth brings
    its own)."""
    rounds = units["lane_round"]
    fp32 = rounds * sum(geo_ops) + sum(n * ops[u] for u, n in units.items())
    count = collections.Counter()
    for part in geo_calls:
        for f, c in part.items():
            count[f] += rounds * c
    for u, n in units.items():
        for f, c in calls[u].items():
            count[f] += n * c
    # each call at its instructions in place of the operations OPS counts
    # for it (one; sincos two)
    fp32 += sum(n * (MATH[f][1] - (2 if f == "sincos" else 1)) for f, n in count.items())
    sfu = sum(n * MATH[f][0] for f, n in count.items())
    uniforms = sum(n * UNIFORMS[u.replace("_stokes", "")] for u, n in units.items()
                   if u.replace("_stokes", "") in UNIFORMS)
    times = dict(bytes=nbytes / PEAK_BYTES_S, fp32=fp32 / PEAK_F32_S,
                 int32=uniforms * INT_OPS_PER_UNIFORM / PEAK_INT32_S, sfu=sfu / PEAK_SFU_S)
    pipe = max(times, key=times.get)
    return times[pipe], pipe
