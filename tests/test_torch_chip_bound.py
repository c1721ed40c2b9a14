"""``chip_smoke.bound``: the least time of one fused-round call, held to a
count by hand on one tally.

The bound is the largest of five times: the bytes the call must move over
the HBM rate, and its work on each pipe the kernel uses -- float32
operations, the counter hash's integer operations, MUFU instructions on the
SFU and the double Klein-Nishina form -- over that pipe's rate (per-SM
results a clock for compute capability 9.0 x 132 SMs x 1.98 GHz; float32 at
the data sheet's 67 TFLOP/s).  Each math function counts at its
instructions (chip_smoke.MATH: sqrt 1 MUFU + 6 FP32 operations, rsqrt 1 +
2, division 1 + 10, exp 1 + 10, log 27 FP32, sin and cos of one argument
33 FP32; the double division 1 MUFU + 2 FP32 + 8 FP64, log1p 1 + 2 + 22).
The bytes count the cell-table rows the kernel reads (Cell::load) and the
aux planes an AUX family reads."""
import pytest

import chip_smoke as cs
from mcrat_tpu_torch.ops import fused_round as fr

# one call of packed_cyl2+cheb+nt (Stokes on): the twin's tally
WORK = dict(lane_rounds=2000, in_grid_rounds=1800, attempts=1000, mb=0, mj_trials=900,
            nt_draws=700, scatters=250, theta_trials=600, phi_trials=400, kn_double=800,
            warps_any_scatters=40, warps_dense_scatters=8)

# by hand, from the kernel source's counts (chip_smoke.OPS, CALLS, UNIFORMS)
OPS = (2000 * (41 + 8 + 12 + 53)  # lane rounds: base, cyl2 fluid, cyl2 membership, cheb_nt
       + 1800 * 37 + 1000 * 167 + 900 * 27 + 700 * 30 + 250 * 434 + 600 * 16 + 400 * 23)
# calls: a lane round 4 sqrt, 6 div, 1 log, 2 exp (with cheb_nt and cyl2's
# fluid and membership); in the grid 1 rsqrt, 1 sqrt, 2 div; an attempt with
# Stokes 8 div, 8 sqrt, 4 rsqrt, 1 sin+cos; an MJ trial 1 log, 1 sqrt; a
# nonthermal draw 3 exp, 1 log, 1 sqrt, 1 div; a scatter with Stokes 10 sqrt,
# 15 div, 7 rsqrt; a theta trial 2 div, a phi trial with Stokes 3 div; the
# KN form 4 double div, 1 log1p
SQRT = 2000 * 4 + 1800 + 1000 * 8 + 900 + 700 + 250 * 10
DIV = 2000 * 6 + 1800 * 2 + 1000 * 8 + 700 + 250 * 15 + 600 * 2 + 400 * 3
RSQRT = 1800 + 1000 * 4 + 250 * 7
LOG = 2000 + 900 + 700
EXP = 2000 * 2 + 700 * 3
SINCOS = 1000
DIV64, LOG1P64 = 800 * 4, 800
FP32 = (OPS + SQRT * 5 + DIV * 9 + RSQRT * 1 + LOG * 26 + EXP * 9 + SINCOS * 31
        + DIV64 * 2 + LOG1P64 * 2)
SFU = SQRT + DIV + RSQRT + EXP + DIV64 + LOG1P64
INT32 = 12 * (2000 * 1 + 1000 * 4 + 900 * 5 + 700 * 1 + 600 * 2 + 400 * 2)
FP64 = 800 * 12 + DIV64 * 8 + LOG1P64 * 22
SM_CLOCKS = 132 * 1.98e9


def test_hand_counts():
    assert (SQRT, DIV, RSQRT, LOG, EXP) == (21900, 30450, 7550, 3600, 6100)
    assert (OPS, FP32, INT32, SFU, FP64) == (634200, 1212800, 158400, 70000, 52800)


@pytest.mark.parametrize("n_lanes,run_lanes,n_cells,want_s,want_pipe", [
    # 1000 lanes of flags and out-flags, 500 running (state in and out, cell
    # index), 100 cells of the 26 rows packed_cyl2 CHEB_NT reads: the bytes bind
    (1000, 500, 100, (1000 * 8 + 500 * 132 + 100 * 26 * 4) / 3.35e12, "bytes"),
    # no bytes: float32 binds
    (0, 0, 0, FP32 / 67e12, "fp32"),
])
def test_bound_is_the_slowest_pipe(n_lanes, run_lanes, n_cells, want_s, want_pipe):
    ms, by, pipe = cs.bound("packed_cyl2+cheb+nt", "packed_cyl2", n_lanes, run_lanes, n_cells,
                            WORK, True)
    assert pipe == want_pipe
    assert by == ("bytes" if want_pipe == "bytes" else "operations")
    assert ms == pytest.approx(1e3 * want_s, rel=1e-12)
    times = (FP32 / 67e12, INT32 / (64 * SM_CLOCKS), SFU / (16 * SM_CLOCKS),
             FP64 / (64 * SM_CLOCKS))
    assert 1e3 * max(times) <= ms * (1 + 1e-12)


@pytest.mark.parametrize("variant,tau,rows", [
    ("ultra_cyl2", fr.TAU_DIRECT, 4),  # the whole physics table
    ("ultra_cart3", fr.TAU_CHEB, 5 + 16),  # + the knee and 15 coefficients
    ("slim_cyl2", fr.TAU_DIRECT, 8),
    # gamma, density, temperature, v0, v1, r0, r1, dr0, dr1 of 16 rows
    ("packed_cyl2", fr.TAU_DIRECT, 9),
    ("packed_cyl2", fr.TAU_CHEB_NT, 9 + 1 + 16),  # + the nonthermal density
    ("packed_cyl2", fr.TAU_AUX, 8),  # no density: n_sigma from the aux plane
    ("packed_cyl25", fr.TAU_AUX_NT, 9),  # + v2
    ("packed_sph2", fr.TAU_DIRECT, 11),  # + sin and cos of theta
    # + v2, r2, dr2, sin and cos of theta and of phi, 16 of 24 rows
    ("packed_sph3", fr.TAU_DIRECT, 16),
    ("packed_pol3", fr.TAU_CHEB, 14 + 16),
])
def test_table_rows_read(variant, tau, rows):
    assert cs.table_rows_read(variant, tau) == rows


@pytest.mark.parametrize("inst,tau,aux_bytes", [
    ("packed_cyl2+aux", fr.TAU_AUX, 4), ("packed_cyl2+aux+nt", fr.TAU_AUX_NT, 8)])
def test_aux_families_move_their_planes(inst, tau, aux_bytes):
    ms, _, pipe = cs.bound(inst, "packed_cyl2", 1000, 1000, 10, {}, True)
    want = 1000 * 8 + 1000 * (132 + aux_bytes) + 10 * cs.table_rows_read("packed_cyl2", tau) * 4
    assert pipe == "bytes"
    assert ms == pytest.approx(1e3 * want / 3.35e12, rel=1e-12)
