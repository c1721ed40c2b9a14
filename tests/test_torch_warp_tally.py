"""The fused-round twin's warp tally (``fused_round.warp_tally`` and the
``warps_*`` keys of ``fused_rounds_reference.work``).

For a branch of the kernel taken on a mask of lanes, the tally counts the
32-lane warps that run it with one thread a lane (any lane of the warp takes
it) and the warps it needs once each CUDA block of the instantiation's
``cuda_block`` threads packs its lanes that take it (the sum over blocks of
ceil(count / 32)).
Hand-made masks check both counts; on a small nonthermal frame (the
flagship-type cylindrical grid at T' = 5e8 K, TABLE hot cross sections,
bench.py's power law) the counts are held to their bounds
(sum / 32 <= dense <= any lane <= lanes / 32 for every branch), and the
tally leaves the twin's outputs bit-identical to a run without it.
"""
import collections

import numpy as np
import pytest
import torch

from mcrat_tpu_torch.ops import fused_round as fr

from test_torch_geometry_cases import BLOCK, lane_inputs, port_kernel, xsec_tables

torch.set_num_threads(1)


def _tally(lanes, mask, block):
    n_any, n_dense = fr.warp_tally(torch.as_tensor(mask), torch.as_tensor(lanes), block)
    return int(n_any), int(n_dense)


BLOCKS = sorted({fr.cuda_block(v, tau, s) for _, v, tau, s in fr.instantiation_specs()})


def test_cuda_block_is_whole_warps():
    assert BLOCKS == [256, 512]
    for b in BLOCKS:
        assert b % fr.WARP == 0 and 16384 % b == 0


def test_cuda_block_and_layout_of_instantiations():
    # 512 threads with Stokes where two blocks of the layout fit an SM's
    # 228 KB: every layout but packed_sph3 CHEB_NT's 56 floats a lane
    assert fr.layout_floats("ultra_cyl2", fr.TAU_DIRECT) == 28
    assert fr.layout_floats("packed_cyl2", fr.TAU_CHEB_NT) == 47
    assert fr.layout_floats("packed_cyl2", fr.TAU_AUX_NT) == 29
    assert fr.layout_floats("packed_sph3", fr.TAU_CHEB) == 54
    assert fr.layout_floats("packed_sph3", fr.TAU_CHEB_NT) == 56
    assert fr.cuda_block("packed_cyl2", fr.TAU_CHEB_NT, True) == 512
    assert fr.cuda_block("packed_sph3", fr.TAU_CHEB, True) == 512
    assert fr.cuda_block("packed_sph3", fr.TAU_CHEB_NT, True) == 256
    assert fr.cuda_block("ultra_cyl2", fr.TAU_DIRECT, False) == 256


# hand-made masks over 4 CUDA blocks of B lanes: (lanes taken, (any-lane
# warps, dense warps)) as functions of B
HAND = {
    "none": lambda B: ([], (0, 0)),
    "one": lambda B: ([0], (1, 1)),
    "three in a warp": lambda B: ([5, 17, 31], (1, 1)),
    "two warps pack into one": lambda B: ([0, 32], (2, 1)),
    "33 lanes": lambda B: (list(range(33)), (2, 2)),
    "one lane a warp of block 0": lambda B: (list(range(0, B, 32)), (B // 32, 1)),
    # neighbours in two blocks do not pack together
    "two blocks": lambda B: ([B - 1, B], (2, 2)),
    # one lane in each warp of 4 blocks: B / 32 lanes a block
    "one lane a warp": lambda B: (list(range(0, 4 * B, 32)),
                                  (4 * B // 32, 4 * -(-(B // 32) // 32))),
    "all": lambda B: (list(range(4 * B)), (4 * B // 32, 4 * B // 32)),
}


@pytest.mark.parametrize("B", BLOCKS)
@pytest.mark.parametrize("case", list(HAND))
def test_warp_tally_hand_masks(case, B):
    taken, want = HAND[case](B)
    lanes = np.arange(4 * B)
    mask = np.zeros(4 * B, bool)
    mask[taken] = True
    assert _tally(lanes, mask, B) == want


@pytest.mark.parametrize("B", BLOCKS)
def test_warp_tally_on_a_subset_of_lanes(B):
    # the twin's lanes are those of active blocks: every other lane here,
    # each CUDA block holds B / 2 of them
    lanes = np.arange(0, 8 * B, 2)
    assert _tally(lanes, np.ones(lanes.size, bool), B) == (8 * B // 32, 8 * B // 64)
    mask = np.zeros(lanes.size, bool)
    mask[::16] = True  # lane numbers 0, 32, 64, ...: one a warp, B / 32 a block
    assert _tally(lanes, mask, B) == (8 * B // 32, 8)


@pytest.fixture(scope="module")
def nonthermal_lanes():
    return lane_inputs("packed_cyl2", temp=5e8, xsec=xsec_tables("powerlaw"), dist="powerlaw")


def test_warp_tally_bounds_and_bit_identity_on_a_nonthermal_frame(nonthermal_lanes):
    d = nonthermal_lanes
    block_act = np.array([1, 0, 1], np.int32)
    rounds, seed = 4, 97531
    plain_state, plain_out = port_kernel(d, block_act, seed, True, inner_rounds=rounds)
    fr.fused_rounds_reference.work = collections.Counter()
    try:
        state, out = port_kernel(d, block_act, seed, True, inner_rounds=rounds)
        work = {k: float(v) for k, v in fr.fused_rounds_reference.work.items()}
    finally:
        fr.fused_rounds_reference.work = None
    np.testing.assert_array_equal(state.view(np.int32), plain_state.view(np.int32))
    np.testing.assert_array_equal(out, plain_out)
    assert set(work) == set(fr.WORK_KEYS)

    active_warps = int(block_act.sum()) * BLOCK // fr.WARP
    for branch, per_round in (("attempts", 1), ("nt_draws", 1), ("scatters", 1),
                              ("mj_trials", fr.EL_ITERS)):
        lanes, n_any, n_dense = (work[branch], work[f"warps_any_{branch}"],
                                 work[f"warps_dense_{branch}"])
        assert lanes > 0, branch
        assert lanes / fr.WARP <= n_dense <= n_any <= rounds * per_round * active_warps, branch
    # the population draw splits the attempts: the nonthermal draws leave
    # holes in the warps of the attempts
    assert work["warps_dense_nt_draws"] < work["warps_any_nt_draws"]
