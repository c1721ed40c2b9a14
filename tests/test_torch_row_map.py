"""The fused-round kernel and its twin reading through a row map.

The active-first partition of ``transport.transport_rounds_fused`` reorders
a map of logical to physical 128-lane rows instead of the lane planes: a
logical lane keeps its logical block's ``block_act`` and its counter
stream, and its state, cell, flags, aux planes and out-flag live at its
physical lane (``fused_round.fused_rounds_reference``'s ``row_map``).

* On random maps the twin reading through the map equals the twin with no
  map run on the planes permuted into logical order, bit for bit, on
  chip_smoke.py's frames of ultra_cyl2 DIRECT, packed_sph2 DIRECT,
  packed_cyl2+cheb+nt and the AMR frame's packed_cyl2+aux+nt (Stokes on,
  pool lanes, an idle logical block).
* The glue, whose partitions move rows from its first call on (every other
  row starts with no time left), against the JAX package's
  ``transport_rounds_fused`` lane for lane, on the direct and the carried
  branch (as test_torch_fused_round's and test_torch_amr_glue's glue tests).
* Marked ``card``: the kernel reading through a random map equals its twin
  bit for bit, and equals the kernel with no map on the planes in logical
  order, on the five instantiations that the benchmark's cells and
  ``cli run`` launch; they skip without a CUDA card, and on one run with

    python -m pytest -q -o addopts="" --noconftest -m card tests/test_torch_row_map.py

This module imports no JAX (the card's machine has none); the JAX cases
import it when they run.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mcrat_tpu_torch import Config  # noqa: E402
from mcrat_tpu_torch.ops import fused_round as fr  # noqa: E402
from mcrat_tpu_torch.ops import hot_xsec  # noqa: E402

torch.set_num_threads(1)

S_ROWS = 8
# chip_smoke.py's (path, mode, injection seed, T' = 5e8 K) of an instantiation
FRAMES = {
    "ultra_cyl2": ("flagship", "direct", 0, False),
    "packed_cyl2": ("amr_cyl2", "direct", 0, False),
    "packed_sph2": ("spherical", "direct", 0, False),
    "packed_cyl2+cheb+nt": ("flagship", "nt", 3, True),
    "packed_cyl2+aux+nt": ("amr_cyl2", "aux_nt", 3, True),
}
TWIN_CASES = ["ultra_cyl2", "packed_cyl2+aux+nt", "packed_sph2", "packed_cyl2+cheb+nt"]


def nt_tables(device):
    """chip_smoke.py's power-law hot tables at coarse quadrature (the
    values are not under test, only that both sides read the same ones)."""
    cfg = cs.table_cfg(Config(), "nt")
    log_e, log_t, thermal = hot_xsec.build_thermal_table(8, 8, device=device)
    nt = hot_xsec.build_nonthermal_table(cfg, 8, 8, device=device)[1]
    table = hot_xsec.HotCrossSectionTable(log_e, log_t, thermal, nt,
                                          hot_xsec.electron_dist_subgroup_dens(cfg))
    return dict(nt=table, aux_nt=table)


def frame_call(inst, device, n_min, n_max, s_rows):
    """The :class:`chip_smoke.Call` of one 4-round call over every lane of
    ``inst``'s frame, every 7th live lane a pool photon, logical block 1
    idle."""
    name, mode, seed, hot = FRAMES[inst]
    tables = nt_tables(device) if mode != "direct" else None
    prob = cs.problem(name, device, n_min, n_max, seed=seed, hot=hot, mode=mode, tables=tables)
    call = cs.call_inputs(prob, True, idle_block=1, pool_lanes=True, s_rows=s_rows)
    assert call.inst == inst
    return call


def random_map(n_lanes, seed, device):
    """A random permutation of the 128-lane rows, int32, and each logical
    lane's physical lane."""
    g = torch.Generator().manual_seed(seed)
    row_map = torch.randperm(n_lanes // fr.LANES, generator=g).to(torch.int32)
    phys = (row_map.long()[:, None] * fr.LANES + torch.arange(fr.LANES)).reshape(-1)
    return row_map.to(device), phys.to(device)


def physical(call, phys):
    """The call's lane inputs (in logical order) moved to their physical
    lanes: (state, cell, flags, aux)."""
    cell, flags = call.args[:2]
    aux = call.kw["aux"]
    state = torch.empty_like(call.state)
    state[:, phys] = call.state
    cell_p, flags_p = torch.empty_like(cell), torch.empty_like(flags)
    cell_p[phys], flags_p[phys] = cell, flags
    aux_p = None
    if aux is not None:
        aux_p = torch.empty_like(aux)
        aux_p[:, phys] = aux
    return state, cell_p, flags_p, aux_p


def run_mapped(fn, call, row_map, state, cell, flags, aux):
    """``fn`` through ``row_map`` on physical lane inputs: (state, out-flags)."""
    state = state.clone()
    out = fn(state, cell, flags, *call.args[2:], **{**call.kw, "aux": aux}, row_map=row_map)
    return state, out


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_meaningful(call, state, out):
    """The call scattered, stalled and promoted lanes, and left logical
    block 1 (idle) untouched (``state``, ``out`` in logical order)."""
    block = call.kw["block_lanes"]
    idle = slice(block, 2 * block)
    assert int((state[fr.SP_NS] - call.state[fr.SP_NS]).sum()) > 0
    assert ((out & fr.OUT_STALLED) != 0).any() and ((out & fr.OUT_PROMOTED) != 0).any()
    assert torch.equal(bits(state[:, idle]), bits(call.state[:, idle]))
    assert not out[idle].any()


def _glue_against_jax(kind):
    """The port's glue (the twin) against JAX's ``transport_rounds_fused``
    on the same photons and key: 6 rounds in calls of 2; every third
    128-lane row starts with no time left and every third has its window
    over in its first round, so that the first two partitions on either
    branch move rows (the direct branch's as the active rows fall to 2/3
    and to 1/3)."""
    import jax
    import jax.numpy as jnp
    from mcrat_tpu import transport as jt
    from mcrat_tpu.config import PhotonType
    from mcrat_tpu.ops.rng import make_key
    from mcrat_tpu_torch import convert
    from mcrat_tpu_torch import transport as tt

    if kind == "direct":
        from test_torch_fused_round import _cylinder

        cfg, host, jidx, edges, photons = _cylinder(100.0, False, 7, 1500, 3000)
        tidx = convert.index_from_edges(*edges, device="cpu")
        tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu")
    else:
        from test_torch_amr_cases import CFG as cfg
        from test_torch_amr_cases import amr_hosts, inject, jax_index, port_index

        host, thost = amr_hosts()
        photons = inject(host, seed=7, n_min=1500, n_max=3000)
        jidx = jax_index(host)
        tidx = port_index(jidx)
        tframe = thost.to_device("cpu")
    ptype = np.asarray(photons.ptype).copy()
    ptype[::5] = int(PhotonType.CS_POOL)
    photons = photons.replace(ptype=jnp.asarray(ptype))
    jframe = host.to_device(dtype=jnp.float32)
    t_rem = np.array(jt.frame_time(photons, jnp.float32(0.05)))
    third = (np.arange(t_rem.size) // fr.LANES) % 3
    t_rem[third == 1] = 0.0
    t_rem[third == 2] = np.minimum(t_rem[third == 2], 1e-12)
    key = make_key(1)
    res = jt.transport_rounds_fused(cfg, photons, jframe, jidx, jnp.asarray(t_rem), key,
                                    max_rounds=6, inner_rounds=2, s_rows=S_ROWS,
                                    interpret=True)
    base_seed = int(jax.random.randint(key, (), jnp.iinfo(jnp.int32).min,
                                       jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    maps = []

    def spy(*args, row_map=None, **kw):
        maps.append(row_map.clone())
        return fr.fused_rounds_reference(*args, row_map=row_map, **kw)

    tcfg = convert.config_from_reference(cfg)
    tres = tt.transport_rounds_fused(
        tcfg, convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()},
                                         device="cpu"),
        tframe, tidx, torch.from_numpy(t_rem), base_seed=base_seed,
        setup=tt.select_variant(tcfg, tframe, tidx), max_rounds=6, inner_rounds=2,
        s_rows=S_ROWS, rounds_fn=spy)
    moved = {tuple(m.tolist()) for m in maps if not torch.equal(m, torch.arange(m.numel()))}
    assert len(maps) == 3 and len(moved) == 2  # two partitions moved rows
    a = {k: np.asarray(v) for k, v in vars(res.photons).items()}
    b = convert.photons_to_numpy(tres.photons)
    assert tres.n_rounds == int(res.n_rounds) == 2 * len(maps)
    n = len(a["weight"])
    same = a["num_scatt"] == b["num_scatt"]
    assert same.sum() >= 0.999 * n, n - same.sum()
    assert (a["cell"] == b["cell"]).sum() >= 0.999 * n
    np.testing.assert_array_equal(a["cell"][same], b["cell"][same])
    for k in ("ptype", "weight"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (b["ptype"] == int(PhotonType.COMPTONIZED)).any()  # pool promotion ran
    assert int(tres.n_scatt) == pytest.approx(int(res.n_scatt), rel=1e-3)
    dpos = np.linalg.norm(a["pos"] - b["pos"], axis=1)
    assert (dpos[same] <= 1e-4 * np.linalg.norm(a["pos"], axis=1)[same]).all()
    np.testing.assert_array_equal(tres.t_rem.numpy() > 0, np.asarray(res.t_rem) > 0)


@pytest.mark.parametrize("case", [*TWIN_CASES, "glue-direct-jax", "glue-carried-jax"])
def test_row_map_reads_the_rows_the_partition_moved(case, monkeypatch):
    """Twin cases: the twin through a random row map on physical lanes ==
    the twin without one on the lanes in logical order, bit for bit
    (state and out-flags), and the call scattered, stalled and promoted.
    Glue cases: the port's glue against JAX's, lane for lane."""
    if case.startswith("glue"):
        from test_torch_geometry_cases import jax_f32_fano

        monkeypatch.setattr(fr, "_fano_normalized", jax_f32_fano)
        _glue_against_jax(case.split("-")[1])
        return
    cpu = torch.device("cpu")
    call = frame_call(case, cpu, 3000, 4000, S_ROWS)
    row_map, phys = random_map(call.state.shape[1], 17, cpu)
    assert not torch.equal(row_map, torch.arange(row_map.numel(), dtype=torch.int32))
    st_l, out_l = call.run(fr.fused_rounds_reference)
    st_p, out_p = run_mapped(fr.fused_rounds_reference, call, row_map, *physical(call, phys))
    assert torch.equal(bits(st_p[:, phys]), bits(st_l))
    assert torch.equal(out_p[phys], out_l)
    assert_meaningful(call, st_l, out_l)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-round kernel runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("inst", list(FRAMES))
def test_kernel_reads_through_the_row_map_bit_for_bit(inst, card):
    """The kernel through a random row map (the main path's 128-row logical
    blocks) equals its twin through the same map, and the kernel with no
    map on the lanes in logical order, bit for bit: every state plane and
    the out-flags at their physical lanes, stalled and promoted lanes
    included; the idle logical block's physical lanes untouched."""
    call = frame_call(inst, card, 150_000, 300_000, 128)
    row_map, phys = random_map(call.state.shape[1], 23, card)
    inputs = physical(call, phys)
    st_k, out_k = run_mapped(fr.fused_rounds, call, row_map, *inputs)
    st_t, out_t = run_mapped(fr.fused_rounds_reference, call, row_map, *inputs)
    st_l, out_l = call.run(fr.fused_rounds)
    torch.cuda.synchronize()
    assert torch.equal(bits(st_k), bits(st_t)) and torch.equal(out_k, out_t)
    assert torch.equal(bits(st_k[:, phys]), bits(st_l)) and torch.equal(out_k[phys], out_l)
    assert_meaningful(call, st_k[:, phys], out_k[phys])
