"""The frame builders at a tiny size, and the reference's own tables and
lookups against the program's, cell for cell."""
import copy

import numpy as np
import pytest
import torch

from benchmark import compare, spec
from benchmark.reference import frame as ref_frame
from benchmark.reference import rounds as ref_rounds


def tiny(name):
    data, builder = spec.config(name)
    data = copy.deepcopy(data)
    if "grid" in data:
        data["grid"] = {"r0": [0.0, 3.2e11, 9], "r1": [1.8e12, 2.9e12, 17]}
    else:
        data["blocks"]["bands"] = [[0.0, 1.28e11, 2, 4], [1.28e11, 3.2e11, 1, 2]]
    return data, builder


@pytest.mark.parametrize("name,cells", [("cyl2_jet", 8 * 16), ("amr_jet", 64 * 10)])
def test_frame_builders(name, cells):
    data, builder = tiny(name)
    cfg, host, edges = builder.build_host(data)
    assert host.num_elements == cells
    assert np.allclose(host.domain[:2], [[0.0, 3.2e11], [1.8e12, 2.9e12]])
    assert (edges is None) == (name == "amr_jet")
    # the outflow: Gamma = 100 along the jet axis, T' = 1e5 K everywhere
    assert np.allclose(host.gamma, 100.0) and np.allclose(host.temp, 1e5)
    assert np.all(host.v0 == 0) and np.allclose(host.v1, np.sqrt(1 - 1e-4))


def _inputs(name, n=(200, 400)):
    data, builder = tiny(name)
    mix, kind = spec.mix("frame_repeat", override=dict(min_photons=n[0], max_photons=n[1]))
    prob = kind.setup(data, builder, mix, 3, torch.device("cpu"))
    return data, prob, kind, builder


@pytest.mark.parametrize("name", ["cyl2_jet", "amr_jet"])
def test_reference_tables_and_lookups(name):
    from mcrat_tpu_torch import grid, transport

    data, prob, _, _ = _inputs(name)
    inp = prob.inputs
    ref = ref_frame.build_frame(inp, "cpu", torch.float32)
    if inp.edges is not None:
        assert ref.source == "ultra"
        assert torch.equal(ref.table, prob.frame.phys)
        ref_index = ref_frame.build_uniform_index(inp.edges, "cpu", torch.float32)
    else:
        assert ref.source == "packed"
        rows = [ref_rounds.PCOL[k] for k in ("r0", "r1", "dr0", "dr1", "v0", "v1", "gamma",
                                              "dens_lab", "temp")]
        assert torch.equal(ref.table[rows], prob.frame.packed[rows])
        ref_index = ref_frame.build_bin_index(inp.cells, "cpu", torch.float32)
        assert torch.equal(ref_index.cell_ids, prob.index.cell_ids)
    assert torch.equal(ref.domain, prob.frame.domain)
    # lookups of points in and around the domain, on cell seams too
    gen = np.random.default_rng(0)
    n = 4000
    r = gen.uniform(-1e10, 3.3e11, n)
    z = gen.uniform(1.79e12, 2.91e12, n)
    r[:200] = np.round(r[:200] / 2e10) * 2e10
    phi = gen.uniform(0, 2 * np.pi, n)
    pos = torch.tensor(np.stack([r * np.cos(phi), r * np.sin(phi), z], -1), dtype=torch.float32)
    if inp.edges is not None:
        want = grid.find_cell_direct(prob.cfg, prob.index, prob.frame, pos)
        got = ref_frame.find_cell_direct(ref_index, ref, pos)
    else:
        cached = torch.tensor(gen.integers(-1, prob.frame.num_elements, n), dtype=torch.int32)
        want = grid.find_cell_rows(prob.cfg, prob.index, prob.frame, pos, cached)
        got = ref_frame.find_cell_rows(ref_index, ref, pos, cached)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert int((got[0] >= 0).sum()) > n // 2
    # the glue's scalars and the packed population
    ph = ref_frame.photons_from_arrays(inp.photons, "cpu", torch.float32)
    for k in ref_frame.FIELDS:
        assert torch.equal(ph[k], getattr(prob.photons, k)), k
    want_g = transport.grid_scalars(prob.frame, prob.index)
    got_g = ref_frame.grid_scalars(ref, ref_index)
    assert (got_g.dom0, got_g.dom1, got_g.dom2, got_g.dom3) == \
        (want_g.dom0, want_g.dom1, want_g.dom2, want_g.dom3)
    if inp.edges is not None:
        assert (got_g.lo0, got_g.d0, got_g.lo1, got_g.d1, got_g.n1) == \
            (want_g.lo0, want_g.d0, want_g.lo1, want_g.d1, want_g.n1)


@pytest.mark.parametrize("name", ["cyl2_jet", "amr_jet"])
def test_reference_window_agrees_with_the_programs(name):
    """The plumbing end to end: the program's window (its plain twin on the
    CPU) and the reference's, from the same inputs on streams of their own,
    agree in distribution and keep every guarantee; the reference on the
    program's own stream does not give the program's photons (no lane of
    the program's is copied), and on another stream of its own it agrees
    with itself."""
    data, prob, kind, config = _inputs(name, (3000, 6000))
    inp = prob.inputs
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    res = kind.window(prob, g)
    assert res.n_scatt > 0
    prog = kind.fields(res)
    before = kind.before(prob, config, torch.device("cpu"))

    def holds(pos, cell):
        return ref_frame.cell_holds(inp, pos, cell)

    ref_ph, ref_t = ref_frame.transport_window(inp, kind.reference_generator(11), "cpu")
    ref = dict(ref_ph, t_rem=ref_t)
    out = compare.compare(before, prog, ref, res.n_scatt, inp.dt_max, holds)
    assert out["photons_off"] == 0 and out["scatter_count_off"] == 0
    assert out["stat_z_max"] < data["limits"]["stat_z_max"]
    assert not compare.guarantees(before, ref, inp.dt_max, holds).any()
    gen = torch.Generator()
    gen.set_state(state)
    same_stream, _ = ref_frame.transport_window(inp, gen, "cpu")
    assert not torch.equal(same_stream["num_scatt"], prog["num_scatt"])
    other, other_t = ref_frame.transport_window(inp, torch.Generator().manual_seed(12), "cpu")
    assert compare.stat_z(before, dict(other, t_rem=other_t), ref, inp.dt_max)["scatterings"] < 6


def test_fano_normalization_stays_finite():
    """A fully polarized photon scattered at 90 degrees in its polarization
    plane: the scattered intensity rounds to 0 in float32, where the
    program's division gives NaN; the reference's stays finite, its degree
    of polarization at most 1."""
    fi = torch.tensor([0.0, 2.0, 1e-9], dtype=torch.float32)
    fq = torch.tensor([1e-8, 1.0, 0.5], dtype=torch.float32)
    fu = torch.tensor([-1e-8, 0.5, 0.0], dtype=torch.float32)
    fv = torch.zeros(3)
    q, u, v = ref_rounds._fano_normalized(fi, fq, fu, fv)
    assert torch.isfinite(torch.stack([q, u, v])).all()
    assert torch.all(q * q + u * u + v * v <= 1.0 + 1e-6)
    assert q[1] == 0.5 and u[1] == 0.25 and q.dtype == torch.float32
