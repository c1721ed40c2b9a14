"""Frames of every kernel variant, built by the JAX package, for the port's tests.

Each case is a small frame of one (dims x geometry) on a rectilinear grid,
built with mcrat_tpu's own models, plus the name of the fused-round variant
both packages must select for it.  The port receives the same frame through
``mcrat_tpu_torch.convert`` (numpy fields), so every comparison starts from
identical inputs.

A helper module of the other ``test_torch_*`` files: it defines no tests
itself.  ``lane_inputs`` lays an injected population out as the fused
kernel's lane planes (three logical blocks of ``BLOCK`` lanes, block 1 idle)
and returns both the JAX kernel's arguments (its own flags, cell rows and
domain vector, as ``mcrat_tpu.transport.transport_rounds_fused`` builds
them) and the port's (cell index, table, grid scalars).  In TABLE mode
(``xsec``) both kernels get the port's float32 Chebyshev rows and, with
nonthermal electrons, the same global subgroup-1 fit; with ``aux`` (the
carried AMR path's K5) they get the packed rows and the port's aux planes
(``transport.aux_planes``) instead.
"""
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import (
    Config, Dims, Geometry, NonthermalDist, SimType, Spectrum, TauCalculation,
)
from mcrat_tpu.constants import M_P
from mcrat_tpu.grid import PCOL, build_rectilinear_index, find_cell_direct
from mcrat_tpu.grid import frame_from_numpy as jframe_from_numpy
from mcrat_tpu.models import analytic as jan
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu.ops import pallas_round as pr
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.models import analytic as tan
from mcrat_tpu_torch.ops import cyclosynch as tcs
from mcrat_tpu_torch.ops import fused_round as fr
from mcrat_tpu_torch.ops import hot_xsec as thx

S_ROWS = 8
BLOCK = S_ROWS * pr.LANES

# the new variants, each with the frame kind that selects it
VARIANT_CASES = ["ultra_sph2", "ultra_cart3", "slim_cyl2", "packed_cyl2", "packed_cyl25",
                 "packed_sph2", "packed_sph25", "packed_cart3", "packed_sph3", "packed_pol3"]

CYL_EDGES = (np.linspace(0.0, 3.2e11, 33), np.linspace(1.8e12, 2.9e12, 65))

# the nonthermal distributions of the TABLE-mode cases: bench.py's power law
# and a broken power law
NT_DISTS = dict(
    powerlaw=dict(nonthermal_e_dist=NonthermalDist.POWERLAW, powerlaw_index=2.5,
                  gamma_min=1.0, gamma_max=100.0),
    broken=dict(nonthermal_e_dist=NonthermalDist.BROKENPOWERLAW, powerlaw_index_1=1.5,
                powerlaw_index_2=3.0, gamma_break=10.0, gamma_min=1.0, gamma_max=1000.0),
)


def table_cfg(cfg, dist=None):
    """``cfg`` in TABLE mode, with the nonthermal distribution ``dist``
    (a key of NT_DISTS) or thermal electrons only."""
    return dataclasses.replace(cfg, tau_calculation=TauCalculation.TABLE,
                               **(NT_DISTS[dist] if dist else {}))


def xsec_tables(dist=None):
    """The JAX package's float64 hot cross-section tables (its own build:
    the port's build is tested against it in test_torch_hot_xsec), handed
    to the port through ``convert.xsec_table_from_numpy``."""
    log_e, log_t, thermal = jhx.build_thermal_table()
    nt = frac = None
    if dist:
        cfg = table_cfg(Config(), dist)
        nt = jhx.build_nonthermal_table(cfg)[1]
        frac = tcs.electron_dist_subgroup_dens(convert.config_from_reference(cfg))
    return convert.xsec_table_from_numpy(log_e, log_t, thermal, nt, frac)


def jax_f32_kn(e):
    """``pallas_round._kn_cross_section`` transcribed: the JAX kernel's
    float32 closed form, fault F6 unrepaired.  Lane-for-lane tests on hot
    frames put it in place of the port's repaired form (monkeypatch) so
    that both kernels accept the same scatterings."""
    se = torch.clamp(e, min=1e-10)
    full = 0.75 * (
        2.0 / (se * se)
        + (1.0 / (2.0 * se) - (1.0 + se) / (se * (se * se))) * torch.log1p(2.0 * se)
        + (1.0 + se) / ((1.0 + 2.0 * se) * (1.0 + 2.0 * se))
    )
    return torch.where(e >= 1e-3, full, 1.0 - 2.0 * e)


def jax_f32_fano(fi, fq, fu, fv):
    """The JAX kernel's Fano normalization transcribed: one reciprocal of
    the scattered intensity in the working precision, fault F13 unrepaired.
    Lane-for-lane tests put it in place of the port's float64 division
    (monkeypatch), as ``jax_f32_kn`` for F6, so that both kernels carry the
    same Stokes vectors into the polarized angle draws."""
    inv_i = 1.0 / fi
    return fq * inv_i, fu * inv_i, fv * inv_i


def make_grid_3d(e0, e1, e2) -> dict:
    """Rectilinear 3-D grid arrays (C-order raveled meshgrid), v = 0."""
    c = [0.5 * (e[:-1] + e[1:]) for e in (e0, e1, e2)]
    g = np.meshgrid(*c, indexing="ij")
    d = np.meshgrid(*[np.diff(e) for e in (e0, e1, e2)], indexing="ij")
    n = g[0].size
    return dict(r0=g[0].ravel(), r1=g[1].ravel(), r2=g[2].ravel(),
                dr0=d[0].ravel(), dr1=d[1].ravel(), dr2=d[2].ravel(),
                v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n),
                dens=np.ones(n), pres=np.ones(n))


def _set_v2(host, v0_scale, v2):
    """Give a frame a phi-hat velocity and a consistent Lorentz factor."""
    host.v0 = host.v0 * v0_scale
    host.v1 = host.v1 * v0_scale
    host.v2 = np.full(host.num_elements, v2)
    host.gamma = 1.0 / np.sqrt(1.0 - (host.v0 ** 2 + host.v1 ** 2 + host.v2 ** 2))
    host.dens_lab = host.dens * host.gamma


def frame_case(name, gamma=2.0, temp=1e5, thin=False, port=False):
    """(cfg, host frame, edges, injection kwargs) of a variant's frame: an
    outflow of Lorentz factor ``gamma`` at one uniform temperature, built by
    mcrat_tpu (or, with ``port``, by mcrat_tpu_torch's own host frame and
    models).
    ``thin`` scales the density down (by 1e-7 to 1e-3) until
    a free path is a sizeable fraction of a cell, so that lanes both scatter
    and leave their cells within a kernel call of one second."""
    an, frame_from_numpy = (tan, tgrid.frame_from_numpy) if port else (jan, jframe_from_numpy)
    # the port's models take the port's Config
    conv = convert.config_from_reference if port else (lambda c: c)
    kind = name.split("_", 1)[1]
    inj = dict(r_inj=2e12, theta_max=np.pi / 30)
    if kind in ("sph2", "sph25"):
        dims = Dims.TWO if kind == "sph2" else Dims.TWO_POINT_FIVE
        cfg = conv(Config(dims=dims, geometry=Geometry.SPHERICAL,
                          simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32"))
        # tests/test_pallas_round.py::_spherical_problem, ten times closer in
        host, edges = an.synthetic_spherical_frame(
            cfg, 5e11, 4e12, nr=48, ntheta=6, theta_max=np.pi / 3,
            log_r=name != "ultra_sph2")
        an.spherical_prep(host, gamma_infinity=gamma)
        if kind == "sph25":
            _set_v2(host, 0.8, 0.3)
        inj = dict(r_inj=1e12, theta_max=np.pi / 6)
    elif kind in ("cyl2", "cyl25"):
        cfg = conv(Config(dims=Dims.TWO if kind == "cyl2" else Dims.TWO_POINT_FIVE,
                          geometry=Geometry.CYLINDRICAL,
                          simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32"))
        edges = CYL_EDGES
        if name == "slim_cyl2":
            edges = (CYL_EDGES[0], np.geomspace(1.8e12, 2.9e12, 65))
        host = frame_from_numpy(cfg, an.make_grid_2d(cfg, *edges))
        an.cylindrical_prep(host, gamma_infinity=gamma)
        if name == "packed_cyl2":
            # a phi-hat velocity in a 2-D frame: no slim table, and the
            # kernel ignores it (mcrat_tpu/ops/pallas_round.py:636-640)
            _set_v2(host, 1.0, 1e-3)
        elif kind == "cyl25":
            _set_v2(host, 0.8, 0.3)
    else:
        cfg = conv(Config(dims=Dims.THREE,
                          geometry=dict(cart3=Geometry.CARTESIAN, sph3=Geometry.SPHERICAL,
                                        pol3=Geometry.POLAR)[kind],
                          simulation_type=(SimType.SPHERICAL_OUTFLOW if kind == "sph3"
                                           else SimType.CYLINDRICAL_OUTFLOW),
                          dtype="float32"))
        if kind == "cart3":
            ez = (np.linspace if name == "ultra_cart3" else np.geomspace)(1.8e12, 2.9e12, 33)
            edges = (np.linspace(-4e11, 4e11, 17), np.linspace(-4e11, 4e11, 17), ez)
        elif kind == "sph3":
            # tests/test_pallas_round.py::_grid_3d, with four times the radii
            edges = (np.geomspace(1e12, 2e13, 193), np.linspace(1e-3, np.pi / 3, 13),
                     np.linspace(0.0, 2 * np.pi, 9))
            inj = dict(r_inj=3e12, theta_max=np.pi / 6)
        else:
            edges = (np.linspace(1e10, 3.2e11, 17), np.linspace(0.0, 2 * np.pi, 9),
                     np.linspace(1.8e12, 2.9e12, 33))
        host = frame_from_numpy(cfg, make_grid_3d(*edges))
        if kind == "sph3":
            an.spherical_prep(host, gamma_infinity=gamma)
        else:
            an.cylindrical_prep(host, gamma_infinity=gamma)
    host.temp = np.full(host.num_elements, float(temp))
    if thin:
        scale = dict(sph2=1e-7, sph25=1e-7, sph3=1e-6).get(kind, 1e-3)
        host.dens = host.dens * scale
        host.dens_lab = host.dens_lab * scale
    return cfg, host, tuple(edges), inj


def jax_problem(kind, cold=False):
    """(cfg, JAX host frame, edges, JAX photons, frame window) of
    tests/test_pallas_round.py::_spherical_problem (2-D), ::_grid_3d
    (spherical, polar) and a 16x16x32 cut of bench.py's 3-D cartesian
    frame; ``cold`` at a uniform T' = 1e5 K.  Capacity 5120 for all."""
    if kind == "spherical_2d":
        cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                     simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32")
        host, edges = jan.synthetic_spherical_frame(cfg, r_min=5e12, r_max=4e13, nr=48,
                                                    ntheta=6, theta_max=np.pi / 3)
        inj = dict(r_inj=1e13, min_photons=1000, max_photons=4000, theta_max=np.pi / 6)
        seed, dt = 3, 0.3
    elif kind == "cartesian_3d":
        cfg, host, edges, _ = frame_case("ultra_cart3", gamma=100.0)
        inj = dict(r_inj=2e12, min_photons=1500, max_photons=5000, theta_max=np.pi / 30)
        seed, dt = 41, 0.05
    else:
        sph = kind == "spherical_3d"
        cfg = Config(dims=Dims.THREE, geometry=Geometry.SPHERICAL if sph else Geometry.POLAR,
                     simulation_type=(SimType.SPHERICAL_OUTFLOW if sph
                                      else SimType.CYLINDRICAL_OUTFLOW), dtype="float32")
        if sph:
            edges = (np.geomspace(1e12, 2e13, 49), np.linspace(1e-3, np.pi / 3, 13),
                     np.linspace(0.0, 2 * np.pi, 9))
        else:
            edges = (np.linspace(1e10, 3.2e11, 17), np.linspace(0.0, 2 * np.pi, 9),
                     np.linspace(1.8e12, 2.9e12, 33))
        host = jframe_from_numpy(cfg, make_grid_3d(*edges))
        jan.apply_simulation_type(host)
        inj = dict(r_inj=3e12 if sph else 2e12, min_photons=1500, max_photons=5000,
                   theta_max=np.pi / 6 if sph else np.pi / 30)
        seed, dt = 31, 0.3 if sph else 0.05
    if cold:
        host.temp = np.full(host.num_elements, 1e5)
    arrays, _ = jt.inject_photons(host, ph_weight=1e50, spect=Spectrum.BLACKBODY,
                                  theta_min=0.0, fps=5.0, rng=np.random.default_rng(seed),
                                  **inj)
    # one capacity for both runs: JAX compiles its glue once
    photons, _ = jt.photons_from_arrays(arrays, capacity=5120, dtype=jnp.float32)
    return cfg, host, tuple(edges), photons, dt


def inject(host, inj, seed, n_min=1000, n_max=2 * BLOCK):
    """JAX photons (float32) injected into ``host``."""
    arrays, _ = jt.inject_photons(
        host, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, fps=5.0,
        rng=np.random.default_rng(seed), **inj)
    photons, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jnp.float32)
    return photons


def to_port(cfg, host, edges, photons=None):
    """The port's frame, index and photons, carried across as numpy."""
    tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu")
    tidx = convert.index_from_edges(*edges, device="cpu")
    tph = None if photons is None else convert.photons_from_numpy(
        {k: np.asarray(v) for k, v in vars(photons).items()}, device="cpu")
    return tframe, tidx, tph


def lane_inputs(name, seed=7, gamma=2.0, temp=1e5, xsec=None, dist=None, aux=False):
    """Kernel inputs of a variant's thinned frame: three logical blocks
    (block 1 an idle copy of block 0), every 7th live lane a CS pool photon.
    ``xsec`` (the port's table) runs TABLE mode, ``dist`` adds that
    nonthermal population (nonthermal density from the equipartition B
    field, as bench.py:292); ``aux`` runs TABLE mode through aux planes, as
    the carried AMR path does (the variant then comes from a BinnedIndex
    over the frame's cells).  Returns a dict with the numpy lane planes and
    both packages' arguments."""
    cfg, host, edges, inj = frame_case(name, gamma, temp, thin=True)
    if xsec is not None:
        cfg = table_cfg(cfg, dist)
    tcfg = convert.config_from_reference(cfg)
    if dist:
        host.nonthermal_dens = tcs.nonthermal_electron_dens(tcfg, host)
    photons = inject(host, inj, seed)
    jframe = host.to_device(dtype=jnp.float32)
    jidx = build_rectilinear_index(*edges, dtype="float32")
    cap = photons.capacity
    assert cap <= 2 * BLOCK
    order = np.concatenate([np.arange(BLOCK), np.arange(BLOCK), np.arange(BLOCK, 2 * BLOCK)])

    def plane(x):
        a = np.zeros(2 * BLOCK, np.float32)
        a[:cap] = np.asarray(x, np.float32)
        return a[order]

    p, pos, s, c = (np.asarray(a) for a in (photons.p, photons.pos, photons.s, photons.comv_p))
    state = np.stack(
        [plane(p[:, i]) for i in range(4)] + [plane(pos[:, i]) for i in range(3)]
        + [plane(s[:, i]) for i in (1, 2, 3)]
        + [plane(np.ones(cap)), plane(np.zeros(cap))]
        + [plane(c[:, i]) for i in range(4)])
    alive = plane(np.asarray(photons.alive)) > 0
    pool = alive & (np.arange(alive.size) % 7 == 3)
    cell, in_grid = find_cell_direct(cfg, jidx, jframe,
                                     jnp.asarray(state[fr.SP_X:fr.SP_Z + 1].T))
    safe = np.clip(np.asarray(cell), 0, jframe.num_elements - 1).astype(np.int32)
    flags = (alive.astype(np.int32) * fr.FLAG_ALIVE + pool.astype(np.int32) * fr.FLAG_POOL
             + np.asarray(in_grid).astype(np.int32) * fr.FLAG_INGRID)

    # the JAX kernel's arguments, as its glue builds them
    var = fr.VARIANTS[name]
    dom = np.asarray(jframe.domain, np.float32).reshape(-1)
    jflags = flags
    kw = {}
    if var.source == "ultra":
        pk = np.asarray(jframe.packed)
        if var.geom == "cart3":
            table = np.stack([pk[PCOL["v0"]], pk[PCOL["v1"]], pk[PCOL["v2"]],
                              np.asarray(jnp.asarray(pk[PCOL["dens_lab"]]) * (1.0 / M_P)),
                              pk[PCOL["temp"]]])
            n1, n2 = len(edges[1]) - 1, len(edges[2]) - 1
            ci = safe // (n1 * n2)
            rem = safe - ci * n1 * n2
            cj = rem // n2
            jflags = flags | (ci << 23) | (cj << 13) | ((rem - cj * n2) << 3)
        else:
            table = np.asarray(jframe.packed_slim)[4:8]
            n1 = len(edges[1]) - 1
            ci = safe // n1
            jflags = flags | (ci << 17) | ((safe - ci * n1) << 3)
        e32 = [np.asarray(e, np.float32) for e in edges]
        parts = [v for e in e32 for v in (e[0], e[1] - e[0])]
        geom = np.concatenate([dom, np.asarray(parts, np.float32)])
        kw["ultra"] = True
    else:
        table = np.asarray(jframe.packed_slim if var.source == "slim" else jframe.packed)
        geom = dom
        kw["slim"] = var.source == "slim"
    tframe, tidx, _ = to_port(cfg, host, edges)
    if aux:
        tidx = tgrid.build_binned_index(convert.frame_from_numpy_fields(cfg, vars(host)),
                                        device="cpu")
    setup = tt.select_variant(tcfg, tframe, tidx, xsec)
    ttable = setup.table
    assert setup.variant == name, (setup.variant, name)
    width = var.width
    np.testing.assert_array_equal(ttable.numpy()[:width], np.asarray(table, np.float32))
    aux_planes = None
    if aux:
        assert setup.cheb_base == 0 and setup.aux is xsec and ttable.shape[0] == width
        assert (setup.nt is not None) == bool(dist)
        kw["nonthermal"] = bool(dist)
        aux_planes = tt.aux_planes(tcfg, xsec, tframe, torch.from_numpy(safe),
                                   torch.from_numpy(state[fr.SP_C0])).numpy()
    elif xsec is not None:
        # the port's float32 Chebyshev rows (and subgroup-1 fit) go to both
        assert setup.cheb_base == width and ttable.shape[0] == width + thx.CHEB_ROWS
        table = ttable.numpy()
        kw["cheb_base"] = width
        if dist:
            kw["nonthermal"] = True
            kw["nt_sub1"] = thx._sub1_cheb_static(tcfg, xsec.log_e, xsec.nonthermal[:, 0])
    rows = np.ascontiguousarray(table[:, safe])
    return dict(cfg=cfg, state=state, alive=alive, pool=pool, safe=safe, flags=flags,
                jflags=jflags, rows=rows, geom=geom, jax_kw=kw, table=ttable,
                setup=setup, grid=setup.grid, variant=name,
                aux=aux_planes)


def jax_kernel(d, block_act, seed, stokes_on, inner_rounds=2):
    """``pallas_round.fused_rounds`` in interpret mode on ``lane_inputs``."""
    nrow = d["rows"].shape[0]
    aux = None if d["aux"] is None else jnp.asarray(d["aux"].reshape(2, -1, pr.LANES))
    res = pr.fused_rounds(
        d["cfg"], jnp.int32(seed), jnp.asarray(d["geom"]),
        jnp.asarray(d["state"].reshape(16, -1, pr.LANES)),
        jnp.asarray(d["rows"].reshape(nrow, -1, pr.LANES)),
        jnp.asarray(d["jflags"].reshape(1, -1, pr.LANES)),
        aux=aux, block_act=jnp.asarray(block_act), stokes_on=stokes_on,
        inner_rounds=inner_rounds, s_rows=S_ROWS, interpret=True, **d["jax_kw"])
    return np.asarray(res.state).reshape(16, -1), np.asarray(res.out_flags).reshape(-1)


def port_kernel(d, block_act, seed, stokes_on, inner_rounds=2):
    """The port's ``fused_rounds`` (the twin, on CPU tensors) on ``lane_inputs``,
    with the JAX kernel's Fano normalization (:func:`jax_f32_fano`)."""
    ts = torch.from_numpy(d["state"].copy())
    with mock.patch.object(fr, "_fano_normalized", jax_f32_fano):
        out = fr.fused_rounds(ts, torch.from_numpy(d["safe"]), torch.from_numpy(d["flags"]),
                              d["table"], torch.from_numpy(block_act), seed, d["grid"],
                              stokes_on=stokes_on, inner_rounds=inner_rounds, block_lanes=BLOCK,
                              variant=d["variant"], cheb_base=d["setup"].cheb_base,
                              nt=d["setup"].nt,
                              aux=None if d["aux"] is None else torch.from_numpy(d["aux"]))
    return ts.numpy(), out.numpy()


NON_STOKES = [i for i in range(fr.N_STATE) if i not in (fr.SP_Q, fr.SP_U, fr.SP_V)]
STOKES = [fr.SP_Q, fr.SP_U, fr.SP_V]


def check_twin_against_jax_kernel(variant, temp=1e5, stokes_on=True, seed=123456789,
                                  inner_rounds=2, min_stalled=100, xsec=None, dist=None,
                                  min_scatt=500, frac_close=1.0, rtol_all=None, aux=False):
    """Hold the port's twin against JAX's interpret-mode kernel, lane for
    lane, on ``variant``'s frame (see the test modules' docstrings for the
    tolerances), in TABLE mode with ``xsec`` and with the nonthermal
    population ``dist``, through aux planes with ``aux``.  With
    ``frac_close`` < 1 the non-Stokes planes need rtol 1e-4 / atol 1e-6 on
    that fraction of the lanes that agree and ``rtol_all`` on all of them.
    Returns the port's out-flags."""
    d = lane_inputs(variant, temp=temp, xsec=xsec, dist=dist, aux=aux)
    block_act = np.array([1, 0, 1], np.int32)
    js, jf = jax_kernel(d, block_act, seed, stokes_on, inner_rounds)
    calls = (fr.fused_rounds.launches, fr.fused_rounds_reference.launches)
    ts, tf = port_kernel(d, block_act, seed, stokes_on, inner_rounds)
    # a CPU tensor runs the plain twin, never the kernel
    assert (fr.fused_rounds.launches, fr.fused_rounds_reference.launches) == (
        calls[0], calls[1] + 1)

    state, alive, pool = d["state"], d["alive"], d["pool"]
    on = np.repeat(block_act != 0, BLOCK)
    live = on & alive
    for out_state, out_flags in ((ts, tf), (js, jf)):
        np.testing.assert_array_equal(out_state[:, ~on], state[:, ~on])
        assert not out_flags[~on].any()
    assert (js[fr.SP_NS] - state[fr.SP_NS]).sum() > min_scatt  # photons do scatter
    # and leave their cells: the membership test decides
    assert ((jf & fr.OUT_STALLED) != 0).sum() > min_stalled
    same = (ts[fr.SP_NS] == js[fr.SP_NS]) & (tf == jf) & live
    assert same.sum() >= 0.999 * live.sum(), (live.sum() - same.sum(), live.sum())
    outside = np.zeros(int(same.sum()), bool)
    for i in NON_STOKES:
        if fr.SP_X <= i <= fr.SP_Z:
            continue
        a, b = ts[i][same], js[i][same]
        if frac_close == 1.0:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f"plane {i}")
        else:
            outside |= np.abs(a - b) > 1e-6 + 1e-4 * np.abs(b)
            np.testing.assert_allclose(a, b, rtol=rtol_all, atol=1e-6, err_msg=f"plane {i}")
    assert 1.0 - outside.mean() >= frac_close, outside.mean()
    # positions by their norm: a coordinate that crosses zero keeps the
    # absolute error of the path, ~eps |x|
    pos = slice(fr.SP_X, fr.SP_Z + 1)
    dpos = np.linalg.norm(ts[pos][:, same] - js[pos][:, same], axis=0)
    assert (dpos <= 1e-4 * np.linalg.norm(js[pos][:, same], axis=0)).all()
    dq = np.max([np.abs(ts[i][same] - js[i][same]) for i in STOKES], axis=0)
    assert (dq <= 5e-3).mean() >= 0.995, np.quantile(dq, [0.5, 0.99, 1.0])
    if not stokes_on:
        np.testing.assert_array_equal(ts[STOKES], state[STOKES])
    # pool lanes stay put and are promoted when they scatter
    np.testing.assert_array_equal(ts[fr.SP_X:fr.SP_Z + 1][:, pool & on],
                                  state[fr.SP_X:fr.SP_Z + 1][:, pool & on])
    promoted = (tf & fr.OUT_PROMOTED) != 0
    assert promoted[pool & on].any() and not promoted[~pool].any()
    return tf
