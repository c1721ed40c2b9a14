"""The port's XLA-engine samplers against ``mcrat_tpu.ops`` with the same
threefry key, lane for lane in float64, and tests/test_electrons.py's moment
checks on the port.

* ``single_scatter`` (Stokes on and off), ``sample_thermal_electron``,
  ``sample_nonthermal_electron`` (power law and broken power law),
  ``sample_kn_angles``: the same lanes accept (flags identical), and every
  continuous output agrees within rtol 1e-10 of the field's scale (a
  momentum component is held relative to its vector's norm: components that
  cancel to ~0 carry the norm's last-place differences).
* The Maxwell-Juttner first moment against quadrature from T = 1e5 K to
  1e11 K (100,000 draws, half tests/test_electrons.py's: its 5-sigma bound
  scales with the count), a six-decade mixed batch, and the relative-angle
  law, at tests/test_electrons.py's tolerances.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu.config import Config, NonthermalDist, TauCalculation
from mcrat_tpu.ops import compton as jc
from mcrat_tpu.ops import electrons as je
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch.constants import KB_OVER_MEC2
from mcrat_tpu_torch.ops import compton as tc
from mcrat_tpu_torch.ops import electrons as te
from mcrat_tpu_torch.ops import prng

from test_electrons import mj_moments

N = 3000
RTOL = 1e-10


def _keys(seed):
    return prng.Key.from_seed(seed), make_key(seed, impl="threefry2x32")


def _photons(seed, n=N, log_e=(-4.0, 1.0)):
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(n, 3))
    e = 10 ** rs.uniform(*log_e, n)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([e[:, None], d * e[:, None]], 1)


def _same_vectors(got, want):
    """(N, k) rows within RTOL of each row's largest component."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= RTOL * scale).all(), np.max(np.abs(got - want) / scale)


def test_thermal_electrons_lane_for_lane():
    k, jk = _keys(21)
    temp = 10 ** np.random.default_rng(1).uniform(5, 11, N)
    ph = _photons(2)
    got = te.sample_thermal_electron(k, torch.as_tensor(temp), torch.as_tensor(ph))
    want = je.sample_thermal_electron(jk, jnp.asarray(temp), jnp.asarray(ph))
    _same_vectors(got, want)
    g, gb = te.sample_thermal_gamma_beta(k, torch.as_tensor(temp))
    jg, jgb = je.sample_thermal_gamma_beta(jk, jnp.asarray(temp))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=RTOL)
    beta = np.random.default_rng(3).uniform(0, 0.999, N)
    beta[:50] = 1e-7  # the beta -> 0 branch
    np.testing.assert_allclose(te.sample_electron_cos_theta(k, torch.as_tensor(beta)).numpy(),
                               np.asarray(je.sample_electron_cos_theta(jk, jnp.asarray(beta))),
                               rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(te.sample_electron_theta(k, torch.as_tensor(beta)).numpy(),
                               np.asarray(je.sample_electron_theta(jk, jnp.asarray(beta))),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("dist", ["powerlaw", "broken"])
def test_nonthermal_electrons_lane_for_lane(dist):
    from test_torch_geometry_cases import NT_DISTS

    jcfg = dataclasses.replace(Config(tau_calculation=TauCalculation.TABLE), n_gamma=10,
                               **NT_DISTS[dist])
    cfg = convert.config_from_reference(jcfg)
    k, jk = _keys(31)
    sub = np.random.default_rng(4).integers(1, cfg.n_gamma + 1, N).astype(np.int32)
    ph = _photons(5)
    got = te.sample_nonthermal_electron(k, torch.as_tensor(sub), torch.as_tensor(ph), cfg)
    want = je.sample_nonthermal_electron(jk, jnp.asarray(sub), jnp.asarray(ph), jcfg)
    _same_vectors(got, want)
    # each lane's gamma lies in its subgroup
    dg = (np.log10(cfg.gamma_max) - np.log10(cfg.gamma_min)) / cfg.n_gamma
    lg = np.log10(got[:, 0].numpy())
    lo = np.log10(cfg.gamma_min) + (sub - 1) * dg
    assert ((lg >= lo - 1e-9) & (lg <= lo + dg + 1e-9)).all()
    # the full-range samplers
    if dist == "powerlaw":
        t = te.sample_power_law(k, (N,), torch.float64, 2.5, 1.0, 100.0)
        j = je.sample_power_law(jk, (N,), jnp.float64, 2.5, 1.0, 100.0)
    else:
        t = te.sample_broken_power_law(k, (N,), torch.float64, 1.5, 3.0, 1.0, 1000.0, 10.0)
        j = je.sample_broken_power_law(jk, (N,), jnp.float64, 1.5, 3.0, 1.0, 1000.0, 10.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)


@pytest.mark.parametrize("stokes_on", [True, False], ids=["stokes", "no_stokes"])
def test_single_scatter_lane_for_lane(stokes_on):
    k, jk = _keys(41)
    ph = _photons(6)
    temp = np.full(N, 1e9)
    el = te.sample_thermal_electron(k.fold_in(9), torch.as_tensor(temp),
                                    torch.as_tensor(ph)).numpy()
    rs = np.random.default_rng(7)
    s = np.zeros((N, 4))
    s[:, 0] = 1.0
    s[:, 1:3] = rs.uniform(-0.5, 0.5, (N, 2))
    s[:100, 1:3] = 0.0  # unpolarized lanes: uniform azimuth
    got = tc.single_scatter(k, torch.as_tensor(el), torch.as_tensor(ph), torch.as_tensor(s),
                            stokes_on=stokes_on)
    want = jc.single_scatter(jk, jnp.asarray(el), jnp.asarray(ph), jnp.asarray(s),
                             stokes_on=stokes_on)
    np.testing.assert_array_equal(got.scattered.numpy(), np.asarray(want.scattered))
    assert 0.2 < got.scattered.numpy().mean() < 1.0
    _same_vectors(got.ph_p, want.ph_p)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=0, atol=RTOL)
    # the angle sampler alone, in its (theta, phi) form
    e0 = torch.as_tensor(ph[:, 0])
    q, u = torch.as_tensor(s[:, 1]), torch.as_tensor(s[:, 2])
    got = tc.sample_kn_angles(k, e0, q, u, stokes_on)
    want = jc.sample_kn_angles(jk, jnp.asarray(ph[:, 0]), jnp.asarray(s[:, 1]),
                               jnp.asarray(s[:, 2]), stokes_on)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_electrons.py's checks on the port


@pytest.mark.parametrize("temp", [1e5, 1e7, 1e9, 1e10, 1e11],
                         ids=["nonrel", "threshold", "trans-rel", "relativistic", "ultra-rel"])
def test_maxwell_juttner_moments(temp):
    theta = KB_OVER_MEC2 * temp
    n = 100_000
    gamma, gb = te.sample_thermal_gamma_beta(prng.Key.from_seed(42),
                                             torch.full((n,), temp, dtype=torch.float64))
    xi = ((gamma - 1.0) / theta).numpy()
    m1, m2 = mj_moments(theta)
    se1 = np.sqrt(max(m2 - m1 * m1, 1e-30) / n)
    assert abs(xi.mean() - m1) < 5.0 * se1 + 1e-3 * m1, (temp, xi.mean(), m1)
    np.testing.assert_allclose(gb.numpy() ** 2, gamma.numpy() ** 2 - 1.0, rtol=1e-10,
                               atol=1e-12)
    if temp <= 1e5:
        assert abs(xi.mean() - 1.5) < 0.02


def test_mixed_temperature_batch():
    temps = np.logspace(5, 11, 120_000)
    gamma, _ = te.sample_thermal_gamma_beta(prng.Key.from_seed(7), torch.as_tensor(temps))
    gamma = gamma.numpy()
    assert np.all(np.isfinite(gamma)) and np.all(gamma >= 1.0)
    hot = temps > 1e10
    xi_hot = (gamma[hot] - 1.0) / (KB_OVER_MEC2 * temps[hot])
    assert 2.7 < xi_hot.mean() < 3.3, xi_hot.mean()


def test_electron_relative_angle_law():
    c = te.sample_electron_cos_theta(prng.Key.from_seed(3),
                                     torch.full((400_000,), 0.9, dtype=torch.float64)).numpy()
    grid = np.linspace(-0.999, 0.999, 21)
    emp = np.searchsorted(np.sort(c), grid) / len(c)
    ana = ((1.0 - 0.9 * grid) ** 2 - (1.0 + 0.9) ** 2) / (-4.0 * 0.9)
    np.testing.assert_allclose(emp, ana, atol=5e-3)


def test_nonthermal_dist_enum_reaches_the_sampler():
    """A broken power law takes the broken branch (its CDF has a kink at
    gamma_break), not the power law's."""
    cfg = convert.config_from_reference(Config(
        tau_calculation=TauCalculation.TABLE, nonthermal_e_dist=NonthermalDist.BROKENPOWERLAW,
        powerlaw_index_1=1.5, powerlaw_index_2=3.0, gamma_break=10.0, gamma_min=1.0,
        gamma_max=1000.0))
    g = te.sample_nonthermal_gamma_range(prng.Key.from_seed(1),
                                         torch.full((200_000,), 1.0, dtype=torch.float64),
                                         torch.full((200_000,), 1000.0, dtype=torch.float64), cfg)
    below = (g <= 10.0).double().mean().item()
    want = float(te.broken_power_law_cdf(np.array(10.0), 1.5, 3.0, 1.0, 1000.0, 10.0))
    assert abs(below - want) < 5 * np.sqrt(want * (1 - want) / 200_000)
