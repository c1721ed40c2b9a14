"""The port's Stokes chain (``mcrat_tpu_torch.ops.stokes``) against
``mcrat_tpu.ops.stokes`` in float64, and the polarization physics checks of
tests/test_polarization.py on the port's ``single_scatter``.

* Each function on the same random inputs (made from a seed with numpy):
  rtol 1e-12, with an absolute floor of 1e-14 for components that cancel to
  ~0 (the two libraries' sqrt, rsqrt and trig may differ in the last place).
  A basis rotation's sin 2theta = 2 d sqrt(1 - d^2) turns a last-place
  difference in d into one 1 / sqrt(1 - d^2) times larger, so the rotated
  lanes' floor is scaled by that factor, computed from the inputs.
* The four physics checks of tests/test_polarization.py, with its
  tolerances, on the port's scatter with its own threefry keys: the De Paola
  azimuthal modulation and the Thomson polarization degree at half its
  400,000 photons (the De Paola bound scales with the counts; a Thomson
  bin's standard error of Q stays ~0.005 against the 0.03 allowed), the
  Krawczynski inverse-Compton beam and the near-forward round trip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu.constants import H_OVER_MEC2
from mcrat_tpu.ops import stokes as js
from mcrat_tpu_torch.ops import compton as tc
from mcrat_tpu_torch.ops import prng
from mcrat_tpu_torch.ops import stokes as ts

N = 4000
RTOL, ATOL = 1e-12, 1e-14


def _vecs(seed, n=N):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(n, 3))


def _stokes(seed, n=N):
    rs = np.random.default_rng(seed)
    s = np.zeros((n, 4))
    s[:, 0] = 1.0
    s[:, 1:] = rs.uniform(-0.5, 0.5, (n, 3))
    return s


def _same(got, want, cond=None):
    got, want = got.numpy(), np.asarray(want)
    if cond is None:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    bound = RTOL * np.abs(want) + ATOL * (1.0 + cond[:, None])
    assert (np.abs(got - want) <= bound).all(), np.max(np.abs(got - want) / bound)


def _cond(v_old, ref_old, v_new, ref_new):
    """1 / sqrt(1 - d^2) of the rotation between the two bases."""
    a, b = np.cross(ref_old, v_old), np.cross(ref_new, v_new)
    d = (a * b).sum(1) / np.sqrt((a * a).sum(1) * (b * b).sum(1))
    return 1.0 / np.sqrt(np.maximum(1.0 - d * d, 1e-32))


def T(a):
    return torch.as_tensor(a, dtype=torch.float64)


def J(a):
    return jnp.asarray(a, dtype=jnp.float64)


def test_find_xy_and_find_phi():
    v, ref, v2, ref2 = (_vecs(s) for s in (1, 2, 3, 4))
    tx, ty = ts.find_xy(T(v), T(ref))
    jx, jy = js.find_xy(J(v), J(ref))
    _same(tx, jx)
    _same(ty, jy)
    tx2, ty2 = ts.find_xy(T(v2), T(ref2))
    jx2, jy2 = js.find_xy(J(v2), J(ref2))
    _same(ts.find_phi(tx, ty, tx2, ty2), js.find_phi(jx, jy, jx2, jy2))
    # degenerate basis: v parallel to ref gives zero vectors, as JAX's
    tx0, ty0 = ts.find_xy(T(v), T(2.0 * v))
    assert not tx0.any() and not ty0.any()


def test_mueller_rotations():
    s = _stokes(5)
    theta = np.random.default_rng(6).uniform(-np.pi, np.pi, N)
    _same(ts.mueller_rotate(T(theta), T(s)), js.mueller_rotate(J(theta), J(s)))
    c2, s2 = np.cos(2 * theta), np.sin(2 * theta)
    _same(ts.mueller_rotate_cs(T(c2), T(s2), T(s)), js.mueller_rotate_cs(J(c2), J(s2), J(s)))


def test_rotate_basis_forms_and_stokes_rotation():
    v, ref, v2, ref2 = (_vecs(s) for s in (7, 8, 9, 10))
    s = _stokes(11)
    cond = _cond(v, ref, v2, ref2)
    _same(ts.rotate_basis_vectors(T(v), T(ref), T(v2), T(ref2), T(s)),
          js.rotate_basis_vectors(J(v), J(ref), J(v2), J(ref2), J(s)), cond)
    tb = [*ts.find_xy(T(v), T(ref)), *ts.find_xy(T(v2), T(ref2))]
    jb = [*js.find_xy(J(v), J(ref)), *js.find_xy(J(v2), J(ref2))]
    _same(ts.rotate_basis(*tb, T(s)), js.rotate_basis(*jb, J(s)), cond)
    # the collapsed form equals the basis form (JAX's identity)
    np.testing.assert_allclose(ts.rotate_basis_vectors(T(v), T(ref), T(v2), T(ref2), T(s)),
                               ts.rotate_basis(*tb, T(s)), rtol=1e-10, atol=1e-12)
    boost = 0.9 * _vecs(12) / np.linalg.norm(_vecs(12), axis=1, keepdims=True)
    vb = _vecs(13)
    z = np.broadcast_to([0.0, 0.0, 1.0], v.shape)
    cond = _cond(v, z, v, boost) + _cond(vb, boost, vb, z)
    _same(ts.stokes_rotation(T(boost), T(v), T(vb), T(s)),
          js.stokes_rotation(J(boost), J(v), J(vb), J(s)), cond)
    # a zero boost (v = 0 cells) is the identity
    zero = np.zeros_like(boost)
    np.testing.assert_array_equal(ts.stokes_rotation(T(zero), T(v), T(v), T(s)).numpy(), s)


def test_fano_scatter_stokes():
    rs = np.random.default_rng(14)
    s = _stokes(15)
    e0 = 10 ** rs.uniform(-4, 1, N)
    ct = rs.uniform(-1, 1, N)
    e1 = e0 / (1 + e0 * (1 - ct))
    _same(ts.fano_scatter_stokes(T(s), T(e0), T(e1), T(ct)),
          js.fano_scatter_stokes(J(s), J(e0), J(e1), J(ct)))


def test_fano_normalization_holds_a_zero_intensity():
    """F13: where the scattered intensity rounds to 0 in float32 (a fully
    polarized photon scattered near 90 degrees in its plane) the Stokes
    vector stays finite, of degree at most 1; elsewhere the float64 quotient
    rounds once, within an ulp of the float32 division."""
    f32 = torch.float32
    fi = torch.tensor([0.0, -1e-8, 1e-30, 0.5, 2.0], dtype=f32)
    fq = torch.tensor([-1e-8, 1e-8, 1e-30, 0.25, -1.0], dtype=f32)
    fu = torch.tensor([0.0, 0.0, 0.0, 0.2, 0.5], dtype=f32)
    fv = torch.tensor([0.0, 1e-9, 0.0, 0.1, 0.0], dtype=f32)
    q, u, v = ts.fano_normalized(fi, fq, fu, fv)
    assert q.dtype == u.dtype == v.dtype == f32
    assert torch.isfinite(torch.stack([q, u, v])).all()
    deg = torch.sqrt(q.double() ** 2 + u.double() ** 2 + v.double() ** 2)
    assert (deg <= 1.0 + 1e-6).all()
    # the float32 division's NaN and the ordinary lanes
    inv = 1.0 / fi
    assert torch.isnan(fq[0] * inv[0]) or torch.isinf(fq[0] * inv[0])
    for got, num in ((q, fq), (u, fu), (v, fv)):
        np.testing.assert_allclose(got[3:].numpy(), (num[3:] * inv[3:]).numpy(), rtol=2.4e-7)


# ---------------------------------------------------------------------------
# tests/test_polarization.py's physics checks on the port's single_scatter

NP = 200_000


def _scatter_beam(e0, s0, el_p, n=NP, seed=0):
    ph = torch.tensor([e0, e0, 0.0, 0.0], dtype=torch.float64).expand(n, 4)
    el = torch.as_tensor(el_p, dtype=torch.float64).expand(n, 4)
    s = torch.as_tensor(s0, dtype=torch.float64).expand(n, 4)
    return tc.single_scatter(prng.Key.from_seed(seed), el, ph, s, stokes_on=True)


def test_depaola_azimuthal_modulation():
    e0 = 100.0 / 511.0
    res = _scatter_beam(e0, [1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0])
    k = res.ph_p[:, 1:].numpy()
    kn = k / np.linalg.norm(k, axis=1, keepdims=True)
    sc = res.scattered.numpy()
    cos_t = kn[:, 0]
    sel = sc & (cos_t < np.cos(np.radians(85))) & (cos_t > np.cos(np.radians(90)))
    eta = np.arctan2(kn[sel, 2], kn[sel, 1])
    t = np.arccos(cos_t[sel]).mean()
    ratio = 1.0 / (1.0 + e0 * (1.0 - np.cos(t)))
    grid = np.linspace(-np.pi, np.pi, 25)
    centers = 0.5 * (grid[:-1] + grid[1:])
    w = grid[1] - grid[0]
    cos2_bin = 0.5 + (np.sin(2.0 * grid[1:]) - np.sin(2.0 * grid[:-1])) / (4.0 * w)
    pdf = ratio**2 * (ratio + 1.0 / ratio - 2.0 * np.sin(t) ** 2 * cos2_bin)
    pdf = pdf / pdf.sum()
    hist, _ = np.histogram(eta, bins=grid)
    frac = hist / hist.sum()
    assert (frac[np.abs(centers) < 0.3].mean()
            < 0.6 * frac[np.abs(np.abs(centers) - np.pi / 2) < 0.3].mean())
    np.testing.assert_allclose(frac, pdf,
                               atol=3.5 / np.sqrt(hist.sum() / len(centers)) / len(centers))


def test_thomson_polarization_degree():
    res = _scatter_beam(1e-4, [1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], seed=3)
    k = res.ph_p[:, 1:]
    kn = k / torch.linalg.norm(k, dim=1, keepdim=True)
    z = ts.z_hat_like(kn)
    k0 = torch.zeros_like(kn)
    k0[:, 0] = 1.0
    # the measured Stokes from the z-referenced basis into the k0-k plane
    x_old, y_old = ts.find_xy(kn, z)
    x_new, y_new = ts.find_xy(kn, k0)
    s_plane = ts.mueller_rotate(ts.find_phi(x_old, y_old, x_new, y_new), res.s).numpy()
    cos_t = kn[:, 0].numpy()
    ok = res.scattered.numpy() & (np.abs(cos_t) < 0.95)
    bins = np.linspace(-0.95, 0.95, 12)
    checked = 0
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = ok & (cos_t >= lo) & (cos_t < hi)
        if m.sum() < 2000:
            continue
        ct = cos_t[m].mean()
        expect = (1.0 - ct * ct) / (1.0 + ct * ct)
        assert abs(s_plane[m, 1].mean() - expect) < 0.03, (ct, expect)
        assert abs(s_plane[m, 2].mean()) < 0.03
        checked += 1
    assert checked >= 8


def test_krawczynski_inverse_compton_beam():
    e0 = 1e12 * H_OVER_MEC2
    gamma = 100.0
    beta = np.sqrt(1 - 1 / gamma**2)
    theta = np.radians(85.0)
    el = [gamma, gamma * beta * np.sin(theta), 0.0, gamma * beta * np.cos(theta)]
    res = _scatter_beam(e0, [1.0, 1.0, 0.0, 0.0], el, n=100_000, seed=5)
    sc = res.scattered.numpy()
    e1 = res.ph_p[:, 0].numpy()[sc]
    assert sc.mean() > 0.95
    assert e1.max() <= e0 * gamma**2 * (1 + beta) ** 2 * 1.01
    scale = e0 * gamma**2 * (1.0 - beta * np.sin(theta))
    assert 0.2 * scale < e1.mean() < 5.0 * scale
    s = res.s.numpy()[sc]
    assert np.all(np.abs(s[:, 1:]) <= 1.0 + 1e-9)
    assert np.allclose(s[:, 0], 1.0)
    assert np.all(np.sqrt((s[:, 1:] ** 2).sum(axis=1)) <= 1.0 + 1e-9)


@pytest.mark.parametrize("seed", [9])
def test_stokes_identity_roundtrip(seed):
    res = _scatter_beam(1e-6, [1.0, 0.6, 0.3, 0.0], [1.0, 0.0, 0.0, 0.0], n=50_000, seed=seed)
    k = res.ph_p[:, 1:].numpy()
    kn = k / np.linalg.norm(k, axis=1, keepdims=True)
    fwd = res.scattered.numpy() & (kn[:, 0] > 0.999)
    assert fwd.sum() > 10
    s = res.s.numpy()[fwd]
    np.testing.assert_allclose(s[:, 1], 0.6, atol=0.05)
    np.testing.assert_allclose(s[:, 2], 0.3, atol=0.05)
