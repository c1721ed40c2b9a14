"""The port's analysis (a numpy copy of mcrat_tpu.analysis) against JAX's:
all six reductions on the same seeded merged-frame dicts, exactly; and the
same reductions of a frame read back from either dump format."""
import numpy as np
import pytest

from mcrat_tpu import analysis as jan
from mcrat_tpu_torch import analysis as tan
from mcrat_tpu_torch import convert
from mcrat_tpu_torch.io import photons_h5 as tph


def _frame(seed, n=4000):
    """A merged-frame dict: photons at polar angles 0-0.3 rad, 1 keV-1 MeV
    lab energies (E/c cgs), positions ~1e13 cm, Stokes, scatterings, some
    zero weights and energies."""
    rs = np.random.default_rng(seed)
    theta = rs.uniform(0.0, 0.3, n)
    phi = rs.uniform(0.0, 2 * np.pi, n)
    p0 = 10.0 ** rs.uniform(0.0, 3.0, n) / tan.ERG_TO_KEV / tan.C_LIGHT
    p0[::97] = 0.0
    w = rs.uniform(0.5, 2.0, n) * 1e50
    w[::53] = 0.0
    r = rs.uniform(0.8e13, 1.2e13, n)
    return {
        "P0": p0, "P1": p0 * np.sin(theta) * np.cos(phi), "P2": p0 * np.sin(theta) * np.sin(phi),
        "P3": p0 * np.cos(theta), "R0": r * np.sin(theta) * np.cos(phi),
        "R1": r * np.sin(theta) * np.sin(phi), "R2": r * np.cos(theta),
        "PW": w, "S0": np.ones(n), "S1": rs.uniform(-0.3, 0.4, n), "S2": rs.uniform(-0.2, 0.2, n),
        "S3": np.zeros(n), "NS": rs.integers(0, 40, n).astype(float),
    }


BAND = (0.02, 0.2)
CALLS = {
    "spectrum": lambda m: m.spectrum(_frame(1), *BAND),
    "peak_energy_kev": lambda m: m.peak_energy_kev(_frame(2), *BAND),
    "polarization": lambda m: m.polarization(_frame(3), *BAND),
    "light_curve": lambda m: m.light_curve({fr: _frame(10 + fr) for fr in range(4)}, 5.0, *BAND),
    "light_curve_toa": lambda m: m.light_curve_toa(_frame(4), 12, 5.0, *BAND),
    "scatterings_histogram": lambda m: m.scatterings_histogram(_frame(5)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_identical_to_jax(name):
    got, want = CALLS[name](tan), CALLS[name](jan)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reads_either_dump_format(tmp_path):
    """A frame written by both writers and merged reads back into the same
    polarization and spectrum."""
    from mcrat_tpu.config import Config

    cfg = convert.config_from_reference(Config())
    rs = np.random.default_rng(6)
    n = 500
    photons = dict(p=np.abs(rs.normal(size=(n, 4))) + 1.0, comv_p=np.ones((n, 4)),
                   pos=rs.normal(size=(n, 3)) * 1e12,
                   s=np.concatenate([np.ones((n, 1)), rs.uniform(-0.5, 0.5, (n, 3))], axis=1),
                   weight=np.ones(n), num_scatt=np.zeros(n), cell=np.zeros(n, np.int32),
                   ptype=np.zeros(n, np.int32))

    class Meta:
        weight_norm = 1e50

    out = {}
    for fmt in tph.FORMATS:
        d = tmp_path / fmt
        d.mkdir()
        tph.write_frame(cfg, tph.proc_path(str(d), 0, fmt), 3, photons, Meta)
        tph.merge_frame(str(d), 3)
        data = tph.read_frame(str(d / f"mcdata_3.{fmt}"))
        out[fmt] = (tan.polarization(data, 0.0, np.pi), tan.spectrum(data, 0.0, np.pi)[1])
    assert out["h5"][0] == out["npz"][0]
    np.testing.assert_array_equal(out["h5"][1], out["npz"][1])
