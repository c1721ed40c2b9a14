"""The roofline count against a hand-worked case."""
import pytest

from benchmark import roofline, spec


def test_least_time_by_hand():
    # 1,000 photons, 500 scatterings, 100 cells of the ultra table, Stokes on
    n, s, cells = 1000, 500, 100
    rounds = n + s  # 1,500
    nbytes = n * 2 * 64 + cells * 4 * 4  # 129,600
    # FP32: per round 41 + 37 + 8 + 12 = 98; per scattering
    # 167 + 22 + 434 + 16 + 23 = 662
    ops = rounds * 98 + s * 662
    # math calls, each at its instructions in place of one operation
    # (sincos two): per round sqrt 2+1+1+1 = 5, div 3+2+2 = 7, log 1, rsqrt 1;
    # per scattering div 8+2+15+2+3 = 30, sqrt 8+1+10 = 19, rsqrt 4+1+7 = 12,
    # sincos 1, cos 1, log 2
    sqrt, div, log, rsqrt = 5 * rounds + 19 * s, 7 * rounds + 30 * s, rounds + 2 * s, \
        rounds + 12 * s
    ops += sqrt * 5 + div * 9 + log * 26 + rsqrt * 1 + s * 31 + s * 19
    sfu = sqrt + div + rsqrt
    uniforms = rounds * 1 + s * (3 + 3 + 2 + 2)
    want = dict(bytes=nbytes / 3.35e12, fp32=ops / 67e12,
                int32=uniforms * 12 / (64 * 132 * 1.98e9), sfu=sfu / (16 * 132 * 1.98e9))
    got, pipe = roofline.least_time(roofline.frame_units(n, s, True),
                                    roofline.frame_bytes(n, cells, 4), roofline.OPS_GEO_CYL2,
                                    roofline.CALLS_GEO_CYL2)
    assert pipe == max(want, key=want.get)
    assert got == pytest.approx(want[pipe], rel=1e-12)


def test_units_and_the_configurations_counts():
    units = roofline.frame_units(10, 4, stokes=False)
    assert units["lane_round"] == 14 and units["scatter"] == 4 and units["phi_trial"] == 4
    _, cyl2 = spec.config("cyl2_jet")
    data, amr = spec.config("amr_jet")
    assert (cyl2.ROWS_PER_CELL, amr.ROWS_PER_CELL) == (4, 9)
    assert amr.least_time(data, 1000, 500, 100) == roofline.least_time(
        roofline.frame_units(1000, 500, True), roofline.frame_bytes(1000, 100, 9),
        roofline.OPS_GEO_CYL2, roofline.CALLS_GEO_CYL2)
    # more scatterings never lower the least time; at a few a photon the
    # work, not the bytes, binds
    few = amr.least_time(data, 10**6, 0, 400)
    many = amr.least_time(data, 10**6, 8 * 10**6, 400)
    assert few[1] == "bytes" and many[1] != "bytes" and many[0] > few[0]
