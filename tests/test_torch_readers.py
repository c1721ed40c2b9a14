"""The port's hydro readers against the JAX package's, on files written as
tests/test_io.py writes them, on the CPU.

* PLUTO ``.dbl`` (tests/test_io.py's ``pluto_dir``) and ``.h5`` (the same
  fields as ``/Timestep_0/vars/<name>``), PLUTO-Chombo (``chombo_file``: two
  AMR levels, the covered coarse cells masked), RIKEN 2-D and 3-D (the
  Fortran records of ``_write_riken_var``): every ``HydroFrameHost`` array
  equal to JAX's, in injection and in scattering mode (the same numpy
  arithmetic, so bit for bit).
* ``io.hydro.frame_filename`` and ``get_hydro_data``'s PLUTO, PLUTO-Chombo
  and RIKEN branches, with the analytic overwrite and nonthermal densities.
* A RIKEN 3-D frame's jet axis is the host frame's ``jet_axis`` field.
* ``cli run --sim pluto`` and ``--sim riken --device cpu`` on frame sets
  that chip_smoke.py writes (its writers, at a small size), through the
  kernel's twin; the HDF5 formats raise ImportError naming h5py before
  anything is written where h5py is missing.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from mcrat_tpu.config import Config, Dims, Geometry, HydroSim, NonthermalDist, PlutoFileType
from mcrat_tpu.config import SimType, TauCalculation
from mcrat_tpu.io import hydro as jhydro
from mcrat_tpu.io import pluto as jpluto
from mcrat_tpu.io import pluto_chombo as jchombo
from mcrat_tpu.io import riken as jriken
from mcrat_tpu_torch import cli
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import driver as tdriver
from mcrat_tpu_torch.io import hydro as thydro
from mcrat_tpu_torch.io import pluto as tpluto
from mcrat_tpu_torch.io import pluto_chombo as tchombo
from mcrat_tpu_torch.io import riken as triken
from mcrat_tpu_torch.io import photons_h5 as tph
from mcrat_tpu_torch.ops import fused_round as fr

import chip_smoke
from test_io import _write_riken_var, chombo_file, pluto_dir  # noqa: F401
from test_torch_amr_flash import FIELDS

torch.set_num_threads(1)

MODES = dict(injection=dict(fps=5.0, r_inj=1e10, ph_inj_switch=True),
             scattering=dict(fps=5.0, r_inj=0.0, ph_inj_switch=False, min_r=1.2e11,
                             max_r=4e11, min_theta=0.1, max_theta=0.9))


def _same(thost, jhost):
    assert thost.num_elements == jhost.num_elements > 0
    for name in FIELDS + ("nonthermal_dens",):
        want = getattr(jhost, name)
        if want is None:
            assert getattr(thost, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(thost, name), np.asarray(want), err_msg=name)


def _pluto_cfg(**kw):
    return Config(sim_switch=HydroSim.PLUTO, dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                  dtype="float64", **kw)


@pytest.mark.parametrize("mode", MODES)
def test_pluto_dbl_matches_jax(pluto_dir, mode):  # noqa: F811
    tmp_path, _, _ = pluto_dir
    cfg = _pluto_cfg()
    path = str(tmp_path / "data.0031.dbl")
    jhost = jpluto.read_pluto(cfg, path, **MODES[mode])
    _same(tpluto.read_pluto(convert.config_from_reference(cfg), path, **MODES[mode]), jhost)
    n = len(jpluto.read_dbl_out(str(tmp_path / "dbl.out"))) * 32 * 16
    np.testing.assert_array_equal(tpluto.read_dbl(path, n), np.fromfile(path))
    with pytest.raises(IOError, match="expected"):
        tpluto.read_dbl(path, n + 1)


def test_pluto_h5_matches_jax(pluto_dir):  # noqa: F811
    import h5py

    tmp_path, _, fields = pluto_dir
    path = str(tmp_path / "data.0031.dbl.h5")
    with h5py.File(path, "w") as f:
        grp = f.create_group("Timestep_0").create_group("vars")
        for name, val in zip(("rho", "vx1", "vx2", "prs"), fields):
            grp[name] = val
    cfg = _pluto_cfg(pluto_filetype=PlutoFileType.DBL_H5)
    for kw in MODES.values():
        _same(tpluto.read_pluto(convert.config_from_reference(cfg), path, **kw),
              jpluto.read_pluto(cfg, path, **kw))


def test_chombo_matches_jax(chombo_file):  # noqa: F811
    cfg = Config(sim_switch=HydroSim.PLUTO_CHOMBO, dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 dtype="float64")
    kw = dict(fps=5.0, r_inj=0.1, ph_inj_switch=True)
    thost = tchombo.read_pluto_chombo(convert.config_from_reference(cfg), chombo_file, **kw)
    _same(thost, jchombo.read_pluto_chombo(cfg, chombo_file, **kw))
    assert thost.num_elements == 112  # 48 coarse cells left uncovered + 64 fine
    index = thydro.build_index(convert.config_from_reference(cfg), thost, device="cpu")
    assert index.max_slab == int(index.bin_count.max())  # uncapped (F8 repaired)


def _riken_2d(tmp_path, frame=37):
    """tests/test_io.py::test_riken_2d_reader's files."""
    nr, nt, r_lo, t_lo = 5, 3, 2, 1
    r_all = 1e10 * (1.0 + 0.1 * np.arange(12))
    np.savetxt(tmp_path / "grid-x1.data", r_all[None], delimiter=", ")
    np.savetxt(tmp_path / "grid-x2.data", np.linspace(0.1, 0.6, 8)[None], delimiter=", ")
    rng = np.random.default_rng(11)
    idx = [1, 1, t_lo + 1, t_lo + nt, r_lo + 1, r_lo + nr]
    for var, lo, hi in ((1, 1e-9, 1e-7), (2, 0.1, 0.8), (3, -0.05, 0.05), (8, 1e2, 1e4)):
        _write_riken_var(tmp_path / f"u0{var}-{frame:04d}small.data", idx,
                         rng.uniform(lo, hi, nt * nr))
    return r_all[r_lo]


def _riken_3d(tmp_path, frame=1500):
    """tests/test_io.py::test_riken_3d_reader's files."""
    nr, nt, nphi, r_lo = 6, 3, 2, 1
    r_all = 1e10 * (1.0 + 0.05 * np.arange(10))
    np.savetxt(tmp_path / "grid01-x1.data", r_all[None], delimiter=", ")
    np.savetxt(tmp_path / "grid-x2.data", np.linspace(0.3, 0.5, nt)[None], delimiter=", ")
    np.savetxt(tmp_path / "grid-x3.data", np.array([0.25, 1.75])[None], delimiter=", ")
    idx = [1, nphi, 1, nt, r_lo + 1, r_lo + nr]
    rng = np.random.default_rng(7)
    n = nphi * nt * nr
    for var, lo, hi in ((1, 1e-9, 1e-7), (2, 0.1, 0.9), (3, -0.05, 0.05), (4, -0.05, 0.05),
                        (8, 1e2, 1e4)):
        _write_riken_var(tmp_path / f"u0{var}-{frame:05d}small.data", idx, rng.uniform(lo, hi, n))
    return r_all[3]


def test_riken_2d_matches_jax(tmp_path):
    r_inj = _riken_2d(tmp_path)
    cfg = Config(sim_switch=HydroSim.RIKEN, dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 dtype="float64")
    prefix = str(tmp_path) + "/"
    for kw in (dict(fps=1.0, r_inj=r_inj, ph_inj_switch=True),
               dict(fps=1.0, r_inj=0.0, ph_inj_switch=False, min_r=1.2e10, max_r=1.5e10,
                    min_theta=0.2, max_theta=0.5)):
        _same(triken.read_riken_2d(convert.config_from_reference(cfg), prefix, 37, **kw),
              jriken.read_riken_2d(cfg, prefix, 37, **kw))


def test_riken_3d_matches_jax_and_sets_the_jet_axis(tmp_path):
    r_inj = _riken_3d(tmp_path)
    cfg = Config(sim_switch=HydroSim.RIKEN, dims=Dims.THREE, geometry=Geometry.SPHERICAL,
                 dtype="float64")
    prefix = str(tmp_path) + "/"
    jhost = jriken.read_riken_3d(cfg, prefix, 1500, fps=5.0, r_inj=r_inj, ph_inj_switch=True)
    thost = triken.read_riken_3d(convert.config_from_reference(cfg), prefix, 1500, fps=5.0,
                                 r_inj=r_inj, ph_inj_switch=True)
    _same(thost, jhost)
    assert thost.jet_axis == "y" and "jet_axis" in {f.name for f in dataclasses.fields(thost)}
    z = triken.read_riken_3d(convert.config_from_reference(cfg), prefix, 1500, fps=5.0,
                             r_inj=r_inj, ph_inj_switch=True, jet_axis="z")
    assert z.jet_axis == "z" and not np.array_equal(z.theta, thost.theta)
    np.testing.assert_array_equal(triken.riken_radial_edges(), jriken.riken_radial_edges())
    for frame in (0, 1300, 1301, 2000, 2001, 60000):
        assert triken.riken_radial_segment(frame) == jriken.riken_radial_segment(frame)
        assert triken.riken_frame_schedule(frame, 5.0) == jriken.riken_frame_schedule(frame, 5.0)
    assert (triken.riken_frame_prefix("p/", 2, 37), triken.riken_frame_prefix_3d("p/", 2, 37)) == (
        jriken.riken_frame_prefix("p/", 2, 37), jriken.riken_frame_prefix_3d("p/", 2, 37))


@pytest.mark.parametrize("sim", ["pluto", "pluto_h5", "pluto_chombo", "riken2", "riken3"])
def test_get_hydro_data_branches_match_jax(tmp_path, pluto_dir, chombo_file, sim):  # noqa: F811
    """The driver's frame load of each format: file name, reader, the
    analytic overwrite and the nonthermal densities."""
    nt = dict(nonthermal_e_dist=NonthermalDist.POWERLAW, gamma_min=1.0, gamma_max=100.0,
              powerlaw_index=2.5, tau_calculation=TauCalculation.TABLE)
    args = (5.0, 1e10, True)
    if sim.startswith("pluto") and sim != "pluto_chombo":
        pdir, _, fields = pluto_dir
        kw = dict(sim_switch=HydroSim.PLUTO, dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                  simulation_type=SimType.SPHERICAL_OUTFLOW)
        if sim == "pluto_h5":
            import h5py

            kw["pluto_filetype"] = PlutoFileType.DBL_H5
            with h5py.File(pdir / "data.0031.dbl.h5", "w") as f:
                grp = f.create_group("Timestep_0").create_group("vars")
                for name, val in zip(("rho", "vx1", "vx2", "prs"), fields):
                    grp[name] = val
        paths, frame = dict(filepath=str(pdir) + "/", fileroot="data."), 31
    elif sim == "pluto_chombo":
        kw = dict(sim_switch=HydroSim.PLUTO_CHOMBO, dims=Dims.TWO, geometry=Geometry.SPHERICAL)
        d, name = os.path.split(chombo_file)
        paths, frame, args = dict(filepath=d + "/", fileroot=name[:-9]), 5, (5.0, 0.1, True)
    elif sim == "riken2":
        r_inj = _riken_2d(tmp_path)
        kw = dict(sim_switch=HydroSim.RIKEN, dims=Dims.TWO, geometry=Geometry.SPHERICAL, **nt)
        paths, frame, args = dict(filepath=str(tmp_path) + "/"), 37, (1.0, r_inj, True)
    else:
        r_inj = _riken_3d(tmp_path)
        kw = dict(sim_switch=HydroSim.RIKEN, dims=Dims.THREE, geometry=Geometry.SPHERICAL)
        paths, frame, args = dict(filepath=str(tmp_path) + "/"), 1500, (5.0, r_inj, True)
    cfg = Config(**kw)
    tcfg = convert.config_from_reference(cfg)
    jpaths, tpaths = jhydro.HydroPaths(**paths), thydro.HydroPaths(**paths)
    assert thydro.frame_filename(tcfg, tpaths, frame) == jhydro.frame_filename(cfg, jpaths, frame)
    _same(thydro.get_hydro_data(tcfg, tpaths, frame, *args),
          jhydro.get_hydro_data(cfg, jpaths, frame, *args))


def _small_mcpar(path, r_inj, fps):
    from mcrat_tpu_torch import McPar, Spectrum, write_mcpar

    write_mcpar(McPar(fps=fps, last_frame=1, r0_domain=(0.0, 0.0), r1_domain=(0.0, 0.0),
                      r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0,
                      n_theta_bins=1, frm0=(0,), frm2=(0,), inj_radius=(r_inj,),
                      spect=Spectrum.BLACKBODY, min_photons=300, max_photons=900,
                      restart="i"), path)
    return path


@pytest.mark.parametrize("sim", ["pluto", "riken"])
def test_cli_run_reader_frames(tmp_path, sim):
    """chip_smoke's frame sets at a small size (the flagship outflow on a 16
    x 64 grid as PLUTO .dbl files, the 2-D spherical outflow on 48 x 8 as
    RIKEN files) through ``cli run --device cpu``: the twin transports the
    readers' cell lists (a BinnedIndex) over frames 0 and 1."""
    from mcrat_tpu_torch import Config as TConfig, Dims as TDims, Geometry as TGeometry
    from mcrat_tpu_torch import HydroSim as THydroSim, SimType as TSimType
    from mcrat_tpu_torch.grid import frame_from_numpy
    from mcrat_tpu_torch.models import analytic as tan

    run_dir = str(tmp_path / sim)
    if sim == "pluto":
        cfg = TConfig(sim_switch=THydroSim.PLUTO, dims=TDims.TWO,
                      geometry=TGeometry.CYLINDRICAL, simulation_type=TSimType.CYLINDRICAL_OUTFLOW)
        edges = (np.linspace(0.0, 3.2e11, 17), np.linspace(1.8e12, 2.9e12, 65))
        host = frame_from_numpy(cfg, tan.make_grid_2d(cfg, *edges))
        tan.apply_simulation_type(host)
        chip_smoke.write_pluto_frames(run_dir, host, edges, (0, 1), cfg.hydro_p_scale)
        mcpar = _small_mcpar(os.path.join(run_dir, "mc.par"), 2e12, 5.0)
        extra = ["--geometry", "cylindrical", "--fileroot", "data."]
    else:
        cfg = TConfig(sim_switch=THydroSim.RIKEN, dims=TDims.TWO, geometry=TGeometry.SPHERICAL,
                      simulation_type=TSimType.SPHERICAL_OUTFLOW)
        host, edges = tan.synthetic_spherical_frame(cfg, r_min=1e12, r_max=9e13, nr=48,
                                                    ntheta=8, theta_max=0.31416)
        chip_smoke.write_riken_2d_frames(run_dir, host, edges, (0, 1), cfg.hydro_p_scale)
        mcpar = _small_mcpar(os.path.join(run_dir, "mc.par"), 8e12, 1.0)
        extra = ["--geometry", "spherical"]
    # the files hold the host frame, field for field
    read = thydro.get_hydro_data(cfg, thydro.HydroPaths(filepath=run_dir + "/",
                                                        fileroot="data."), 0, 1.0, 0.0, False)
    order = np.lexsort((read.r1, read.r0))
    want = np.lexsort((host.r1, host.r0))
    tol = dict(rtol=1e-15) if sim == "pluto" else dict(rtol=6e-8)  # RIKEN data: float32
    np.testing.assert_allclose(read.r0[order], host.r0[want], rtol=1e-12)
    for name in ("dens", "v0", "v1", "temp"):
        np.testing.assert_allclose(getattr(read, name)[order], getattr(host, name)[want], **tol)
    twin = fr.fused_rounds_reference.launches
    rc = cli.main(["run", "--mcpar", mcpar, "--filepath", run_dir + "/", "--sim", sim,
                   "--dims", "2", *extra, "--device", "cpu", "--output", "npz", "--merge"])
    assert rc == 0 and fr.fused_rounds_reference.launches > twin
    for frame in (0, 1):
        data = tph.read_frame(os.path.join(run_dir, "MC", "0-6", f"mcdata_{frame}.npz"))
        assert 300 <= len(data["PW"]) <= 900 and (data["PW"] > 0).all()
        assert np.isfinite(data["P0"]).all() and (data["NS"] > 0).any()


@pytest.mark.parametrize("sim,filetype", [("pluto_chombo", "dbl"), ("pluto", "dbl.h5"),
                                          ("flash", "dbl")])
def test_hdf5_formats_need_h5py_before_writing(tmp_path, monkeypatch, sim, filetype):
    from mcrat_tpu_torch import Config as TConfig, HydroSim as THydroSim
    from mcrat_tpu_torch.config import PlutoFileType as TPlutoFileType

    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg = TConfig(sim_switch=THydroSim(sim), pluto_filetype=TPlutoFileType(filetype))
    par = convert.mcpar_from_reference(__import__("test_driver")._par())
    paths = thydro.HydroPaths(filepath=str(tmp_path) + "/")
    with pytest.raises(ImportError, match="needs h5py"):
        tdriver.run_rank(cfg, par, paths, device="cpu", output="npz")
    assert not os.listdir(tmp_path)
