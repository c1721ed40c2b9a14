"""The port's persistence against mcrat_tpu's: mc.par, checkpoints, photon
dumps and their merge.

* ``read_mcpar`` of one file gives equal fields in both packages, and
  ``write_mcpar`` round-trips across them.
* Checkpoints cross-load: a file of JAX's ``save_checkpoint`` loads in the
  port with JAX's own arrays, and the reverse, with COMV and Stokes output
  on and off; the port's persistence writer keeps ``comv_p`` whatever
  ``cfg.comv`` says (fault F2 not copied) and the random streams' states
  (F9).  ``scan_checkpoints`` finds JAX's work items, an ``.old``-only rank
  among them.
* For the same photons, the port's HDF5 ``append_photons`` + ``merge_all``
  write JAX's datasets, and the npz writer + merge the same arrays; the
  cross-angle merge agrees in both formats.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import Config, PhotonType
from mcrat_tpu.io import checkpoint as jck
from mcrat_tpu.io import mcpar as jmcpar
from mcrat_tpu.io import photons_h5 as jh5
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import driver as tdriver
from mcrat_tpu_torch.io import checkpoint as tck
from mcrat_tpu_torch.io import mcpar as tmcpar
from mcrat_tpu_torch.io import photons_h5 as tph
from mcrat_tpu_torch.ops import prng

from test_io import MCPAR_TEXT

FIELDS = ("p", "comv_p", "pos", "s", "weight", "num_scatt", "cell", "ptype")


def _arrays(n=200, seed=4, dtype=np.float32):
    """Seeded photon fields with null, pool, zero-weight and COMPTONIZED lanes."""
    rng = np.random.default_rng(seed)
    ptype = rng.choice([int(t) for t in PhotonType], n).astype(np.int32)
    weight = rng.uniform(0.5, 2.0, n)
    weight[::11] = 0.0
    s = np.concatenate([np.ones((n, 1)), rng.uniform(-0.5, 0.5, (n, 3))], axis=1)
    return dict(
        p=(np.abs(rng.normal(size=(n, 4))) + 1.0).astype(dtype),
        comv_p=(np.abs(rng.normal(size=(n, 4))) + 1.0).astype(dtype),
        pos=(rng.normal(size=(n, 3)) * 1e12).astype(dtype),
        s=s.astype(dtype), weight=weight.astype(dtype),
        num_scatt=rng.integers(0, 50, n).astype(dtype),
        cell=rng.integers(-1, 1000, n).astype(np.int32), ptype=ptype,
    )


def _jax_photons(arrays):
    return jt.Photons(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


class _Meta:
    weight_norm = 2.5e40
    n_injected = 200


# ---------------------------------------------------------------------------
# mc.par


def test_read_mcpar_equal_in_both_packages(tmp_path):
    path = tmp_path / "mc.par"
    path.write_text(MCPAR_TEXT)
    jpar, tpar = jmcpar.read_mcpar(str(path)), tmcpar.read_mcpar(str(path))
    assert convert.mcpar_from_reference(jpar) == tpar
    assert tpar.spect.value == jpar.spect.value == "w" and tpar.frm2 == (103, 154)
    # the port writes what both packages read back as the same fields
    tmcpar.write_mcpar(tpar, str(tmp_path / "port.par"))
    assert tmcpar.read_mcpar(str(tmp_path / "port.par")) == tpar
    assert convert.mcpar_from_reference(jmcpar.read_mcpar(str(tmp_path / "port.par"))) == tpar
    jmcpar.write_mcpar(jpar, str(tmp_path / "jax.par"))
    assert (tmp_path / "jax.par").read_text() == (tmp_path / "port.par").read_text()


# ---------------------------------------------------------------------------
# checkpoints


def _state(cls, restart="c"):
    return cls(frame=10, frm2=11, scatt_frame=12, time_now=2.4, restart=restart,
               weight_norm=2.5e40, n_injected=200)


@pytest.mark.parametrize("comv,stokes", [(True, True), (False, True), (False, False)])
def test_jax_checkpoint_loads_in_the_port(tmp_path, comv, stokes):
    """JAX's slim checkpoints (COMV or Stokes off, the planes dropped, F2)
    load in the port with the arrays JAX's own load gives."""
    arrays = _arrays()
    ph = _jax_photons(arrays)
    if not comv:
        ph = ph.replace(comv_p=jnp.zeros((0, 4), ph.p.dtype))
    if not stokes:
        ph = ph.replace(s=jnp.zeros((0, 4), ph.p.dtype))
    jck.save_checkpoint(str(tmp_path), 3, _state(jck.CheckpointState), ph)
    jstate, jph = jck.load_checkpoint(str(tmp_path), 3, dtype="float32")
    tstate, tph_ = tck.load_checkpoint(str(tmp_path), 3, device="cpu")
    assert tstate == _state(tck.CheckpointState)
    assert tstate.generator_state is None and tstate.rng_state is None
    for k in FIELDS:
        got = getattr(tph_, k)
        assert got.dtype == (torch.int32 if k in ("cell", "ptype") else torch.float32), k
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jph, k)), err_msg=k)
    assert (tph_.ptype.numpy() != int(PhotonType.COMPTONIZED)).all()


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint of the port's persistence writer with COMV output off
    keeps comv_p (F2 not copied) and its random streams' states (F9: the
    kernel seeds' generator, the injection generator and the XLA engine's
    threefry key); JAX loads it, comv_p included, and ignores the states."""
    arrays = _arrays()
    cfg = convert.config_from_reference(Config(comv=False, stokes=True))
    sub = convert.photons_from_numpy(arrays, device="cpu")
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(8)
    key = prng.Key.from_seed(9).split()[1]
    st = tck.CheckpointState(frame=10, frm2=11, scatt_frame=12, time_now=2.4, restart="c",
                             weight_norm=_Meta.weight_norm, n_injected=200,
                             **tdriver.stream_states(gen, rng, key))
    writer = tdriver._PersistWriter()
    timing = dict(rank=0, frame=10, scatt_frame=12, n_photons=200, n_scatt=0, n_rounds=0,
                  n_scatt_max=0.0, n_scatt_mean=0.0, r_mean=0.0, transport_s=0.0)
    try:
        writer.submit_frame(cfg, str(tmp_path), 0, st, sub, _Meta, 12,
                            tph.proc_path(str(tmp_path), 0, "npz"), timing)
    finally:
        writer.close()
    # the writer timed its steps into the frame's record
    assert all(timing[k] >= 0.0 for k in ("persist_wait_s", "fetch_s", "checkpoint_s",
                                          "dump_s"))
    with np.load(tmp_path / "mc_chkpt_0.npz") as z:
        assert z["comv_p"].shape == (200, 4) and z["cell"].shape == (0,)
    jstate, jph = jck.load_checkpoint(str(tmp_path), 0, dtype="float32")
    assert (jstate.frame, jstate.scatt_frame, jstate.restart) == (10, 12, "c")
    for k in ("p", "comv_p", "pos", "s", "weight", "num_scatt"):
        np.testing.assert_array_equal(np.asarray(getattr(jph, k)), arrays[k], err_msg=k)
    relabel = np.where(arrays["ptype"] == int(PhotonType.COMPTONIZED),
                       int(PhotonType.UNABSORBED_CS), arrays["ptype"])
    np.testing.assert_array_equal(np.asarray(jph.ptype), relabel)
    assert (np.asarray(jph.cell) == -1).all()
    # the streams come back where they stood
    tstate, _ = tck.read_checkpoint(str(tmp_path), 0)
    again = torch.Generator()
    again.set_state(torch.from_numpy(tstate.generator_state))
    assert torch.equal(torch.randint(0, 1 << 30, (8,), generator=again),
                       torch.randint(0, 1 << 30, (8,), generator=gen))
    rng2 = np.random.default_rng()
    rng2.bit_generator.state = json.loads(tstate.rng_state)
    np.testing.assert_array_equal(rng2.random(4), rng.random(4))
    np.testing.assert_array_equal(tstate.key_state, key.state())
    # the dump honours cfg.comv
    assert not any(k.startswith("COMV") for k in tph.read_frame(
        os.path.join(tmp_path, "mc_proc_0", "12", "0.npz")))


def test_scan_checkpoints_same_work_items(tmp_path):
    """Unfinished ranks (mid-run, an injection marker with frames left, an
    .old-only rank) and finished ones, written by either package."""
    d = str(tmp_path)
    arrays = _arrays(n=16)
    jck.save_checkpoint(d, 0, _state(jck.CheckpointState), _jax_photons(arrays))
    tck.save_checkpoint(d, 1, tck.CheckpointState(frame=11, frm2=11, scatt_frame=11,
                                                  time_now=2.2, restart="i"))
    jck.save_checkpoint(d, 2, jck.CheckpointState(frame=12, frm2=11, scatt_frame=12,
                                                  time_now=2.6, restart="i"))
    tck.save_checkpoint(d, 3, _state(tck.CheckpointState), arrays)
    os.replace(tck.checkpoint_path(d, 3), tck.checkpoint_path(d, 3) + ".old")
    tck.save_checkpoint(d, 4, tck.CheckpointState(frame=10, frm2=11, scatt_frame=14,
                                                  time_now=2.8, restart="c"))
    for last in (13, 14):
        want = jck.scan_checkpoints(d, last)
        got = tck.scan_checkpoints(d, last)
        assert [w.old_rank for w in got] == [w.old_rank for w in want]
        for g, w in zip(got, want):
            assert g.state == tck.CheckpointState(**vars(w.state))
    assert [w.old_rank for w in tck.scan_checkpoints(d, 13)] == [0, 1, 3]
    assert tck.load_checkpoint(d, 9, device="cpu") is None


# ---------------------------------------------------------------------------
# the persistence subset


@pytest.mark.parametrize("n_out", [1024, 96, 300])
def test_compact_live_identical_to_jax(n_out):
    """The live lanes in slot order, pads dead, as JAX's compact_live: the
    subset of every live lane (n_out above the live count) and a cut one;
    fresh tensors, never views of the population."""
    from mcrat_tpu_torch import transport as tt

    arrays = _arrays(n=300)
    want = jt.compact_live(_jax_photons(arrays), n_out)
    ph = convert.photons_from_numpy(arrays, device="cpu")
    got = tt.compact_live(ph, n_out)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    ph.p.add_(1.0)
    ph.weight.zero_()
    np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))
    n_live = int(((arrays["weight"] > 0) & (arrays["ptype"] != int(PhotonType.NULL))).sum())
    assert int(got.alive.sum()) == min(n_out, n_live)
    for n in (0, 1, 1000, 1025, 65536, 65537, 953_112, 2_000_000):
        assert tt._pow2(n) == jt._pow2(n) and tt._pad64k(n) == jt._pad64k(n), n


# ---------------------------------------------------------------------------
# photon dumps and merge


def _write_both(tmp_path, cfg, batches):
    """JAX's h5 dumps, the port's h5 dumps and the port's npz dumps of the
    same batches (rank, frame, arrays) into three angle trees."""
    tcfg = convert.config_from_reference(cfg)
    roots = {k: tmp_path / k for k in ("jax", "h5", "npz")}
    for rank, frame, arrays, angle in batches:
        for k, root in roots.items():
            adir = root / angle
            adir.mkdir(parents=True, exist_ok=True)
            if k == "jax":
                n = jh5.append_photons(cfg, str(adir / f"mc_proc_{rank}.h5"), frame,
                                       _jax_photons(arrays), _Meta)
            elif k == "h5":
                n2 = tph.append_photons(tcfg, str(adir / f"mc_proc_{rank}.h5"), frame, arrays,
                                        _Meta)
            else:
                n3 = tph.append_photons_npz(tcfg, str(adir / f"mc_proc_{rank}"), frame, arrays,
                                            _Meta)
        assert n == n2 == n3 > 0
    return roots


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("comv,stokes,save_type", [(True, True, True), (False, False, False)])
def test_dumps_and_merge_equal_jax(tmp_path, comv, stokes, save_type):
    cfg = Config(comv=comv, stokes=stokes, save_type=save_type)
    a, b, c = _arrays(seed=4), _arrays(n=150, seed=5), _arrays(n=90, seed=6)
    roots = _write_both(tmp_path, cfg, [(0, 30, a, "0-3"), (0, 30, b, "0-3"), (0, 31, b, "0-3"),
                                        (1, 30, c, "0-3"), (0, 31, c, "3-6")])
    jdir, hdir, ndir = (str(roots[k] / "0-3") for k in ("jax", "h5", "npz"))
    want = jh5.merge_all(jdir, [30, 31, 32])
    assert tph.merge_all(hdir, [30, 31, 32]) == want
    assert tph.merge_all(ndir, [30, 31, 32]) == want and want[32] == 0
    assert sorted(os.listdir(os.path.join(ndir, "mc_proc_0", "30"))) == ["0.npz", "1.npz"]
    for fr in (30, 31):
        ref = jh5.read_frame(os.path.join(jdir, f"mcdata_{fr}.h5"))
        _assert_same(tph.read_frame(os.path.join(hdir, f"mcdata_{fr}.h5")), ref)
        _assert_same(tph.read_frame(os.path.join(ndir, f"mcdata_{fr}.npz")), ref)
    assert tph.discover_frames(tph.list_proc_files(ndir)) == jh5.discover_frames(
        [os.path.join(jdir, f"mc_proc_{r}.h5") for r in (0, 1)]) == [30, 31]
    # the cross-angle merge (ALL_DATA) in both formats
    jall = jh5.merge_across_angles(str(roots["jax"]))
    assert tph.merge_across_angles(str(roots["h5"])) == jall
    assert tph.merge_across_angles(str(roots["npz"])) == jall
    for fr in jall:
        ref = jh5.read_frame(str(roots["jax"] / "ALL_DATA" / f"mcdata_{fr}.h5"))
        _assert_same(tph.read_frame(str(roots["h5"] / "ALL_DATA" / f"mcdata_{fr}.h5")), ref)
        _assert_same(tph.read_frame(str(roots["npz"] / "ALL_DATA" / f"mcdata_{fr}.npz")), ref)


def test_npz_merge_is_idempotent_and_rebuilds_a_corrupt_frame(tmp_path):
    cfg = convert.config_from_reference(Config())
    a = _arrays()
    for _ in range(2):
        tph.append_photons_npz(cfg, str(tmp_path / "mc_proc_0"), 5, a, _Meta)
    n = tph.merge_frame(str(tmp_path), 5)
    path = tmp_path / "mcdata_5.npz"
    first = tph.read_frame(str(path))
    stamp = os.stat(path).st_mtime_ns
    assert tph.merge_frame(str(tmp_path), 5) == n and os.stat(path).st_mtime_ns == stamp
    for corrupt in (lambda: np.savez(str(path), P0=np.zeros(3)),  # a truncated merge
                    lambda: path.write_bytes(b"not a zip file")):
        corrupt()
        assert tph.merge_frame(str(tmp_path), 5) == n
        _assert_same(tph.read_frame(str(path)), first)
    # one directory holding both formats is refused, never merged silently
    tph.append_photons(cfg, str(tmp_path / "mc_proc_1.h5"), 5, a, _Meta)
    with pytest.raises(ValueError, match="more than one format"):
        tph.merge_frame(str(tmp_path), 5)
