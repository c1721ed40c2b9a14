"""Simulation driver (port of ``mcrat_tpu.driver``): the orchestration layer.

The reference main() (Src/mcrat.c:48-1036) on one device:

* work decomposition over viewing-angle bins x injection frames (the
  reference's MPI strategies, Src/mcrat.c:146, 457-479) as a deterministic
  rank -> (angle bin, frame block) mapping;
* the two-level frame loop: inject at each injection frame, then transport
  through every later hydro frame up to the last, with a decimated hydro
  load, one statistics fetch, a checkpoint and a per-rank photon dump per
  frame;
* restart from the per-rank checkpoint, including elastic re-adoption of
  unfinished old ranks by a job of another size (Src/mcrat.c:166-448);
* a final merge into ``mcdata_<frame>`` files.

Every tensor lives on one device, the card unless the caller passes
``device="cpu"``.  A float32 run transports through the fused-round kernel
on the card (its plain twin, ``transport_frame(fused=True)``, on the CPU,
by the caller's choice); a float64 run (``Config.dtype``) through the XLA
engine on either, its threefry key split once per transport call as the
JAX driver splits its key.  Nothing moves to the CPU or to the other engine
because the card or its kernel failed.  Cyclo-synchrotron runs add the
reference's frame-boundary steps (pool emission, the mid-frame and
end-of-frame rebins, one-for-one pool replenishment, absorption).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import glob
import json
import logging
import math
import os
import shutil
import time
import uuid
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import telemetry, transport
from .config import Config, Dims, HydroSim, McPar
from .device import resolve_device
from .io.checkpoint import CheckpointState, load_checkpoint, save_checkpoint, scan_checkpoints
from .io.hydro import HydroPaths, build_index, get_hydro_data
from .grid import torch_dtype
from .io.photons_h5 import FORMATS, merge_all, proc_path, write_frame
from .ops import cyclosynch
from .ops import fused_round as fr
from .ops.prng import Key
from .parallel import mesh as pmesh
from .parallel.mesh import Sharded

log = logging.getLogger("mcrat_tpu_torch")

# the cyclo-synchrotron keys of a frame's frame_timing record: counts of the
# frame's pool photons, merged and absorbed photons, and host seconds
CS_TIMING = ("n_pool_emitted", "n_promoted", "n_pool_replaced", "n_merged_mid", "n_merged_end",
             "n_absorbed", "emission_s", "rebin_s", "absorption_s")


@dataclasses.dataclass
class WorkAssignment:
    """One rank's slice of the angle x injection-frame work."""

    angle_id: int
    theta_min: float  # radians
    theta_max: float
    r_inj: float
    framestart: int
    frm2: int
    mc_dir: str


def decompose_work(par: McPar, rank: int, num_ranks: int, base_dir: str) -> WorkAssignment:
    """rank -> (angle bin, injection frame block): the reference's angle
    split (procs_per_angle = world / num_bins, color = rank /
    procs_per_angle; Src/mcrat.c:139-162) and per-angle frame blocks
    (proc_frame_size = ceil((frm2 - frm0) / angle_procs), Src/mcrat.c:457-479).
    """
    nbins = par.n_theta_bins
    procs_per_angle = max(num_ranks // nbins, 1)
    angle_id = min(rank // procs_per_angle, nbins - 1)
    angle_rank = rank - angle_id * procs_per_angle

    dtheta = (par.theta_max_deg - par.theta_min_deg) / nbins
    t_lo = par.theta_min_deg + angle_id * dtheta
    t_hi = t_lo + dtheta

    frm0, frm2 = par.frm0[angle_id], par.frm2[angle_id]
    nframes = frm2 - frm0 + 1
    block = math.ceil(nframes / procs_per_angle)
    f_start = frm0 + angle_rank * block
    f_end = min(f_start + block - 1, frm2) if angle_rank < procs_per_angle - 1 else frm2
    # per-angle output directory (reference: Src/mcrat.c:155)
    mc_dir = os.path.join(base_dir, f"{t_lo:g}-{t_hi:g}")
    return WorkAssignment(
        angle_id=angle_id, theta_min=math.radians(t_lo), theta_max=math.radians(t_hi),
        r_inj=par.inj_radius[angle_id], framestart=f_start, frm2=f_end, mc_dir=mc_dir,
    )


@dataclasses.dataclass(frozen=True)
class FrameSchedule:
    """Per-format hydro frame schedule.

    The reference scatters the RIKEN 3-D special case (files every 10
    frames at 1 fps beyond frame 3000) through both driver loops and the
    checkpoint reader (Src/mcrat.c:551-562, 612-624, 667-679;
    Src/mcrat_io.c:1044-1053); here one object answers every schedule
    question.  Every other format is uniform at ``base_fps``.
    """

    base_fps: float
    riken3d: bool = False

    _RIKEN_SWITCH_FRAME = 3000
    _RIKEN_INCREMENT = 10

    def step(self, frame: int):
        """(frame increment, fps) in effect at ``frame``."""
        if self.riken3d and frame >= self._RIKEN_SWITCH_FRAME:
            return self._RIKEN_INCREMENT, 1.0
        return 1, self.base_fps

    def next(self, frame: int) -> int:
        return frame + self.step(frame)[0]

    def frames(self, first: int, last: int):
        """Frame numbers from ``first`` through ``last`` inclusive."""
        frame = first
        while frame <= last:
            yield frame
            frame = self.next(frame)

    def inj_time(self, frame: int) -> float:
        """time_now at a fresh injection: frame / fps, with the fps in effect
        at that frame (reference: mcrat.c:667-679)."""
        return frame / self.step(frame)[1]

    def end_time(self, frame: int, inj_frame: int = 0) -> float:
        """Time at the end of scattering frame ``frame``.

        Uniform formats: (frame + 1) / fps.  RIKEN 3-D accumulates dt = 1 /
        fps per visited frame (1 / base below 3000, 1 s per 10-frame step
        above).  The reference's clock is path-dependent there (time_now is
        seeded as inj_frame / fps(inj_frame), then advanced per visited
        frame, Src/mcrat.c:667-679), so an injection at or beyond frame 3000
        anchors at inj_frame seconds; ``inj_frame`` says which.
        """
        if not self.riken3d or frame < self._RIKEN_SWITCH_FRAME:
            return (frame + 1) / self.base_fps
        k = (frame - self._RIKEN_SWITCH_FRAME) // self._RIKEN_INCREMENT
        if inj_frame >= self._RIKEN_SWITCH_FRAME:
            k0 = (inj_frame - self._RIKEN_SWITCH_FRAME) // self._RIKEN_INCREMENT
            return float(inj_frame) + (k - k0 + 1) * 1.0
        return self._RIKEN_SWITCH_FRAME / self.base_fps + (k + 1) * 1.0


def make_frame_schedule(cfg: Config, par: McPar) -> FrameSchedule:
    return FrameSchedule(
        base_fps=par.fps,
        riken3d=(cfg.sim_switch is HydroSim.RIKEN and cfg.dims is Dims.THREE),
    )


# stale output of an earlier job (mc_proc_*: the h5 dumps' files and the
# npz dumps' directories)
_STALE_PATTERNS = (
    "mc_proc_*",
    "mc_chkpt_*.npz",
    "mc_chkpt_*.npz.old",
    "mc_output_*.log",
    "mcdata_*.h5",
    "mcdata_*.npz",
)


def _stale_files(mc_dir: str):
    out = []
    for pat in _STALE_PATTERNS:
        out.extend(glob.glob(os.path.join(mc_dir, pat)))
    return out


_INIT_READY_PREFIX = ".mc_init_ready."
_INIT_DONE_PREFIX = ".mc_init_done."


def _atomic_write(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


def _rm(paths) -> int:
    """Remove files and directories that exist; the number removed."""
    n = 0
    for path in paths:
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            n += 1
        except FileNotFoundError:
            pass
    return n


def clean_initialize_dir(mc_dir: str, rank: int, cleaner: bool = True, wait_s: float = 30.0,
                         expected_ranks=None) -> int:
    """Delete stale output before an initialize-mode run.

    The reference deletes every mc_proc_*, mcdata_*, mc_chkpt_* and log file
    of the angle directory when restart=INITALIZE finds it non-empty
    (Src/mcrat.c:507-549, behind an MPI barrier so rank 0 cleans before
    anyone writes).  Ranks here are independent processes, so the barrier
    is a per-rank ready/ack marker handshake:

    * every non-cleaner writes ``.mc_init_ready.<rank>`` holding a fresh
      random nonce, then waits until ``.mc_init_done.<rank>`` echoes that
      nonce (a stale ack of an earlier job cannot match);
    * the ``cleaner`` (the lowest rank mapped to the directory) waits up to
      ``wait_s`` for every other expected rank's ready marker, sweeps the
      whole stale set (every old rank's output, so a re-initialize with
      fewer ranks leaves nothing for the merge to double-count), and only
      then acks each ready marker.  No rank writes before its ack.

    Time-outs keep degraded cases safe: a non-cleaner whose ack never comes
    waits ``wait_s``, then removes only its own files and the shared merged
    outputs; a cleaner missing ready markers sweeps anyway after ``wait_s``.

    Returns the number of stale files (and dump directories) this rank
    removed.
    """

    def _ready_markers():
        out = {}
        for p in glob.glob(os.path.join(mc_dir, _INIT_READY_PREFIX + "*")):
            try:
                out[int(p.rsplit(".", 1)[-1])] = p
            except ValueError:
                pass
        return out

    if cleaner:
        # marker debris of long-dead jobs (fresh markers must survive: a
        # concurrent rank may have written its ready marker moments ago)
        old = time.time() - max(4 * wait_s, 120.0)
        for p in glob.glob(os.path.join(mc_dir, ".mc_init_*")):
            try:
                if os.path.getmtime(p) < old:
                    os.remove(p)
            except OSError:
                pass
        expected = set(expected_ranks or ()) - {rank}
        deadline = time.monotonic() + wait_s
        while expected - set(_ready_markers()) and time.monotonic() < deadline:
            time.sleep(0.05)
        removed = _rm(_stale_files(mc_dir))
        # ack only after the sweep: an acked rank may write at once
        for r, p in _ready_markers().items():
            try:
                with open(p) as f:
                    nonce = f.read().strip()
            except OSError:
                continue
            _atomic_write(os.path.join(mc_dir, f"{_INIT_DONE_PREFIX}{r}"), nonce)
        return removed

    nonce = uuid.uuid4().hex
    ready = os.path.join(mc_dir, f"{_INIT_READY_PREFIX}{rank}")
    done = os.path.join(mc_dir, f"{_INIT_DONE_PREFIX}{rank}")
    _rm([done])
    _atomic_write(ready, nonce)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            with open(done) as f:
                if f.read().strip() == nonce:
                    _rm([ready, done])
                    return 0  # the cleaner swept everything before acking
        except OSError:
            pass
        time.sleep(0.05)
    # no cleaner: this rank's own output and the shared merged outputs
    _rm([ready])
    own = [os.path.join(mc_dir, name) for name in (
        f"mc_proc_{rank}.h5", f"mc_proc_{rank}", f"mc_chkpt_{rank}.npz",
        f"mc_chkpt_{rank}.npz.old", f"mc_output_{rank}.log")]
    own = [p for p in own if os.path.exists(p)]
    own.extend(glob.glob(os.path.join(mc_dir, "mcdata_*.h5")))
    own.extend(glob.glob(os.path.join(mc_dir, "mcdata_*.npz")))
    return _rm(own)


def _fetch_async(fields: dict):
    """Start the device -> host copy of ``fields`` (name -> tensor): on a
    CUDA device one non-blocking copy per field into pinned host memory and
    a CUDA event after them on the current stream; on the CPU the tensors
    themselves.  Returns (host tensors, event or None)."""
    if not any(v.is_cuda for v in fields.values()):
        return fields, None
    host = {}
    for k, v in fields.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _log_frame(timing: dict) -> None:
    """The one log record of a frame, with the record attribute
    ``frame_timing`` (``timing``: counts, statistics and seconds; the
    cyclo-synchrotron counts and seconds where it holds them)."""
    msg = ("rank %d frame %d scatt %d: %d scatterings (%d rounds); num_scatt max/mean "
           "%.0f/%.2f; <r> %.3e; transport %.4f s, persistence wait %.4f s (fetch %.4f s, "
           "checkpoint %.4f s, dump %.4f s)")
    args = [timing[k] for k in ("rank", "frame", "scatt_frame", "n_scatt", "n_rounds",
                                "n_scatt_max", "n_scatt_mean", "r_mean", "transport_s",
                                "persist_wait_s", "fetch_s", "checkpoint_s", "dump_s")]
    if "n_pool_emitted" in timing:
        msg += ("; pool emitted %d, promoted %d, replaced %d, merged %d + %d, absorbed %d "
                "(emission %.4f s, rebin %.4f s, absorption %.4f s)")
        args += [timing[k] for k in CS_TIMING]
    log.info(msg, *args, extra={"frame_timing": timing})


class _PersistWriter:
    """Background checkpoint + dump writer.

    One worker thread keeps the writes in order (the checkpoint, then the
    dump only if the checkpoint was written: reference Src/mcrat.c:902-915)
    while the main thread launches the next frame's device work.
    :meth:`submit_frame` starts the device -> host copy of the live subset
    (``transport.compact_live``: fresh tensors, never the population
    buffers that the next frame writes in place) into pinned buffers before
    it queues the job, so the transfer overlaps too; the worker waits on
    the copy's CUDA event.  A write error surfaces on the next
    :meth:`submit_frame` or :meth:`close`.  Its steps are the spans
    ``driver.persist.wait`` (the main thread), ``driver.persist.fetch``,
    ``.checkpoint`` and ``.dump`` (the worker).
    """

    def __init__(self):
        self._ex = concurrent.futures.ThreadPoolExecutor(1)
        self._fut = None

    def submit_frame(self, cfg: Config, mc_dir: str, rank: int, st: CheckpointState,
                     sub_ph: transport.Photons, meta, scatt_frame: int, proc: str,
                     timing: dict) -> None:
        """Queue the frame's writes.  ``timing`` gets ``persist_wait_s`` (the
        wait for the previous frame's writes) here and, once this frame's are
        done, the worker's ``fetch_s`` (the copy's event), ``checkpoint_s``
        and ``dump_s``; the worker then logs it (:func:`_log_frame`)."""
        timing["persist_wait_s"] = 0.0
        self.wait(timing)  # at most one frame in flight; surfaces earlier errors
        fields = sub_ph.fields()
        # the Stokes planes with Stokes off and the cell cache (the first
        # lookup after a resume re-resolves it) stay on the device; comv_p
        # is always kept (see io/checkpoint.py: F2 is not copied)
        if not cfg.stokes:
            fields["s"] = fields["s"][:0]
        fields["cell"] = fields["cell"][:0]
        host, ready = _fetch_async(fields)

        def job():
            with telemetry.timed("driver.persist.fetch", timing, "fetch_s"):
                if ready is not None:
                    ready.synchronize()
                arrays = {k: v.numpy() for k, v in host.items()}
            with telemetry.timed("driver.persist.checkpoint", timing, "checkpoint_s"):
                save_checkpoint(mc_dir, rank, st, arrays)
            with telemetry.timed("driver.persist.dump", timing, "dump_s"):
                write_frame(cfg, proc, scatt_frame, arrays, meta)
            _log_frame(timing)

        self._fut = self._ex.submit(job)

    def wait(self, timing: Optional[dict] = None) -> None:
        """Wait for the frame in flight; its seconds go to
        ``timing["persist_wait_s"]`` where ``timing`` is given."""
        if self._fut is not None:
            fut, self._fut = self._fut, None
            with telemetry.timed("driver.persist.wait", timing, "persist_wait_s"):
                fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._ex.shutdown()


def stream_states(generator: torch.Generator, rng: np.random.Generator,
                  key: Optional[Key]) -> dict:
    """The checkpoint fields of the run's random streams, as they stand
    (no key on a kernel run)."""
    return dict(generator_state=generator.get_state().numpy(),
                rng_state=json.dumps(rng.bit_generator.state),
                key_state=None if key is None else key.state())


def _require_h5py(why: str) -> None:
    try:
        import h5py  # noqa: F401
    except ImportError as exc:
        raise ImportError(f"{why} needs h5py") from exc


def _check_output(output: str) -> None:
    if output not in FORMATS:
        raise ValueError(f"output must be one of {FORMATS}, not {output!r}")
    if output == "h5":
        _require_h5py("output='h5' (output='npz' writes the same datasets without it)")


def _check_reader(cfg: Config) -> None:
    """The HDF5 formats (FLASH, PLUTO .h5, PLUTO-Chombo) need h5py; PLUTO
    .dbl and RIKEN files need numpy only."""
    sim = cfg.sim_switch
    if sim in (HydroSim.FLASH, HydroSim.PLUTO_CHOMBO) or (
            sim is HydroSim.PLUTO and cfg.pluto_filetype.value.endswith("h5")):
        _require_h5py(f"reading {sim.value} frames ({cfg.pluto_filetype.value} files)"
                      if sim is HydroSim.PLUTO else f"reading {sim.value} frames")


def run_rank(
    cfg: Config,
    par: McPar,
    paths: HydroPaths,
    rank: int = 0,
    num_ranks: int = 1,
    base_dir: Optional[str] = None,
    synthetic_frame_factory: Optional[Callable[[int], tuple]] = None,
    generator: Optional[torch.Generator] = None,
    key: Optional[Key] = None,
    chunk_rounds: int = 256,
    last_frame_override: Optional[int] = None,
    ph_weight: float = 1e50,
    work: Optional[WorkAssignment] = None,
    init_clean_wait_s: float = 30.0,
    device=None,
    output: str = "h5",
    rounds_fn=fr.fused_rounds,
    mesh: Optional[pmesh.Mesh] = None,
) -> WorkAssignment:
    """Run one rank's simulation: inject -> transport -> checkpoint -> dump
    (``mcrat_tpu.driver.run_rank`` on one device).

    ``synthetic_frame_factory(frame) -> (HydroFrameHost, edges | None)``
    supplies the frames of SYNTHETIC runs; file-backed formats read from
    ``paths``.  ``device`` (default: the card) holds every tensor; on
    ``"cpu"`` a float32 run transports through the kernel's plain twin; a
    float64 run (``cfg.dtype``) takes the XLA engine on either device.
    ``generator`` (a CPU ``torch.Generator``, seeded 1234 + rank when None)
    draws the kernel's seeds; ``key`` (a threefry ``ops.prng.Key``,
    ``Key.from_seed(1234 + rank)`` when None) is split once per transport
    call of a float64 run, the XLA engine's, as the JAX driver splits its
    key (a float32 run draws no key and checkpoints none); injection
    draws from ``np.random.default_rng(9876 + rank)``.  A resume from one of
    this package's checkpoints continues all three streams from the states
    it saved (``io.checkpoint``, fault F9).
    ``output`` is the dump format, ``"h5"`` or ``"npz"``
    (``io.photons_h5``); "h5" without h5py raises ImportError before
    anything is injected, and so do the HDF5 hydro formats (FLASH, PLUTO
    .h5, PLUTO-Chombo).  TABLE runs cache the hot cross sections in
    ``base_dir/hot_x_section.npz``.  ``rounds_fn`` is the round
    implementation ``transport_frame`` passes to the glue: the kernel
    wrapper, or ``fused_round.fused_rounds_reference`` to run the plain twin
    on the card for a comparison.  Each frame logs one record with the
    attribute ``frame_timing``: its counts (photons, scatterings, rounds;
    cyclo-synchrotron pool photons emitted, promoted and replaced, photons
    merged by the mid-frame and end-of-frame rebins, photons absorbed), the
    host seconds of transport (the frame's main-thread wall to its
    statistics fetch, less emission, rebinning and absorption), emission,
    rebinning and absorption, the main thread's wait for the previous
    frame's writes and this frame's fetch, checkpoint and dump seconds
    (:meth:`_PersistWriter.submit_frame`).

    With ``mesh`` (:func:`~mcrat_tpu_torch.parallel.mesh.make_mesh`) the
    photon axis is sharded over the mesh (``device`` is then the mesh's
    first device) and each frame window runs as one
    ``parallel.mesh.sharded_transport_frame``: an injection's photons go in
    equal runs to the shards' slabs (``parallel.mesh.spread_photons``, its
    capacity padded to equal slabs), each process keeps its own shards'
    slabs, growth (``grow_photons`` on every slab, the frame time
    alongside), appends, rebins and absorption act on them,
    the statistics come from one collective, and the persistence subset is
    gathered on the main thread in the same order on every process.  Every
    process of the mesh runs this same call; only process 0 touches
    files (the stale sweep, the log, checkpoints and dumps), and a resume
    loads the checkpoint on every process, restores the population's
    injection capacity and continues the same random streams.  A mesh
    run's results depend on the mesh size; a resumed mesh run equals the
    uninterrupted one where the live photons fill the first lanes (runs
    without cyclo-synchrotron).
    """
    _check_output(output)
    _check_reader(cfg)
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    files_here = mesh is None or mesh.process_index == 0
    base_dir = base_dir or os.path.join(paths.filepath, paths.mc_path)
    cleaner = True  # explicit-work callers (elastic) adopt old ranks alone
    dir_ranks = None
    if work is None:
        work = decompose_work(par, rank, num_ranks, base_dir)
        # the lowest rank mapped to this angle dir does the full stale sweep
        # (the reference's per-communicator rank 0, Src/mcrat.c:507-549)
        procs_per_angle = max(num_ranks // par.n_theta_bins, 1)
        cleaner = rank == work.angle_id * procs_per_angle
        dir_ranks = [r for r in range(num_ranks)
                     if min(r // procs_per_angle, par.n_theta_bins - 1) == work.angle_id]
    log_handler = None
    if files_here:
        os.makedirs(work.mc_dir, exist_ok=True)
        if par.restart == "i":
            n_rm = clean_initialize_dir(work.mc_dir, rank, cleaner=cleaner,
                                        wait_s=init_clean_wait_s, expected_ranks=dir_ranks)
            if n_rm:
                log.info("rank %d: initialize mode removed %d stale outputs", rank, n_rm)
        # per-rank log file (reference: mc_output_<rank>.log, Src/mcrat.c:567-575)
        log_handler = logging.FileHandler(os.path.join(work.mc_dir, f"mc_output_{rank}.log"))
        log_handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        log.addHandler(log_handler)
        if log.level > logging.INFO or log.level == logging.NOTSET:
            log_handler.setLevel(logging.INFO)
            log.setLevel(logging.INFO)
    persist = _PersistWriter()
    try:
        return _run_rank_inner(
            cfg, par, paths, rank, base_dir, synthetic_frame_factory, generator, key,
            chunk_rounds, last_frame_override, ph_weight, work, persist, device, output,
            rounds_fn, mesh, files_here,
        )
    finally:
        persist.close()
        if log_handler is not None:
            log.removeHandler(log_handler)
            log_handler.close()


def _population(photons) -> transport.Photons:
    """A population's first slab on a mesh, the population itself else
    (for its dtype and device)."""
    return photons.parts[0] if isinstance(photons, Sharded) else photons


def _frame_stats(photons, n_abs=None) -> list:
    """``transport.frame_stats`` as a list, in one host fetch (on a mesh,
    one collective), with the absorbed count (one tensor, or one a shard
    on a mesh) appended when given."""
    if isinstance(photons, Sharded):
        return pmesh.frame_stats(photons, () if n_abs is None else n_abs)
    stats = transport.frame_stats(photons)
    if n_abs is not None:
        stats = torch.cat([stats, n_abs.to(stats.dtype)[None]])
    return stats.tolist()


def _absorb(photons, nu_c: torch.Tensor):
    """``cyclosynch.apply_absorption``: (photons, absorbed count, or one a
    shard on a mesh)."""
    if not isinstance(photons, Sharded):
        return cyclosynch.apply_absorption(photons, nu_c)[:2]
    out = [cyclosynch.apply_absorption(p, nu_c.to(p.device)) for p in photons.parts]
    return Sharded(photons.mesh, [o[0] for o in out]), [o[1] for o in out]


def _rebin(cfg: Config, photons, max_photons: int, n_cs: int, t_rem=None):
    """``cyclosynch.rebin_population``; on a mesh the scattered-CS subset is
    gathered over every process (a collective) and merged alike on each."""
    if not isinstance(photons, Sharded):
        return cyclosynch.rebin_population(cfg, photons, max_photons, n_cs=n_cs, t_rem=t_rem)
    if n_cs <= max_photons:
        return photons, None, None
    nulled, sub, sub_t = pmesh.extract_cs_subset(photons, transport._pow2(n_cs), t_rem)
    return (nulled, *cyclosynch.rebin_subset(cfg, sub, sub_t, max_photons, t_rem is not None))


def _append_arrays(photons, meta, arrays: dict, n_alive: int, t_rem=None, new_t=None,
                   place=None):
    """Append host photon arrays to the population on its device
    (``mcrat_tpu.driver._append_arrays``): grown to the next
    power of two when its free slots (capacity - ``n_alive``, the live count
    the driver tracks from its statistics fetches) cannot take them, the new
    photons packed with the population's weight norm, ``place`` (or None)
    applied to them, then written into the first free slots.  ``t_rem`` and
    ``new_t`` carry the frame time of a mid-frame append alongside.  On a
    mesh every process packs the same new photons, each slab growing by its
    share and each shard taking the run of them its free slots hold.
    Returns (photons, number appended, t_rem)."""
    if not arrays:
        return photons, 0, t_rem
    n_new = len(arrays["weight"])
    sharded = isinstance(photons, Sharded)
    if photons.capacity - n_alive < n_new:
        new_cap = int(2 ** math.ceil(math.log2(photons.capacity + n_new)))
        if sharded:
            photons, t_rem = pmesh.grow(
                photons, pmesh.pad_capacity(new_cap, photons.mesh.n_shards), t_rem)
        else:
            photons, t_rem = transport.grow_photons(photons, new_cap, t_rem)
    first = _population(photons)
    n_pad = transport._pow2(n_new)
    new, _ = transport.photons_from_arrays(arrays, capacity=n_pad, dtype=first.p.dtype,
                                           device=first.device, weight_norm=meta.weight_norm)
    if place is not None:
        new = place(new)
    nt = None
    if t_rem is not None:
        nt = torch.zeros(n_pad, dtype=first.p.dtype)
        nt[:n_new] = torch.as_tensor(new_t, dtype=first.p.dtype)
        nt = nt.to(first.device)
    if sharded:
        photons, t_rem = pmesh.append_photons(photons, new, t_rem, nt)
    else:
        photons, t_rem = transport.append_photons_device(photons, new, t_rem, nt)
    return photons, n_new, t_rem


def _run_rank_inner(cfg, par, paths, rank, base_dir, synthetic_frame_factory, generator, key,
                    chunk_rounds, last_frame_override, ph_weight, work, persist, device,
                    output, rounds_fn, mesh, files_here) -> WorkAssignment:
    generator = generator if generator is not None else torch.Generator().manual_seed(1234 + rank)
    rng = np.random.default_rng(9876 + rank)
    dtype = torch_dtype(cfg)
    last_frm = last_frame_override or par.last_frame
    # the engine: float32 takes the kernel on the card (fused=None:
    # transport_frame raises if it cannot build or launch it) and its plain
    # twin on the CPU; float64 takes the XLA engine on either (fused=None),
    # the one engine that draws from the threefry key
    fused = True if device.type == "cpu" and dtype == torch.float32 else None
    if dtype != torch.float64:
        key = None
    elif key is None:
        key = Key.from_seed(1234 + rank, device=device)
    proc = proc_path(work.mc_dir, rank, output)

    xsec_table = None
    if cfg.tau_calculation.value == "table":
        from .ops import hot_xsec

        xsec_table = hot_xsec.load_or_build(cfg, os.path.join(base_dir, "hot_x_section.npz"),
                                            device=device)

    # restart (reference: Src/mcrat.c:166-455)
    state = photons = meta = None
    if par.restart == "c":
        loaded = load_checkpoint(work.mc_dir, rank, dtype=dtype, device=device)
        if loaded is not None:
            state, photons = loaded
            meta = transport.PhotonsMeta(state.weight_norm, state.n_injected)
            if state.generator_state is not None:
                generator.set_state(torch.from_numpy(state.generator_state))
            if state.rng_state is not None:
                rng.bit_generator.state = json.loads(state.rng_state)
            if key is not None and state.key_state is not None:
                key = Key.from_state(state.key_state, device=device)
            if mesh is not None and photons is not None:
                # the injection's capacity and runs: every photon is back in its lane
                photons = pmesh.spread_photons(photons, mesh, int(2 ** math.ceil(
                    math.log2(max(state.n_injected, 1) * cfg.capacity_factor))))
            log.info("rank %d: continuing from frame %d scatt %d", rank, state.frame,
                     state.scatt_frame)

    sched = make_frame_schedule(cfg, par)

    def load_frame(frame, ph_inj, bounds):
        synth = edges = None
        if synthetic_frame_factory is not None:
            synth, edges = synthetic_frame_factory(frame)
        host = get_hydro_data(cfg, paths, frame, sched.step(frame)[1], work.r_inj, ph_inj,
                              *(bounds or (0.0, np.inf, 0.0, np.pi)), synthetic_frame=synth)
        return host, edges

    frame0 = state.frame if state else work.framestart
    pending_stats = None  # frame_stats of the population, fetched once a frame

    for frame in sched.frames(frame0, work.frm2):
        fresh = state is None or frame != state.frame or state.restart == "i"
        if fresh:
            time_now = sched.inj_time(frame)
            host, _ = load_frame(frame, True, None)
            arrays, _ = transport.inject_photons(
                host, work.r_inj, ph_weight, par.min_photons, par.max_photons, par.spect,
                work.theta_min, work.theta_max, sched.step(frame)[1], rng)
            pending_stats = None
            cap = int(2 ** math.ceil(math.log2(len(arrays["weight"]) * cfg.capacity_factor)))
            photons, meta = transport.photons_from_arrays(arrays, capacity=cap, dtype=dtype,
                                                          device=device)
            if mesh is not None:
                photons = pmesh.spread_photons(photons, mesh)
            scatt_start = frame
            log.info("rank %d: injected %d photons at frame %d (w=%.3e)", rank,
                     meta.n_injected, frame, meta.weight_norm)
        else:
            time_now = state.time_now
            scatt_start = state.scatt_frame

        for scatt_frame in sched.frames(scatt_start, last_frm):
            dt_frame = sched.end_time(scatt_frame, inj_frame=frame) - time_now
            if dt_frame <= 0:
                continue
            with telemetry.frame("driver.frame", device) as frame_span:
                cs = dict.fromkeys(CS_TIMING, 0)
                # one statistics fetch a frame: the decimation bounds, the pool
                # and live counts come with the previous frame's statistics
                if pending_stats is None:
                    pending_stats = _frame_stats(photons)
                r_min, r_max, t_min, t_max = pending_stats[4:8]
                n_pool, n_alive = int(pending_stats[8]), int(pending_stats[9])
                # cyclo-synchrotron after an injection's first frame, the first
                # frame after a resume included (F11 of the JAX package, which
                # tests scatt_frame != scatt_start, is not copied): the pool
                # lives in the injection shell advected to this frame, at the
                # schedule's fps (F3, par.fps there, is not copied either)
                cs_active = cfg.cyclosynchrotron and scatt_frame != frame
                shell_fps = sched.step(scatt_frame)[1]
                if cs_active:
                    lo, hi = cyclosynch.cs_r_limits(scatt_frame, frame, shell_fps, work.r_inj)
                    r_min, r_max = min(r_min, lo), max(r_max, hi)
                host, edges = load_frame(scatt_frame, False, (r_min, r_max, t_min, t_max))
                frame_dev = host.to_device(device, dtype=dtype)
                index = build_index(cfg, host, edges, device=device)

                def place(new):
                    # fault F10 (not copied): merged photons get their cell and
                    # comoving momentum before transport or absorption reads them
                    return cyclosynch.place_in_cells(cfg, frame_dev, index, new)

                def emit(fn, *args):
                    with telemetry.timed("driver.emission", cs, "emission_s"):
                        return fn(cfg, host, scatt_frame, frame, shell_fps, work.r_inj,
                                  meta.weight_norm, *args, work.theta_min, work.theta_max, rng)

                def rebin(ph, n_cs, t_rem=None):
                    with telemetry.timed("driver.rebin", cs, "rebin_s"):
                        return _rebin(cfg, ph, par.max_photons, n_cs, t_rem)

                if cs_active:
                    arrays, _ = emit(cyclosynch.emit_pool_photons, par.max_photons)
                    photons, cs["n_pool_emitted"], _ = _append_arrays(photons, meta, arrays,
                                                                      n_alive)
                    n_alive += cs["n_pool_emitted"]
                    n_pool += cs["n_pool_emitted"]

                # transport, the mid-frame rebin armed when cyclo-synchrotron is
                # live: the scattered pool photons merge at a chunk boundary once
                # they pass max_photons, and the frame goes on from each photon's
                # frame time (reference: Src/mcrat.c:819-830)
                n_scatt = n_rounds = 0
                t_rem0 = None
                while True:
                    sub = None
                    if key is not None:
                        key, sub = key.split()
                    kw = dict(stokes_on=cfg.stokes, chunk_rounds=chunk_rounds, fused=fused,
                              rounds_fn=rounds_fn, xsec_table=xsec_table, t_rem0=t_rem0,
                              cs_limit=par.max_photons if cs_active else None, key=sub)
                    if mesh is None:
                        res = transport.transport_frame(cfg, photons, frame_dev, index, dt_frame,
                                                        generator, **kw)
                    else:
                        res = pmesh.sharded_transport_frame(cfg, mesh, photons, frame_dev, index,
                                                            dt_frame, generator, **kw)
                    photons = res.photons
                    n_scatt += res.n_scatt
                    n_rounds += res.n_rounds
                    if not res.rebin_pending:
                        break
                    photons, merged, merged_t = rebin(photons, res.n_cs, res.t_rem)
                    t_rem0 = res.t_rem
                    n_alive -= res.n_cs
                    merged["weight"] = merged["weight"] * meta.weight_norm
                    with telemetry.timed("driver.rebin", cs, "rebin_s"):
                        photons, n_mrg, t_rem0 = _append_arrays(photons, meta, merged, n_alive,
                                                                t_rem0, merged_t, place)
                    n_alive += n_mrg
                    cs["n_merged_mid"] += n_mrg
                    log.info("rank %d frame %d scatt %d: mid-frame rebin %d -> %d CS photons", rank,
                             frame, scatt_frame, res.n_cs, n_mrg)
                time_now += dt_frame

                n_abs = None
                if cs_active:
                    # one-for-one replenishment of the promoted pool photons
                    # (Src/mcrat.c:791-808), the end-of-frame rebin, absorption
                    # (Src/mcrat.c:819-830, 853-878); one statistics fetch gives
                    # the pool deficit, the live count and the rebin trigger
                    mid = _frame_stats(photons)
                    n_alive, n_cs = int(mid[9]), int(mid[10])
                    cs["n_promoted"] = n_pool - int(mid[8])
                    if cs["n_promoted"] > 0:
                        arrays = emit(cyclosynch.emit_pool_replacements, cs["n_promoted"])
                        photons, cs["n_pool_replaced"], _ = _append_arrays(photons, meta, arrays,
                                                                           n_alive)
                        n_alive += cs["n_pool_replaced"]
                    photons, merged, _ = rebin(photons, n_cs)
                    if merged is not None:
                        n_alive -= n_cs
                        merged["weight"] = merged["weight"] * meta.weight_norm
                        with telemetry.timed("driver.rebin", cs, "rebin_s"):
                            photons, cs["n_merged_end"], _ = _append_arrays(
                                photons, meta, merged, n_alive, place=place)
                    with telemetry.timed("driver.absorption", cs, "absorption_s"):
                        nu_c = cyclosynch.cell_nu_c(cfg, host, device, dtype)
                        photons, n_abs = _absorb(photons, nu_c)
                # end-of-frame fetch: statistics for the log, the next frame's
                # decimation bounds, the live count that sizes the dump (and
                # the absorbed count)
                pending_stats = _frame_stats(photons, n_abs)
                if n_abs is not None:
                    cs["n_absorbed"] = int(pending_stats.pop())
                transport_s = (frame_span.elapsed_s() - cs["emission_s"] - cs["rebin_s"]
                               - cs["absorption_s"])
                mx, _, mean, r_avg = pending_stats[0:4]
                n_live = int(pending_stats[9])

                # the next scatt frame per the schedule (reference: the RIKEN +10
                # resume case in readCheckpoint, mcrat_io.c:1044-1053)
                st = CheckpointState(
                    frame=frame, frm2=work.frm2, scatt_frame=sched.next(scatt_frame),
                    time_now=time_now, restart="c",
                    weight_norm=meta.weight_norm, n_injected=meta.n_injected,
                    **stream_states(generator, rng, key),
                )
                timing = dict(rank=rank, frame=frame, scatt_frame=scatt_frame, n_photons=n_live,
                              n_scatt=n_scatt, n_rounds=n_rounds, n_scatt_max=mx,
                              n_scatt_mean=mean, r_mean=r_avg, transport_s=transport_s, **cs)
                n_out = min(transport._pad64k(n_live), photons.capacity)
                if mesh is None:
                    sub_ph = transport.compact_live(photons, n_out)
                else:
                    # the persistence gather is a collective: on the main thread,
                    # in the same order on every process; only process 0 writes
                    with telemetry.timed("driver.gather", timing, "gather_s"):
                        sub_ph = pmesh.gather_live(photons, n_out)
                if files_here:
                    persist.submit_frame(cfg, work.mc_dir, rank, st, sub_ph, meta, scatt_frame,
                                         proc, timing)

        # injection-complete marker (reference: mcrat_io.c:966-1001)
        state = None
        if files_here:
            persist.wait()
            next_inj = sched.next(frame)
            save_checkpoint(work.mc_dir, rank, CheckpointState(
                frame=next_inj, frm2=work.frm2, scatt_frame=next_inj, time_now=time_now,
                restart="i", **stream_states(generator, rng, key)))

    return work


def elastic_work_items(par: McPar, base_dir: str, last_frame: int):
    """Unfinished old-rank checkpoints of every angle directory, as a
    deterministic list of (angle_id, mc_dir, WorkItem) sorted by (angle,
    old rank), so every new rank computes the same assignment (the
    discovery half of the reference's elastic restart,
    Src/mcrat_io.c:10-112)."""
    items = []
    nbins = par.n_theta_bins
    dtheta = (par.theta_max_deg - par.theta_min_deg) / nbins
    for angle_id in range(nbins):
        t_lo = par.theta_min_deg + angle_id * dtheta
        mc_dir = os.path.join(base_dir, f"{t_lo:g}-{t_lo + dtheta:g}")
        if not os.path.isdir(mc_dir):
            continue
        for wi in scan_checkpoints(mc_dir, last_frame):
            items.append((angle_id, mc_dir, wi))
    return items


def run_elastic(cfg: Config, par: McPar, paths: HydroPaths, rank: int = 0,
                num_ranks: int = 1, base_dir: Optional[str] = None,
                last_frame_override: Optional[int] = None,
                **run_kw) -> Sequence[WorkAssignment]:
    """Re-adopt unfinished old-rank work under a new job of any size
    (Src/mcrat.c:166-448, which aborts when the ranks cannot be mapped,
    :402-407): the unfinished items are dealt round-robin over the new
    ranks, and each resumes under its old rank id, so checkpoint and output
    names stay consistent."""
    base_dir = base_dir or os.path.join(paths.filepath, paths.mc_path)
    last_frm = last_frame_override or par.last_frame
    items = elastic_work_items(par, base_dir, last_frm)
    adopted = items[rank::max(num_ranks, 1)]
    log.info("elastic rank %d/%d: adopting %d of %d unfinished work items", rank, num_ranks,
             len(adopted), len(items))
    par_c = dataclasses.replace(par, restart="c")
    dtheta = (par.theta_max_deg - par.theta_min_deg) / par.n_theta_bins
    done = []
    for angle_id, mc_dir, wi in adopted:
        t_lo = par.theta_min_deg + angle_id * dtheta
        work = WorkAssignment(
            angle_id=angle_id, theta_min=math.radians(t_lo),
            theta_max=math.radians(t_lo + dtheta), r_inj=par.inj_radius[angle_id],
            framestart=wi.state.frame, frm2=wi.state.frm2, mc_dir=mc_dir,
        )
        done.append(run_rank(cfg, par_c, paths, rank=wi.old_rank, num_ranks=num_ranks,
                             base_dir=base_dir, last_frame_override=last_frame_override,
                             work=work, **run_kw))
    return done


def default_synthetic_factory(cfg: Config, par: McPar, nr: int = 384, ntheta: int = 64):
    """Synthetic-grid factory of SYNTHETIC runs driven by mc.par alone: one
    static 2-D spherical log-r grid over the mc.par domain (the analytic
    outflows are time-independent; each frame's load re-applies the
    profile)."""
    from .models.analytic import synthetic_spherical_frame

    r_lo = max(par.r0_domain[0], min(par.inj_radius) / 20.0)
    r_hi = par.r0_domain[1]
    theta_hi = min(max(math.radians(par.theta_max_deg) * 3.0, 0.3), math.pi)
    host, edges = synthetic_spherical_frame(cfg, r_min=r_lo, r_max=r_hi, nr=nr, ntheta=ntheta,
                                            theta_max=theta_hi)

    def factory(frame):
        return host, edges

    return factory


def merge_rank_outputs(work: WorkAssignment, par: McPar, last_frame=None):
    """Merge the per-process outputs of this angle directory into
    ``mcdata_<frame>`` files (the in-run merge, reference:
    Src/mcrat.c:934-1023)."""
    frames = range(min(par.frm0), (last_frame or par.last_frame) + 1)
    return merge_all(work.mc_dir, frames)
