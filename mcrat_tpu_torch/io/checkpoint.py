"""Checkpoint, resume and elastic restart (port of ``mcrat_tpu.io.checkpoint``).

saveCheckpoint/readCheckpoint (reference: Src/mcrat_io.c:838-1134) and the
discovery half of the elastic re-adoption (Src/mcrat.c:166-448):

* per-rank ``mc_chkpt_<rank>.npz`` files hold the photon fields plus the loop
  counters, in the JAX package's npz layout: a checkpoint written by either
  package loads in the other;
* crash safety is write-to-temp + atomic rename, with the previous file kept
  as ``.old`` (Src/mcrat_io.c:857,969);
* :func:`scan_checkpoints` lists exactly the unfinished work of every old
  rank, so a new job of any size can re-adopt it.

The port's checkpoints always keep ``comv_p``: the kernel's lane planes
load it (``transport.lane_planes``) and the carried TABLE path reads it
before the first kernel call of a frame (``transport.aux_planes``), so a
resume must see the comoving momenta the run had.  The JAX package drops
them with COMV output off (ROADMAP fault F2); such a file loads here with
zeros in their place, as it loads there.

The port's checkpoints also keep the states of the run's three random
streams: the kernel seeds' ``torch.Generator``, the XLA engine's threefry
key and the injection's numpy generator.  A resume continues all three.
The JAX package reseeds its key and its generator at a resume, so the first
frame after it draws the same random numbers as the first frame of the run,
and the next injection those of the first injection: the frames after a
resume are correlated with the run's first
(ROADMAP fault F9; the mean energy of the 2-D spherical default frame moves
by ~0.5 % there).  A JAX-package file carries no states; the port then
reseeds as that package does.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ..config import PhotonType
from ..device import resolve_device
from ..transport import Photons

# the photon fields of a checkpoint, in the JAX package's order
FIELDS = ("p", "comv_p", "pos", "s", "weight", "num_scatt", "cell", "ptype")
_INT_FIELDS = ("cell", "ptype")


@dataclasses.dataclass
class CheckpointState:
    """Loop counters saved with the photon population
    (reference: Src/mcrat_io.c:872-894)."""

    frame: int  # current injection frame
    frm2: int  # last injection frame for this rank
    scatt_frame: int  # current scattering frame
    time_now: float
    restart: str  # 'c' mid-run | 'i' injection-complete marker
    weight_norm: float = 1.0
    n_injected: int = 0
    # the port's additions (the JAX package neither writes nor reads them):
    # torch.Generator.get_state() of the kernel seeds, as uint8, the
    # injection generator's numpy bit_generator.state, as JSON, and the XLA
    # engine's threefry key words (ops.prng.Key.state), as uint32
    generator_state: Optional[np.ndarray] = dataclasses.field(default=None, compare=False)
    rng_state: Optional[str] = None
    key_state: Optional[np.ndarray] = dataclasses.field(default=None, compare=False)


def checkpoint_path(mc_dir: str, rank: int) -> str:
    return os.path.join(mc_dir, f"mc_chkpt_{rank}.npz")


def save_checkpoint(mc_dir: str, rank: int, state: CheckpointState,
                    photons: Optional[dict] = None) -> None:
    """Write a checkpoint; the previous file becomes ``.old`` first.

    saveCheckpoint's cases (reference: Src/mcrat_io.c:838-1009): mid-run
    (``photons``, restart='c') and the injection-complete marker (no
    photons, restart='i').  ``photons`` is a dict of numpy arrays with the
    fields of :class:`~mcrat_tpu_torch.transport.Photons`, fetched once
    (``s`` and ``cell`` may be empty (0, ...) placeholders when the run
    does not need them: Stokes off, and the cell cache, which the first
    lookup after a resume re-resolves).  Scattered cyclo-synchrotron photons
    are relabelled UNABSORBED_CS on save (reference: :896-901).
    """
    path = checkpoint_path(mc_dir, rank)
    payload = dict(
        frame=state.frame, frm2=state.frm2, scatt_frame=state.scatt_frame,
        time_now=state.time_now, restart=state.restart,
        weight_norm=state.weight_norm, n_injected=state.n_injected,
    )
    if state.generator_state is not None:
        payload["generator_state"] = np.asarray(state.generator_state, dtype=np.uint8)
    if state.rng_state is not None:
        payload["rng_state"] = state.rng_state
    if state.key_state is not None:
        payload["key_state"] = np.asarray(state.key_state, dtype=np.uint32)
    if photons is not None:
        ptype = np.array(photons["ptype"])
        ptype[ptype == int(PhotonType.COMPTONIZED)] = int(PhotonType.UNABSORBED_CS)
        payload.update({k: np.asarray(photons[k]) for k in FIELDS if k != "ptype"})
        payload["ptype"] = ptype
    tmp = path + ".tmp.npz"
    # uncompressed: photon state is high-entropy floats
    np.savez(tmp, **payload)
    if os.path.exists(path):
        os.replace(path, path + ".old")
    os.replace(tmp, path)


def read_checkpoint(mc_dir: str, rank: int, with_photons: bool = True):
    """(state, dict of numpy photon fields | None), or None without a file
    (reference: readCheckpoint's missing-file branch, Src/mcrat_io.c:1124-1133).
    Falls back to the ``.old`` file when the primary is missing (a crash
    between save_checkpoint's two renames).  Planes a file left out come
    back filled: ``comv_p`` with zeros, ``s`` unpolarized, ``cell`` -1.
    ``with_photons=False`` reads the counters alone."""
    path = checkpoint_path(mc_dir, rank)
    if not os.path.exists(path):
        if not os.path.exists(path + ".old"):
            return None
        path = path + ".old"
    with np.load(path, allow_pickle=False) as z:
        state = CheckpointState(
            frame=int(z["frame"]), frm2=int(z["frm2"]), scatt_frame=int(z["scatt_frame"]),
            time_now=float(z["time_now"]), restart=str(z["restart"]),
            weight_norm=float(z["weight_norm"]), n_injected=int(z["n_injected"]),
            generator_state=z["generator_state"] if "generator_state" in z.files else None,
            rng_state=str(z["rng_state"]) if "rng_state" in z.files else None,
            key_state=z["key_state"] if "key_state" in z.files else None,
        )
        if "p" not in z.files or not with_photons:
            return state, None
        arrays = {k: z[k] for k in FIELDS}
    n = len(arrays["weight"])
    if arrays["comv_p"].shape[0] != n:
        # left out by a JAX-package run with COMV output off (F2)
        arrays["comv_p"] = np.zeros((n, 4), arrays["comv_p"].dtype)
    if arrays["s"].shape[0] != n:
        s = np.zeros((n, 4), arrays["s"].dtype)
        s[:, 0] = 1.0
        arrays["s"] = s
    if arrays["cell"].shape[0] != n:
        arrays["cell"] = np.full(n, -1, np.int32)
    return state, arrays


def load_checkpoint(mc_dir: str, rank: int, dtype=torch.float32, device=None):
    """(state, Photons | None) on ``device`` (default: the card) in
    ``dtype``, or None without a file (:func:`read_checkpoint`)."""
    loaded = read_checkpoint(mc_dir, rank)
    if loaded is None:
        return None
    state, arrays = loaded
    if arrays is None:
        return state, None
    device = resolve_device(device)
    return state, Photons(**{
        k: torch.as_tensor(arrays[k], dtype=torch.int32 if k in _INT_FIELDS else dtype,
                           device=device)
        for k in FIELDS})


@dataclasses.dataclass
class WorkItem:
    """One unfinished old-rank work unit discovered at restart."""

    old_rank: int
    state: CheckpointState


def scan_checkpoints(mc_dir: str, last_frame: int) -> List[WorkItem]:
    """Every old rank with unfinished work (the predicate of
    getOrigNumProcesses, reference: Src/mcrat_io.c:80): injection frames
    left (frame <= frm2) or scattering frames left (scatt_frame <=
    last_frame).  Ranks are found through ``mc_chkpt_<rank>.npz`` and its
    ``.old`` backup alike, as :func:`read_checkpoint` falls back to it.
    Reads the counters only; nothing goes to a device."""
    ranks = set()
    for path in glob.glob(os.path.join(mc_dir, "mc_chkpt_*.npz")) + glob.glob(
            os.path.join(mc_dir, "mc_chkpt_*.npz.old")):
        m = re.search(r"mc_chkpt_(\d+)\.npz(\.old)?$", path)
        if m:
            ranks.add(int(m.group(1)))
    items = []
    for rank in sorted(ranks):
        loaded = read_checkpoint(mc_dir, rank, with_photons=False)
        if loaded is None:
            continue
        state, _ = loaded
        unfinished = (state.frame <= state.frm2) and (
            state.scatt_frame <= last_frame or state.restart == "i")
        if state.restart == "c" and state.scatt_frame <= last_frame:
            unfinished = True
        if unfinished:
            items.append(WorkItem(old_rank=rank, state=state))
    return items
