"""Photon dumps with the ProcessMCRaT schema, and their merge (port of
``mcrat_tpu.io.photons_h5``).

printPhotons / dirFileMerge / the MERGE tool (reference:
Src/mcrat_io.c:114-836, 1239-1772; Src/merge.c).  Each rank's photons go
into one group per scattering frame of 1-D datasets

    P0 P1 P2 P3 [COMV_P0..3] R0 R1 R2 [S0..S3] NS PW [PT]

(Doc/mcrat_doc.tex:362-384), four-momenta in cgs E/c units (the photon
arrays are in units of m_e c), so downstream tooling reads them unchanged.
Two formats hold the same datasets, units and frame groups:

* ``h5`` (the JAX package's): ``mc_proc_<rank>.h5``, one HDF5 group per
  frame, each injection batch appended to its datasets; merged into
  ``mcdata_<frame>.h5``.  Needs h5py, imported where it is used.
* ``npz``, for machines without h5py: the directory ``mc_proc_<rank>/``,
  one subdirectory per frame, each append its own ``<batch>.npz``
  (0, 1, ... in write order); merged into ``mcdata_<frame>.npz``.

:func:`merge_frame`, :func:`merge_all`, :func:`merge_across_angles` and
:func:`read_frame` read either format and write the merged frame in the
format of their input, with the reference's corruption check.  The writers
take the photons as the dict of numpy arrays that the persistence path
fetched once from the device.
"""
from __future__ import annotations

import glob
import os
import re
import zipfile
from typing import Iterable, Optional

import numpy as np

from ..config import PHOTON_TYPE_CHARS, Config, PhotonType
from ..constants import ME_C

FORMATS = ("h5", "npz")
ALL_DATA_DIR = "ALL_DATA"
_BATCH = re.compile(r"(\d+)\.npz")


def _chunks(n):
    return (min(max(n, 1), 1 << 16),)


def _type_char_lut() -> np.ndarray:
    """(max_type + 1,) S1 lookup table: PHOTON_TYPE_CHARS, vectorized."""
    lut = np.full(max(int(t) for t in PhotonType) + 1, b"?", dtype="S1")
    for t, ch in PHOTON_TYPE_CHARS.items():
        lut[int(t)] = ch.encode()
    return lut


def dump_arrays(cfg: Config, photons: dict, meta,
                exclude_types: Iterable[int] = (PhotonType.CS_POOL,)) -> dict:
    """The schema's datasets (float64; PT as S1 characters) of the live
    photons of ``photons`` (numpy fields of ``transport.Photons``): null,
    zero-weight and ``exclude_types`` photons are left out, COMV_* with
    ``cfg.comv`` off, S* with ``cfg.stokes`` off and PT with
    ``cfg.save_type`` off.  Empty when no photon is kept."""
    ptype = np.asarray(photons["ptype"])
    w = np.asarray(photons["weight"]).astype(np.float64) * meta.weight_norm
    keep = (w > 0) & (ptype != int(PhotonType.NULL))
    for t in exclude_types:
        keep &= ptype != int(t)
    if not keep.any():
        return {}
    p = np.asarray(photons["p"])[keep].astype(np.float64) * ME_C
    pos = np.asarray(photons["pos"])[keep].astype(np.float64)
    data = {
        "P0": p[:, 0], "P1": p[:, 1], "P2": p[:, 2], "P3": p[:, 3],
        "R0": pos[:, 0], "R1": pos[:, 1], "R2": pos[:, 2],
        "NS": np.asarray(photons["num_scatt"])[keep].astype(np.float64), "PW": w[keep],
    }
    if cfg.comv:
        comv = np.asarray(photons["comv_p"])[keep].astype(np.float64) * ME_C
        data.update(COMV_P0=comv[:, 0], COMV_P1=comv[:, 1], COMV_P2=comv[:, 2],
                    COMV_P3=comv[:, 3])
    if cfg.stokes:
        s = np.asarray(photons["s"])[keep].astype(np.float64)
        data.update(S0=s[:, 0], S1=s[:, 1], S2=s[:, 2], S3=s[:, 3])
    if cfg.save_type:
        data["PT"] = _type_char_lut()[ptype[keep]]
    return data


def proc_path(mc_dir: str, rank: int, output: str) -> str:
    """A rank's per-process output in format ``output`` (one of
    :data:`FORMATS`): ``mc_proc_<rank>.h5`` or the directory
    ``mc_proc_<rank>``."""
    return os.path.join(mc_dir, f"mc_proc_{rank}" + (".h5" if output == "h5" else ""))


def append_photons(cfg: Config, path: str, frame: int, photons: dict, meta,
                   exclude_types: Iterable[int] = (PhotonType.CS_POOL,)) -> int:
    """Append the live photons to the frame group of a per-process HDF5
    file (printPhotons, reference: Src/mcrat_io.c:114-836): the group and
    its chunked, unlimited datasets are made on the first write and
    extended after (several injection batches share a frame group).
    Returns the number of photons written."""
    import h5py

    data = dump_arrays(cfg, photons, meta, exclude_types)
    if not data:
        return 0
    n = len(data["P0"])
    with h5py.File(path, "a") as f:
        grp = f.require_group(str(frame))
        for k, v in data.items():
            if k in grp:
                ds = grp[k]
                old = ds.shape[0]
                ds.resize((old + n,))
                ds[old:] = v
            else:
                grp.create_dataset(k, data=v, maxshape=(None,), chunks=_chunks(n))
    return n


def _batches(frame_dir: str) -> list:
    """The batch files of one frame group, in write order."""
    if not os.path.isdir(frame_dir):
        return []
    found = [(int(m.group(1)), name) for name in os.listdir(frame_dir)
             if (m := _BATCH.fullmatch(name))]
    return [os.path.join(frame_dir, name) for _, name in sorted(found)]


def append_photons_npz(cfg: Config, proc_dir: str, frame: int, photons: dict, meta,
                       exclude_types: Iterable[int] = (PhotonType.CS_POOL,)) -> int:
    """:func:`append_photons` without HDF5: the same datasets as one new
    ``<proc_dir>/<frame>/<batch>.npz`` (batch = the group's file count),
    written to a temporary name and renamed.  Returns the number of photons
    written."""
    data = dump_arrays(cfg, photons, meta, exclude_types)
    if not data:
        return 0
    frame_dir = os.path.join(proc_dir, str(frame))
    os.makedirs(frame_dir, exist_ok=True)
    batch = len(_batches(frame_dir))
    tmp = os.path.join(frame_dir, f"{batch}.tmp.npz")
    np.savez(tmp, **data)
    os.replace(tmp, os.path.join(frame_dir, f"{batch}.npz"))
    return len(data["P0"])


def write_frame(cfg: Config, path: str, frame: int, photons: dict, meta) -> int:
    """Append to the per-process output ``path`` (:func:`proc_path`) in its
    format."""
    writer = append_photons if path.endswith(".h5") else append_photons_npz
    return writer(cfg, path, frame, photons, meta)


def list_proc_files(out_dir: str) -> list:
    """The per-process outputs of a directory: ``mc_proc_*.h5`` files, then
    ``mc_proc_*`` directories, each sorted by name."""
    h5 = sorted(glob.glob(os.path.join(out_dir, "mc_proc_*.h5")))
    npz = sorted(p for p in glob.glob(os.path.join(out_dir, "mc_proc_*")) if os.path.isdir(p))
    return h5 + npz


def _format_of(proc_files: list) -> str:
    kinds = {"h5" if p.endswith(".h5") else "npz" for p in proc_files}
    if len(kinds) != 1:
        raise ValueError(f"per-process outputs in more than one format: {proc_files}")
    return kinds.pop()


def _read_group(proc: str, frame: int) -> Optional[dict]:
    """One per-process output's datasets of ``frame`` (None without them)."""
    if proc.endswith(".h5"):
        import h5py

        with h5py.File(proc, "r") as f:
            if str(frame) not in f:
                return None
            grp = f[str(frame)]
            return {k: np.asarray(grp[k]) for k in grp.keys()}
    parts = {}
    for path in _batches(os.path.join(proc, str(frame))):
        with np.load(path, allow_pickle=False) as z:
            for k in z.files:
                parts.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in parts.items()} or None


def read_frame(path: str) -> dict:
    """A merged ``mcdata_<frame>.h5`` or ``.npz`` as a dict of numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


def _merged_ok(out_path: str, cat: dict, total: int) -> bool:
    """Whether an existing merged file holds every dataset at ``total``
    rows (the reference's corruption check, Src/mcrat_io.c:1450)."""
    try:
        have = read_frame(out_path)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return False
    return all(k in have and have[k].shape[0] == total for k in cat)


def merge_frame(out_dir: str, frame: int, proc_files: Optional[list] = None,
                out_path: Optional[str] = None) -> int:
    """Concatenate every rank's group of ``frame`` into ``mcdata_<frame>``
    in the format of the per-process outputs (dirFileMerge for one frame,
    reference: Src/mcrat_io.c:1239-1772).  Idempotent: an existing output
    whose datasets do not all hold the expected total is rebuilt.  Returns
    the photon count."""
    proc_files = proc_files or list_proc_files(out_dir)
    arrays = {}
    for proc in proc_files:
        for k, v in (_read_group(proc, frame) or {}).items():
            arrays.setdefault(k, []).append(v)
    if not arrays:
        return 0
    fmt = _format_of(proc_files)
    out_path = out_path or os.path.join(out_dir, f"mcdata_{frame}.{fmt}")
    cat = {k: np.concatenate(v) for k, v in arrays.items()}
    total = len(next(iter(cat.values())))
    if os.path.exists(out_path) and _merged_ok(out_path, cat, total):
        return total
    if fmt == "npz":
        tmp = out_path[:-len(".npz")] + ".tmp.npz"
        np.savez(tmp, **cat)
    else:
        import h5py

        tmp = out_path + ".tmp"
        with h5py.File(tmp, "w") as f:
            for k, v in cat.items():
                f.create_dataset(k, data=v)
    os.replace(tmp, out_path)
    return total


def merge_all(out_dir: str, frames: Iterable[int]) -> dict:
    """Merge a list of frames (the MERGE tool's per-group work, reference:
    Src/merge.c:268-340)."""
    return {fr: merge_frame(out_dir, fr) for fr in frames}


def discover_angle_dirs(base_dir: str) -> list:
    """Angle directories under an MC base directory: every subdirectory
    but ALL_DATA with a per-process output of either format (the MERGE
    tool's scan, reference: Src/merge.c:80-161)."""
    dirs = []
    for name in sorted(os.listdir(base_dir)):
        path = os.path.join(base_dir, name)
        if os.path.isdir(path) and name != ALL_DATA_DIR and list_proc_files(path):
            dirs.append(path)
    return dirs


def discover_frames(proc_files: Iterable[str]) -> list:
    """Sorted union of the frame groups of per-process outputs."""
    found = set()
    for path in proc_files:
        if path.endswith(".h5"):
            import h5py

            with h5py.File(path, "r") as f:
                found |= {int(k) for k in f.keys()}
        else:
            found |= {int(name) for name in os.listdir(path) if name.isdigit()}
    return sorted(found)


def merge_across_angles(base_dir: str, frames: Optional[Iterable[int]] = None) -> dict:
    """Cross-angle merge: every angle directory's per-process outputs into
    ``ALL_DATA/mcdata_<frame>`` (the standalone MERGE binary, reference:
    Src/merge.c:23-336), in their format; resumable through
    :func:`merge_frame`'s check.  Returns {frame: photon count}."""
    angle_dirs = discover_angle_dirs(base_dir)
    if not angle_dirs:
        raise FileNotFoundError(f"no angle directories with per-process outputs under {base_dir}")
    proc_files = [p for adir in angle_dirs for p in list_proc_files(adir)]
    fmt = _format_of(proc_files)
    if frames is None:
        frames = discover_frames(proc_files)
    out_dir = os.path.join(base_dir, ALL_DATA_DIR)
    os.makedirs(out_dir, exist_ok=True)
    return {
        fr: merge_frame(base_dir, fr, proc_files=proc_files,
                        out_path=os.path.join(out_dir, f"mcdata_{fr}.{fmt}"))
        for fr in frames
    }
