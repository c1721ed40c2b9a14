"""Carry state from the JAX package into the port, through numpy.

The JAX package's objects are passed in as numpy arrays (``np.asarray`` of
each field) or read by field name, so this module imports nothing of the
JAX package: tests and tools use it to feed both packages the same
configuration, photons, frames and grids.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .config import Config, McPar, Spectrum
from .device import resolve_device
from .grid import (BinnedIndex, HydroFrameHost, RectilinearIndex,
                   build_rectilinear_index)
from .ops.hot_xsec import HotCrossSectionTable
from .transport import Photons

PHOTON_FIELDS = tuple(f.name for f in dataclasses.fields(Photons))
_INT_FIELDS = ("cell", "ptype")


def config_from_reference(obj) -> Config:
    """The port's :class:`~mcrat_tpu_torch.config.Config` from any object
    with its field names (``mcrat_tpu.config.Config``): enums are taken by
    ``.value`` into the port's own enums, so identity checks in the port
    (``cfg.geometry is Geometry.SPHERICAL``) hold.  A port Config is
    returned as it is."""
    if isinstance(obj, Config):
        return obj
    kw = {}
    for f in dataclasses.fields(Config):
        val = getattr(obj, f.name)
        if isinstance(f.default, enum.Enum):
            val = type(f.default)(val.value)
        kw[f.name] = val
    return Config(**kw)


def mcpar_from_reference(obj) -> McPar:
    """The port's :class:`~mcrat_tpu_torch.config.McPar` from any object
    with its field names (``mcrat_tpu.config.McPar``): the spectrum by
    ``.value`` into the port's enum, the per-bin columns as tuples.  A port
    McPar is returned as it is."""
    if isinstance(obj, McPar):
        return obj
    kw = {}
    for f in dataclasses.fields(McPar):
        val = getattr(obj, f.name)
        if isinstance(val, enum.Enum):
            val = Spectrum(val.value)
        elif isinstance(val, (list, tuple)):
            val = tuple(val)
        kw[f.name] = val
    return McPar(**kw)


def photons_from_numpy(arrays: dict, device=None, dtype=torch.float32) -> Photons:
    """Photons from a dict holding the fields of ``mcrat_tpu.transport.
    Photons`` (p, comv_p, pos, s, weight, num_scatt, cell, ptype) as numpy
    arrays, on ``device`` (default: the card)."""
    device = resolve_device(device)
    return Photons(**{
        k: torch.as_tensor(np.array(arrays[k]),
                           dtype=torch.int32 if k in _INT_FIELDS else dtype,
                           device=device)
        for k in PHOTON_FIELDS
    })


def photons_to_numpy(ph: Photons) -> dict:
    """The inverse of :func:`photons_from_numpy`: a dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in ph.fields().items()}


def frame_from_numpy_fields(cfg: Config, fields: dict) -> HydroFrameHost:
    """A host frame from the fields of ``mcrat_tpu.grid.HydroFrameHost``
    (r0 ... domain as numpy arrays, optional nonthermal_dens and jet_axis);
    other keys (such as ``cfg``) are ignored."""
    names = [f.name for f in dataclasses.fields(HydroFrameHost) if f.name != "cfg"]
    kw = {}
    for name in names:
        if name not in fields:
            continue
        val = fields[name]
        kw[name] = val if name == "jet_axis" or val is None else np.array(val, dtype=np.float64)
    return HydroFrameHost(cfg=config_from_reference(cfg), **kw)


def xsec_table_from_numpy(log_e, log_t, thermal, nonthermal=None,
                          subgroup_frac=None) -> HotCrossSectionTable:
    """The port's hot cross-section table from the arrays of ``mcrat_tpu.
    ops.hot_xsec.HotCrossSectionTable`` (or its ``build_*_table``), kept in
    float64."""

    def f64(a):
        return None if a is None else np.array(a, dtype=np.float64)

    return HotCrossSectionTable(log_e=f64(log_e), log_t=f64(log_t), thermal=f64(thermal),
                                nonthermal=f64(nonthermal), subgroup_frac=f64(subgroup_frac))


def index_from_edges(edges0, edges1, edges2=None, dtype=torch.float32,
                     device=None) -> RectilinearIndex:
    """A RectilinearIndex over the edge arrays of ``mcrat_tpu.grid.
    RectilinearIndex`` (numpy; ``edges2`` None for 2-D grids), on ``device``
    (default: the card)."""
    return build_rectilinear_index(
        np.asarray(edges0, dtype=np.float64), np.asarray(edges1, dtype=np.float64),
        None if edges2 is None else np.asarray(edges2, dtype=np.float64),
        dtype=dtype, device=device)


def binned_index_from_numpy(cell_ids, bin_start, bin_count, grid_min, inv_bin, dims,
                            max_slab: int, dtype=torch.float32, device=None) -> BinnedIndex:
    """A BinnedIndex from the arrays of ``mcrat_tpu.grid.BinnedIndex``
    (numpy) and its static ``dims`` and ``max_slab``, on ``device``
    (default: the card)."""
    device = resolve_device(device)

    def i32(a):
        return torch.as_tensor(np.array(a, dtype=np.int32), device=device)

    return BinnedIndex(
        cell_ids=i32(cell_ids), bin_start=i32(bin_start), bin_count=i32(bin_count),
        grid_min=torch.as_tensor(np.array(grid_min), dtype=dtype, device=device),
        inv_bin=torch.as_tensor(np.array(inv_bin), dtype=dtype, device=device),
        dims=tuple(int(d) for d in dims), max_slab=int(max_slab))
