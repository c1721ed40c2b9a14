"""Hydro frames and the rectilinear spatial index (port of ``mcrat_tpu.grid``).

:class:`HydroFrameHost` is the host (numpy float64) view that frame
construction and injection work on; :meth:`HydroFrameHost.to_device` makes the torch
:class:`HydroFrame` with the fused-round kernel's cell tables: the 16/24-row
``packed`` matrix (``PCOL``), the slim 8-row matrix ``packed_slim``
(``PCOL_SLIM``) and the ultra physics table ``phys`` (4 rows
``[v0, v1, ne_lab, temp]`` in 2-D, 5 rows ``[v0, v1, v2, ne_lab, temp]`` in
3-D cartesian).

:class:`RectilinearIndex` locates photons on structured grids: uniform axes
by ``floor((x - lo) * inv_d)``, others by ``searchsorted``; cell order is the
C-order raveled meshgrid, ``idx = (i * n1 + j) * n2 + k``.
:class:`BinnedIndex` locates them in an unstructured cell list (AMR output):
a uniform-bin CSR index searched over each photon's +-1 bin neighbourhood,
behind the cached-cell pin of :func:`find_cell_rows`; on the card the search
is one launch of ``csrc/binned_search.cu`` (``ops.binned_search``), and
:func:`find_cell_direct` one launch of ``csrc/direct_lookup.cu``
(``ops.direct_lookup``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import Config, Dims, Geometry
from .constants import A_RAD, M_P

from . import geometry as geo
from . import telemetry
from .device import resolve_device
from .ops.binned_search import binned_search
from .ops.direct_lookup import direct_lookup

# Row layout of HydroFrame.packed (mcrat_tpu.grid.PCOL).  In 3-D, v0..v2 hold
# the fluid velocity already in MCRaT Cartesian (to_device pre-transforms
# it); in 2-D/2.5-D they stay in the hydro basis.  sin1/cos1 cache the cell's
# angular r1 coordinate (theta in spherical, phi in 3-D polar); 3-D spherical
# frames also cache sin2/cos2 of the cell's azimuth, in rows 16 and 17 of a
# 24-row matrix.
PCOL = dict(
    r0=0, r1=1, r2=2, dr0=3, dr1=4, dr2=5,
    v0=6, v1=7, v2=8, gamma=9, dens_lab=10, temp=11, nonthermal_dens=12,
    sin1=13, cos1=14,
    sin2=16, cos2=17,
)
PACKED_WIDTH = 16

# Slim row layout (HydroFrame.packed_slim): the per-cell state of the 2-D
# cartesian/cylindrical fused round (mcrat_tpu.grid.PCOL_SLIM).
PCOL_SLIM = dict(r0=0, r1=1, dr0=2, dr1=3, v0=4, v1=5, ne_lab=6, temp=7)
SLIM_WIDTH = 8


def packed_width(cfg: Config) -> int:
    """Rows in HydroFrame.packed for this config (16, or 24 for 3-D spherical)."""
    if cfg.dims is Dims.THREE and cfg.geometry is Geometry.SPHERICAL:
        return 24
    return PACKED_WIDTH


def fluid_beta_from_rows(cfg: Config, rows: torch.Tensor, ph_x, ph_y) -> torch.Tensor:
    """Fluid 3-velocity (N, 3) in MCRaT Cartesian from gathered packed columns
    (W, N) (mcrat_tpu.grid.fluid_beta_from_rows): the photon azimuth enters
    through x/rho and y/rho, the cell's angular trig through the sin1/cos1
    rows."""
    v0 = rows[PCOL["v0"]]
    v1 = rows[PCOL["v1"]]
    if cfg.dims is Dims.THREE:
        return torch.stack([v0, v1, rows[PCOL["v2"]]], dim=-1)
    v2 = rows[PCOL["v2"]] if cfg.dims is not Dims.TWO else torch.zeros_like(v0)
    rho = torch.sqrt(ph_x * ph_x + ph_y * ph_y)
    has_rho = rho > 0
    safe_rho = torch.where(has_rho, rho, 1.0)
    c2 = torch.where(has_rho, ph_x / safe_rho, 1.0)
    s2 = torch.where(has_rho, ph_y / safe_rho, 0.0)
    g = cfg.geometry
    if g in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
        return torch.stack([v0 * c2 - v2 * s2, v0 * s2 + v2 * c2, v1], dim=-1)
    if g is Geometry.SPHERICAL:
        s1 = rows[PCOL["sin1"]]
        c1 = rows[PCOL["cos1"]]
        vr_plane = v0 * s1 + v1 * c1
        return torch.stack(
            [vr_plane * c2 - v2 * s2, vr_plane * s2 + v2 * c2, v0 * c1 - v1 * s1], dim=-1)
    raise ValueError(f"unsupported 2-D geometry {g}")


@dataclasses.dataclass
class HydroFrame:
    """One hydro snapshot as (Ncell,) tensors on one device.

    Field names mirror the reference hydro_dataframe (Src/mcrat.h:205-225).
    ``packed`` (16 or 24, Ncell) exists for every frame; ``packed_slim``
    (8, Ncell) for 2-D cartesian/cylindrical/spherical frames without a
    phi-hat velocity; ``phys`` for those frames (4 rows) and for 3-D
    cartesian frames (5 rows).
    """

    r0: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    dr0: torch.Tensor
    dr1: torch.Tensor
    dr2: torch.Tensor
    r: torch.Tensor
    theta: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    dens: torch.Tensor
    dens_lab: torch.Tensor
    pres: torch.Tensor
    temp: torch.Tensor
    gamma: torch.Tensor
    domain: torch.Tensor  # (3, 2) hydro-coordinate bounds
    nonthermal_dens: torch.Tensor
    packed: Optional[torch.Tensor] = None
    packed_slim: Optional[torch.Tensor] = None
    phys: Optional[torch.Tensor] = None

    @property
    def num_elements(self) -> int:
        return self.r0.shape[0]


def frame_from_numpy(cfg: Config, arrays: dict, domain=None) -> "HydroFrameHost":
    """Build a host frame from a dict of numpy arrays.

    Required keys: r0, r1, dr0, dr1, v0, v1, dens, pres.  Optional: r2, dr2,
    v2, B0, B1, B2, dens_lab, temp, gamma.  Derived quantities follow the
    reference readers (Src/mclib_flash.c:377-379): gamma = 1/sqrt(1 - v^2),
    dens_lab = rho gamma, temp = (3 p / a)^(1/4).
    """
    n = len(arrays["r0"])
    z = np.zeros(n)

    def f64(key, default=None):
        val = arrays[key] if default is None else arrays.get(key, default)
        return np.asarray(val, dtype=np.float64)

    r0, r1, r2 = f64("r0"), f64("r1"), f64("r2", z)
    dr0, dr1, dr2 = f64("dr0"), f64("dr1"), f64("dr2", z)
    v0, v1, v2 = f64("v0"), f64("v1"), f64("v2", z)
    dens, pres = f64("dens"), f64("pres")
    if "gamma" in arrays:
        gamma = f64("gamma")
    else:
        v2sum = v0 * v0 + v1 * v1 + (v2 * v2 if cfg.dims is not Dims.TWO else 0.0)
        gamma = 1.0 / np.sqrt(np.maximum(1.0 - v2sum, 1e-30))
    dens_lab = np.asarray(arrays.get("dens_lab", dens * gamma), dtype=np.float64)
    temp = np.asarray(arrays.get("temp", (3.0 * pres / A_RAD) ** 0.25), dtype=np.float64)
    sph_r, sph_theta = geo.hydro_to_spherical(cfg, r0, r1, r2)
    if domain is None:
        three = cfg.dims is Dims.THREE
        domain = np.array([
            [(r0 - dr0 / 2).min(), (r0 + dr0 / 2).max()],
            [(r1 - dr1 / 2).min(), (r1 + dr1 / 2).max()],
            [(r2 - dr2 / 2).min() if three else 0.0, (r2 + dr2 / 2).max() if three else 0.0],
        ])
    return HydroFrameHost(
        cfg=cfg, r0=r0, r1=r1, r2=r2, dr0=dr0, dr1=dr1, dr2=dr2,
        r=np.asarray(sph_r), theta=np.asarray(sph_theta),
        v0=v0, v1=v1, v2=v2, dens=dens, dens_lab=dens_lab, pres=pres,
        temp=temp, gamma=gamma,
        B0=f64("B0", z), B1=f64("B1", z), B2=f64("B2", z),
        domain=np.asarray(domain, dtype=np.float64),
    )


@dataclasses.dataclass
class HydroFrameHost:
    """Host (numpy, float64) view of a frame: construction and injection
    work here."""

    cfg: Config
    r0: np.ndarray
    r1: np.ndarray
    r2: np.ndarray
    dr0: np.ndarray
    dr1: np.ndarray
    dr2: np.ndarray
    r: np.ndarray
    theta: np.ndarray
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    dens: np.ndarray
    dens_lab: np.ndarray
    pres: np.ndarray
    temp: np.ndarray
    gamma: np.ndarray
    B0: np.ndarray
    B1: np.ndarray
    B2: np.ndarray
    domain: np.ndarray
    nonthermal_dens: Optional[np.ndarray] = None
    # jet axis of the theta cache: "z" (default) or "y" (RIKEN 3-D frames,
    # reference: Src/mclib_riken.c:965) -- a real field here, not a getattr
    # side channel (ROADMAP queue 3, F5)
    jet_axis: str = "z"

    @property
    def num_elements(self) -> int:
        return len(self.r0)

    def volumes(self) -> np.ndarray:
        return np.asarray(geo.element_volume(
            self.cfg, self.r0, self.r1, self.r2, self.dr0, self.dr1, self.dr2))

    def packed_slim(self) -> Optional[np.ndarray]:
        """(8, Ncell) float64 slim matrix, or None where the layout does not
        apply (3-D, polar, or a phi-hat velocity)."""
        if (self.cfg.dims is not Dims.TWO
                or self.cfg.geometry not in (Geometry.CARTESIAN, Geometry.CYLINDRICAL,
                                             Geometry.SPHERICAL)
                or np.any(self.v2)):
            return None
        return np.stack([
            self.r0, self.r1, self.dr0, self.dr1,
            self.v0, self.v1, self.dens_lab * (1.0 / M_P), self.temp,
        ])

    def packed(self) -> np.ndarray:
        """(16 or 24, Ncell) float64 packed matrix (``PCOL``), as
        ``mcrat_tpu.grid.HydroFrameHost.to_device`` builds it."""
        n = self.num_elements
        cfg = self.cfg
        packed = np.zeros((packed_width(cfg), n))
        if cfg.dims is Dims.THREE:
            # the Cartesian fluid velocity is per-cell constant in 3-D
            vel = geo.hydro_vector_to_cartesian(
                cfg, self.v0, self.v1, self.v2, self.r0, self.r1, self.r2)
        else:
            vel = (self.v0, self.v1, self.v2)
        cols = dict(
            r0=self.r0, r1=self.r1, r2=self.r2,
            dr0=self.dr0, dr1=self.dr1, dr2=self.dr2,
            v0=vel[0], v1=vel[1], v2=vel[2],
            gamma=self.gamma, dens_lab=self.dens_lab, temp=self.temp,
            nonthermal_dens=(self.nonthermal_dens if self.nonthermal_dens is not None
                             else np.zeros(n)),
            sin1=np.sin(self.r1), cos1=np.cos(self.r1),
        )
        if packed.shape[0] > PACKED_WIDTH:
            cols.update(sin2=np.sin(self.r2), cos2=np.cos(self.r2))
        for name, val in cols.items():
            packed[PCOL[name], :] = val
        return packed

    def to_device(self, device=None, dtype=torch.float32) -> HydroFrame:
        """Copy the frame onto ``device`` (default: the card) as ``dtype``
        tensors."""
        device = resolve_device(device)
        n = self.num_elements
        nt = self.nonthermal_dens if self.nonthermal_dens is not None else np.zeros(n)

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        packed_t = put(self.packed())
        slim = self.packed_slim()
        slim_t = put(slim) if slim is not None else None
        if slim_t is not None:
            phys = slim_t[PCOL_SLIM["v0"]: PCOL_SLIM["temp"] + 1].contiguous()
        elif self.cfg.dims is Dims.THREE and self.cfg.geometry is Geometry.CARTESIAN:
            # ne_lab from the packed float32 row, as the JAX glue's ultra 3-D
            # table (mcrat_tpu/transport.py:764-769)
            phys = torch.stack([
                packed_t[PCOL["v0"]], packed_t[PCOL["v1"]], packed_t[PCOL["v2"]],
                packed_t[PCOL["dens_lab"]] * (1.0 / M_P), packed_t[PCOL["temp"]],
            ])
        else:
            phys = None
        return HydroFrame(
            r0=put(self.r0), r1=put(self.r1), r2=put(self.r2),
            dr0=put(self.dr0), dr1=put(self.dr1), dr2=put(self.dr2),
            r=put(self.r), theta=put(self.theta),
            v0=put(self.v0), v1=put(self.v1), v2=put(self.v2),
            dens=put(self.dens), dens_lab=put(self.dens_lab), pres=put(self.pres),
            temp=put(self.temp), gamma=put(self.gamma),
            domain=put(self.domain), nonthermal_dens=put(nt),
            packed=packed_t, packed_slim=slim_t, phys=phys,
        )


# ---------------------------------------------------------------------------
# Spatial index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RectilinearIndex:
    """Structured-grid index: cell (i, j[, k]) from the edge arrays.

    Uniformly spaced axes (detected at build time) use O(1) arithmetic
    ``floor((x - lo) * inv_d)``; others fall back to ``searchsorted``.
    ``lo``/``inv_d`` are (3,) tensors (unused entries 0/1).
    """

    edges0: torch.Tensor
    edges1: torch.Tensor
    edges2: torch.Tensor  # length-2 dummy for 2-D
    lo: torch.Tensor
    inv_d: torch.Tensor
    uniform: tuple = (False, False, False)
    three_d: bool = False
    # the direct lookup kernel's tables of the last frame looked up (lookup_tables)
    _tables: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False,
                                                 compare=False)

    @property
    def shape(self) -> tuple:
        """Cells per axis, (n0, n1, n2)."""
        return tuple(e.shape[0] - 1 for e in (self.edges0, self.edges1, self.edges2))

    def axis_index(self, axis: int, x: torch.Tensor) -> torch.Tensor:
        """Cell index along one axis (clipped), arithmetic or searchsorted."""
        edges = (self.edges0, self.edges1, self.edges2)[axis]
        n = edges.shape[0] - 1
        if self.uniform[axis]:
            i = torch.floor((x - self.lo[axis]) * self.inv_d[axis]).to(torch.int32)
        else:
            i = torch.searchsorted(edges, x.contiguous(), right=True).to(torch.int32) - 1
        return torch.clamp(i, 0, n - 1)

    def find(self, r0, r1, r2) -> torch.Tensor:
        n1 = self.edges1.shape[0] - 1
        i = self.axis_index(0, r0)
        j = self.axis_index(1, r1)
        inside = (
            (r0 >= self.edges0[0]) & (r0 <= self.edges0[-1])
            & (r1 >= self.edges1[0]) & (r1 <= self.edges1[-1])
        )
        if self.three_d:
            n2 = self.edges2.shape[0] - 1
            k = self.axis_index(2, r2)
            inside = inside & (r2 >= self.edges2[0]) & (r2 <= self.edges2[-1])
            idx = (i * n1 + j) * n2 + k
        else:
            idx = i * n1 + j
        return torch.where(inside, idx, -1)

    def lookup_tables(self, frame: HydroFrame, lane_dtype: torch.dtype) -> tuple:
        """The direct lookup kernel's tables for lanes of ``lane_dtype`` on
        ``frame``: (params, edges).  ``params`` (18,) in ``lane_dtype``, the
        dtype the plain version compares and bins in: the frame's domain
        bounds (lo, hi) per axis, ``lo`` and ``inv_d`` per axis, then each
        axis's first and last edge.  ``edges`` the three edge arrays in the
        dtype searchsorted compares in (the promotion of the lanes' and the
        index's).  Built with no host sync and kept for the last frame and
        dtype looked up; the domain is held meanwhile, and an in-place write
        to it builds them anew."""
        key = (lane_dtype, id(frame.domain), frame.domain._version)
        if self._tables is None or self._tables[0] != key:
            edges = (self.edges0, self.edges1, self.edges2)
            ends = torch.stack([v for e in edges for v in (e[0], e[-1])]).to(lane_dtype)
            params = torch.cat([frame.domain.to(lane_dtype).reshape(-1), self.lo.to(lane_dtype),
                                self.inv_d.to(lane_dtype), ends])
            edge_dtype = torch.promote_types(lane_dtype, self.edges0.dtype)
            self._tables = (key, frame.domain, (params.contiguous(), tuple(
                e.to(edge_dtype).contiguous() for e in edges)))
        return self._tables[2]


def _axis_uniform(edges: np.ndarray) -> bool:
    d = np.diff(edges)
    return bool(d.size > 0 and np.allclose(d, d[0], rtol=1e-5, atol=0.0))


def build_rectilinear_index(edges0, edges1, edges2=None, dtype=torch.float32,
                            device=None) -> RectilinearIndex:
    """Index over the given cell edges (numpy, host float64), on ``device``
    (default: the card)."""
    device = resolve_device(device)
    e0 = np.asarray(edges0, dtype=np.float64)
    e1 = np.asarray(edges1, dtype=np.float64)
    e2 = np.asarray(edges2, dtype=np.float64) if edges2 is not None else np.array([0.0, 1.0])
    lo = np.array([e0[0], e1[0], e2[0]])
    d = np.array([(e[-1] - e[0]) / max(e.size - 1, 1) for e in (e0, e1, e2)])
    inv_d = 1.0 / np.where(d > 0, d, 1.0)

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return RectilinearIndex(
        edges0=put(e0), edges1=put(e1), edges2=put(e2), lo=put(lo), inv_d=put(inv_d),
        uniform=(_axis_uniform(e0), _axis_uniform(e1), _axis_uniform(e2)),
        three_d=edges2 is not None,
    )


def torch_dtype(cfg: Config) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


# Live temporaries of the binned search per (lane, candidate): the int64 slab
# index, the candidate id and its four (2-D) or six (3-D) gathered geometry
# values, the per-axis tests and the hit mask -- ~100 bytes, rounded up.
_SEARCH_BYTES_PER_CANDIDATE = 128
# the binned search holds at most this many bytes of candidate slabs at once
SEARCH_BUDGET_BYTES = 256 << 20


@dataclasses.dataclass
class BinnedIndex:
    """Uniform-bin CSR index over an unstructured cell list (AMR output)
    (mcrat_tpu.grid.BinnedIndex): cells counting-sorted into uniform bins no
    smaller than the largest cell along each axis, so a containing cell's
    centre is within one bin of the photon.  ``cell_ids`` (Ncell,) int32
    lists the cells by flat bin id ``(k * d1 + j) * d0 + i``, bin b holding
    ``cell_ids[bin_start[b]: bin_start[b] + bin_count[b]]``."""

    cell_ids: torch.Tensor  # (Ncell,) int32, sorted by flat bin id
    bin_start: torch.Tensor  # (nbins,) int32
    bin_count: torch.Tensor  # (nbins,) int32
    grid_min: torch.Tensor  # (3,)
    inv_bin: torch.Tensor  # (3,) 1 / bin size
    dims: tuple = (1, 1, 1)
    max_slab: int = 64  # candidates searched per bin
    # the search kernel's tables of the last frame searched (search_tables)
    _tables: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False,
                                                 compare=False)

    @property
    def device(self) -> torch.device:
        return self.cell_ids.device

    def _bin(self, x, axis: int) -> torch.Tensor:
        """Bin index along one axis, truncated toward zero and clipped (the
        float is clamped first, so out-of-range values cannot overflow)."""
        d = self.dims[axis]
        f = (x - self.grid_min[axis]) * self.inv_bin[axis]
        f = torch.clamp(torch.nan_to_num(f, nan=0.0), -1.0, float(d))
        return torch.clamp(f.to(torch.int64), 0, d - 1)

    def _find_chunk(self, r0, r1, r2, frame: HydroFrame) -> torch.Tensor:
        d0, d1, d2 = self.dims
        use_r2 = d2 > 1
        i, j, k = self._bin(r0, 0), self._bin(r1, 1), self._bin(r2, 2)
        ncell = self.cell_ids.shape[0]
        found = torch.full(r0.shape, -1, dtype=torch.int32, device=r0.device)
        slab = torch.arange(self.max_slab, device=r0.device)
        # the third axis's centre and size only where the test reads them
        geo_cols = (frame.r0, frame.r1, frame.dr0, frame.dr1) + (
            (frame.r2, frame.dr2) if use_r2 else ())
        p0, p1, p2 = r0[:, None], r1[:, None], r2[:, None]
        offs = (-1, 0, 1)
        # neighbour order (dz, dy, dx) and the first hit in a bin, as JAX's
        # search: points on a seam (in_block's <=) resolve to the same cell
        for dz in (offs if use_r2 else (0,)):
            for dy in offs:
                for dx in offs:
                    ii = torch.clamp(i + dx, 0, d0 - 1)
                    jj = torch.clamp(j + dy, 0, d1 - 1)
                    kk = torch.clamp(k + dz, 0, d2 - 1)
                    flat = (kk * d1 + jj) * d0 + ii
                    start = self.bin_start[flat].to(torch.int64)
                    count = self.bin_count[flat].to(torch.int64)
                    gidx = torch.clamp(start[:, None] + slab, 0, ncell - 1)
                    cand = self.cell_ids[gidx].to(torch.int64)
                    c0, c1, s0, s1, *third = (col[cand] for col in geo_cols)
                    c2, s2 = third or (None, None)
                    ok = geo.in_block(p0, p1, p2, c0, c1, c2, s0, s1, s2, use_r2=use_r2)
                    ok = ok & (slab < count[:, None])
                    hit = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)
                    cand_hit = torch.gather(cand, 1, hit)[:, 0].to(torch.int32)
                    found = torch.where((found < 0) & ok.any(dim=-1), cand_hit, found)
        return found

    def find(self, r0, r1, r2, frame: HydroFrame) -> torch.Tensor:
        """Containing cell (int32, -1 where no cell holds the point) of 1-D
        hydro coordinates: an AABB test over the cells of the point's +-1
        bin neighbourhood (JAX's ``BinnedIndex.find``).  CPU tensors run the
        plain version, :meth:`find_reference`; CUDA tensors launch the
        hand-written kernel of ``csrc/binned_search.cu`` once
        (``ops.binned_search``), which gives its cells bit for bit."""
        if r0.device.type == "cpu":
            return self.find_reference(r0, r1, r2, frame)
        return binned_search(self, r0, r1, r2, frame)

    def find_reference(self, r0, r1, r2, frame: HydroFrame) -> torch.Tensor:
        """:meth:`find` as torch ops on any device, the search kernel's plain
        version: in chunks of lanes so that the (lanes, max_slab) candidate
        slabs hold at most :data:`SEARCH_BUDGET_BYTES`."""
        chunk = max(1, SEARCH_BUDGET_BYTES // (_SEARCH_BYTES_PER_CANDIDATE * self.max_slab))
        n = r0.shape[0]
        telemetry.count("grid.search_chunks", max(1, -(-n // chunk)))
        telemetry.count("grid.search_candidates",
                        n * (27 if self.dims[2] > 1 else 9) * self.max_slab)
        if n <= chunk:
            return self._find_chunk(r0, r1, r2, frame)
        return torch.cat([self._find_chunk(r0[a:a + chunk], r1[a:a + chunk], r2[a:a + chunk],
                                           frame) for a in range(0, n, chunk)])

    def search_tables(self, frame: HydroFrame, lane_dtype: torch.dtype) -> tuple:
        """The search kernel's tables for lanes of ``lane_dtype`` on
        ``frame``: the geometry rows in bin order, (Ncell, 4) ``[c0, c1, s0,
        s1]`` or, with more than one bin along axis 2, (Ncell, 8) ``[c0, c1,
        s0, s1, c2, s2, 0, 0]``, in the dtype the plain version tests in (the
        promotion of the lanes' and the frame's), and ``grid_min`` and
        ``inv_bin`` in ``lane_dtype``, the dtype the plain version bins in.
        Built with no host sync and kept for the last frame and dtype
        searched, so an index searched frame after frame builds them once;
        the frame's columns are held meanwhile, and an in-place write to
        one of them builds them anew."""
        cols = (frame.r0, frame.r1, frame.dr0, frame.dr1) + (
            (frame.r2, frame.dr2) if self.dims[2] > 1 else ())
        if any(c.dtype != cols[0].dtype for c in cols):
            raise ValueError("the search kernel takes a frame whose columns share one dtype")
        key = (lane_dtype,) + tuple((id(c), c._version) for c in cols)
        if self._tables is None or self._tables[0] != key:
            test_dtype = torch.promote_types(lane_dtype, cols[0].dtype)
            rows = torch.stack(cols, dim=1).to(test_dtype)[self.cell_ids.to(torch.int64)]
            if rows.shape[1] == 6:
                rows = torch.nn.functional.pad(rows, (0, 2))
            self._tables = (key, cols, (rows.contiguous(), self.grid_min.to(lane_dtype),
                                        self.inv_bin.to(lane_dtype)))
        return self._tables[2]


def build_binned_index(host: HydroFrameHost, target_bins: int = 1 << 20,
                       device=None) -> BinnedIndex:
    """Host-side construction of a :class:`BinnedIndex` (counting sort and
    prefix sums, mcrat_tpu.grid.build_binned_index), on ``device`` (default:
    the card).  Bin sizes are floored at the largest cell size per axis, so
    the +-1 neighbourhood cannot miss a containing cell.  The sort is the
    stable one of the JAX package's host runtime (native/mcrat_native.cpp),
    in numpy: ``cell_ids``, ``bin_start``, ``bin_count`` and ``dims`` equal
    the JAX package's.

    ``max_slab`` is the fullest bin's count, uncapped: the search tests
    every cell of a bin (its lane chunks shrink as ``max_slab`` grows).  The
    JAX package caps it at 512 and so never finds the cells past the 512th
    of a fuller bin, as in a frame refined 32-fold beside a coarse block
    (ROADMAP fault F8); below the cap the two are equal."""
    device = resolve_device(device)
    cfg = host.cfg
    use_r2 = cfg.dims is Dims.THREE
    lo = np.array([
        (host.r0 - host.dr0 / 2).min(),
        (host.r1 - host.dr1 / 2).min(),
        (host.r2 - host.dr2 / 2).min() if use_r2 else 0.0,
    ])
    hi = np.array([
        (host.r0 + host.dr0 / 2).max(),
        (host.r1 + host.dr1 / 2).max(),
        (host.r2 + host.dr2 / 2).max() if use_r2 else 1.0,
    ])
    span = np.maximum(hi - lo, 1e-300)
    max_cell = np.array([host.dr0.max(), host.dr1.max(), host.dr2.max() if use_r2 else span[2]])
    ndim = 3 if use_r2 else 2
    per_axis = max(1, int(round(target_bins ** (1.0 / ndim))))
    bin_size = np.maximum(span / per_axis, max_cell)
    dims = np.maximum((span / bin_size).astype(int), 1)
    if not use_r2:
        dims[2] = 1
        bin_size[2] = span[2]
    inv_bin = 1.0 / bin_size
    # stable counting sort by flat bin id
    i = np.clip(((host.r0 - lo[0]) * inv_bin[0]).astype(np.int64), 0, dims[0] - 1)
    j = np.clip(((host.r1 - lo[1]) * inv_bin[1]).astype(np.int64), 0, dims[1] - 1)
    k = (np.clip(((host.r2 - lo[2]) * inv_bin[2]).astype(np.int64), 0, dims[2] - 1)
         if dims[2] > 1 else np.zeros(host.num_elements, np.int64))
    flat = (k * dims[1] + j) * dims[0] + i
    order = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=int(dims.prod())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    dt = torch_dtype(cfg)
    return BinnedIndex(
        cell_ids=torch.as_tensor(order, device=device),
        bin_start=torch.as_tensor(starts, device=device),
        bin_count=torch.as_tensor(counts, device=device),
        grid_min=torch.as_tensor(lo, dtype=dt, device=device),
        inv_bin=torch.as_tensor(inv_bin, dtype=dt, device=device),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        max_slab=int(max(counts.max(), 1)),
    )


def _hydro_inside(cfg: Config, frame: HydroFrame, pos):
    """Hydro coordinates of (N, 3) MCRaT positions and the strict domain test."""
    r0, r1, r2 = geo.mcrat_to_hydro(cfg, pos[..., 0], pos[..., 1], pos[..., 2])
    dom = frame.domain
    inside = (r0 > dom[0, 0]) & (r0 < dom[0, 1]) & (r1 > dom[1, 0]) & (r1 < dom[1, 1])
    if cfg.dims is Dims.THREE:
        inside = inside & (r2 > dom[2, 0]) & (r2 < dom[2, 1])
    return r0, r1, r2, inside


def gather_rows(frame: HydroFrame, cell) -> torch.Tensor:
    """The packed rows (W, N) of the cells ``cell`` (clipped to a valid
    index; mcrat_tpu.grid.gather_rows)."""
    safe = torch.clamp(cell, 0, frame.num_elements - 1).to(torch.int64)
    return frame.packed[:, safe]


def find_cell_rows(cfg: Config, index, frame: HydroFrame, pos, cached, all_lanes=False):
    """Containing-cell lookup behind the cached-cell pin
    (mcrat_tpu.grid.find_cell_rows and find_cell, findContainingHydroCell,
    reference: Src/mclib.c:436-615): a photon still inside its cached cell's
    box keeps it (this also pins the choice on overlapping seams); the index
    searches the others.  Out-of-domain photons get -1.

    The index searches only the lanes that left their cell (one host sync
    for their count), or with ``all_lanes`` every lane, with no sync: the
    XLA engine's choice, whose round would otherwise sync once more.  JAX's
    find_cell guards the search with ``lax.cond`` on any lane needing it,
    and JAX's own measurement found the unconditional search faster in both
    regimes (mcrat_tpu/grid.py:542-546); either way the cells are the same.

    The JAX package carries each lane's (16, N) packed rows beside its cell;
    the port's kernel reads a cell's rows by its index, and on every in-grid
    lane JAX's carried rows equal ``frame.packed[:, cell]``, so only the cell
    is carried.  Works on either index.  ``pos`` is (N, 3) MCRaT Cartesian,
    ``cached`` (N,) int32.  Returns (cell int32, in_grid bool)."""
    r0, r1, r2, inside = _hydro_inside(cfg, frame, pos)
    safe = torch.clamp(cached, 0, frame.num_elements - 1).to(torch.int64)
    in_cached = (cached >= 0) & geo.in_block(
        r0, r1, r2, frame.r0[safe], frame.r1[safe], frame.r2[safe],
        frame.dr0[safe], frame.dr1[safe], frame.dr2[safe], use_r2=cfg.dims is Dims.THREE)

    def search(*r):
        telemetry.count("grid.search_lanes", r[0].numel())
        with telemetry.span("grid.search"):
            found = index.find(*r, frame) if isinstance(index, BinnedIndex) else index.find(*r)
        return found.to(torch.int32)

    if all_lanes:
        cell = torch.where(in_cached, cached.to(torch.int32), search(r0, r1, r2))
    else:
        cell = torch.where(in_cached, cached.to(torch.int32), -1)
        with telemetry.span("grid.miss_count"):
            miss = torch.nonzero(~in_cached & inside).flatten()
        if miss.numel():
            cell[miss] = search(r0[miss], r1[miss], r2[miss])
    cell = torch.where(inside, cell, -1)
    return cell, inside & (cell >= 0)


def find_cell_direct(cfg: Config, index: RectilinearIndex, frame: HydroFrame, pos):
    """Containing-cell lookup for the rectilinear index.

    findContainingHydroCell (reference: Src/mclib.c:436-615): out-of-domain
    photons get cell = -1.  ``pos`` is (N, 3) MCRaT Cartesian.  Returns
    (cell int32, in_grid bool).  CPU tensors run the plain version,
    :func:`find_cell_direct_reference`; CUDA tensors launch the hand-written
    kernel of ``csrc/direct_lookup.cu`` once (``ops.direct_lookup``), which
    gives its cells bit for bit.
    """
    telemetry.count("grid.lookup_lanes", pos.shape[0])
    if pos.device.type == "cpu":
        return find_cell_direct_reference(cfg, index, frame, pos)
    return direct_lookup(cfg, index, frame, pos)


def find_cell_direct_reference(cfg: Config, index: RectilinearIndex, frame: HydroFrame, pos):
    """:func:`find_cell_direct` as torch ops on any device, the direct
    lookup kernel's plain version."""
    r0, r1, r2, inside = _hydro_inside(cfg, frame, pos)
    cell = torch.where(inside, index.find(r0, r1, r2), -1).to(torch.int32)
    return cell, inside & (cell >= 0)
