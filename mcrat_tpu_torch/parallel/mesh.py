"""Mesh construction and sharded transport (port of ``mcrat_tpu.parallel.mesh``).

A :class:`Mesh` is the port's counterpart of the JAX package's 1-D
``jax.sharding.Mesh`` over the photon ("batch") axis: ``n_shards`` shards
over every process, shard ``i`` owning the global lanes
``[i * cap / n, (i + 1) * cap / n)`` of a population of ``cap`` lanes.
Each process holds its own shards' slabs (:class:`Sharded`), each on its
shard's device; a device may repeat (``["cpu"] * 8`` in the tests,
``["cuda:0"] * 2`` on one card), as the JAX tests' virtual CPU devices.

:func:`sharded_transport_frame` runs ``transport.transport_frame``'s chunk
loop with the JAX package's hooks: each chunk every shard runs the
fused-round kernel (``transport_rounds_fused``; its plain twin on CPU
tensors) or the XLA engine (``transport_rounds``) on its slab alone, with
the replicated frame, index and tables; the shards' scatter counts, active
and scattered-CS counts, done flags and round counts are summed over the
process's shards and then over the processes in ONE collective, inside the
chunk's one host fetch.  Shards never exchange photons inside a chunk.  A
compaction gathers the working set in global lane order (the active lanes
at the first, the whole compacted working set after), compacts it on every
process alike and keeps each process's slabs; the frame's end writes the
working set back into the slabs that own its lanes.

Several processes: :func:`init_distributed` (``torch.distributed`` over
``tcp://coordinator``; NCCL for cards, gloo for CPU processes) before
:func:`make_mesh`, then every process runs the same driver: each draws the
same random numbers (the seeds or keys of every shard, the injection), so
every decision of the host loop is made on the same globally reduced values
on every process, and only process 0 writes files.  Cross-process fetches
(:func:`fetch_global`, the persistence and compaction gathers) are
collectives: every process makes them at the same point.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import transport as tr
from ..config import Config
from ..ops import fused_round as fr
from ..ops.prng import Key

# the backend of each device type; nothing picks another by itself
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None, timeout_s: float = 300.0) -> int:
    """Join the processes of a mesh (the MPI_Init analogue, Src/mcrat.c:93-95):
    ``torch.distributed.init_process_group`` over ``tcp://coordinator``
    (``host:port``, process 0 listens there) with ``num_processes`` processes,
    this one ``process_id``.  ``device`` is the device this process drives
    first: a card is made current before the group starts, and the backend
    is NCCL for a card and gloo for the CPU unless ``backend`` says
    otherwise (``"gloo"`` lets two processes share one card, which NCCL
    refuses).  A collective that waits longer than ``timeout_s`` raises.
    Without a coordinator this is one process and a no-op.  Returns this
    process's index."""
    if coordinator is None:
        if (num_processes or 1) > 1:
            raise ValueError(f"{num_processes} processes need a coordinator host:port")
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or BACKENDS[device.type], init_method=f"tcp://{coordinator}",
        world_size=num_processes or 1, rank=process_id or 0,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class Mesh:
    """A 1-D mesh over the photon axis: this process's shard ``devices`` in
    global shard order (the process's shards are ``first .. first +
    len(devices) - 1`` of ``n_shards``), and whether processes share it
    (``distributed``: the default ``torch.distributed`` group).
    ``launches`` counts the fused-round kernel's launches by global shard,
    read from the wrapper's own count around each shard's call."""

    devices: tuple
    n_shards: int
    first: int = 0
    distributed: bool = False
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def process_index(self) -> int:
        return dist.get_rank() if self.distributed else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if self.distributed else 1

    @property
    def comm_device(self) -> torch.device:
        """Where this process's collectives run: its first device, or the
        CPU under gloo (gloo has no all_gather of CUDA tensors, so the
        values it exchanges are staged through host tensors)."""
        if self.distributed and dist.get_backend() == "gloo":
            return torch.device("cpu")
        return self.devices[0]


def local_devices(n_devices: Optional[int] = None, device_type: str = "cuda",
                  num_processes: int = 1, process_id: int = 0) -> list:
    """The devices of process ``process_id`` in a mesh of ``n_devices``
    shards over ``num_processes`` processes (None or -1: every card of
    every process), one distinct card a shard: with ``k`` shards a
    process, process ``p`` takes cards ``p * k .. p * k + k - 1`` (modulo
    the cards it sees), so processes on one node take distinct cards and
    processes on several nodes the same ones.  Fewer cards than that
    raises; ``device_type="cpu"`` gives one CPU shard a process."""
    if n_devices not in (None, -1) and (n_devices < 1 or n_devices % num_processes):
        raise ValueError(f"a mesh of {n_devices} shards over {num_processes} processes")
    if device_type == "cpu":
        if n_devices not in (None, -1, num_processes):
            raise ValueError(f"a CPU process holds one shard: a mesh of {n_devices} needs "
                             f"{n_devices} processes, not {num_processes}")
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh of cards: torch sees no CUDA device")
    count = torch.cuda.device_count()
    k = count if n_devices in (None, -1) else n_devices // num_processes
    if k > count:
        raise ValueError(f"a mesh of {k * num_processes} shards over {num_processes} "
                         f"processes needs {k} cards a process; torch sees {count}")
    return [torch.device("cuda", (process_id * k + j) % count) for j in range(k)]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> Mesh:
    """A mesh over this process's ``devices`` (a list, repeats allowed), or
    over its :func:`local_devices` share of ``n_devices`` shards.  Every
    process of a ``torch.distributed`` group makes the same call after
    :func:`init_distributed` and must hold as many shards."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        devices = local_devices(n_devices, device_type, world, rank)
    devices = tuple(torch.device(d) for d in devices)
    mesh = Mesh(devices, len(devices) * world, rank * len(devices), dist.is_initialized())
    counts = _all_gather(mesh, torch.tensor([mesh.n_local], device=mesh.comm_device))
    if (counts != mesh.n_local).any():
        raise ValueError(f"every process must hold as many shards: {counts.flatten().tolist()}")
    return mesh


def pad_capacity(n: int, n_shards: int, factor: float = 1.0) -> int:
    """Round capacity up so each shard gets an equal, nonzero slab."""
    cap = max(int(np.ceil(n * factor)), n_shards)
    return int(np.ceil(cap / n_shards) * n_shards)


@dataclasses.dataclass
class Sharded:
    """This process's slabs (``parts``, one per local shard, each on its
    shard's device) of a population (``transport.Photons``) or a per-lane
    tensor whose leading axis is sharded over ``mesh``."""

    mesh: Mesh
    parts: list

    @property
    def slab(self) -> int:
        first = self.parts[0]
        return first.capacity if isinstance(first, tr.Photons) else first.shape[0]

    @property
    def capacity(self) -> int:
        """The global lane count."""
        return self.slab * self.mesh.n_shards

    def lo(self, i: int) -> int:
        """The first global lane of local shard ``i``."""
        return (self.mesh.first + i) * self.slab


def _to(x, device):
    """``x`` (a tensor, a dataclass of tensors, a list, a numpy array, None)
    on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def replicate(x, mesh: Mesh) -> list:
    """``x`` on every local shard's device, one entry a shard (a hydro frame,
    an index, photons, host arrays; one copy a distinct device; host
    tables and None as they are).  Every process must hold the same value:
    the driver's host-side emission and injection draw the same random
    numbers on every process (JAX's ``put_replicated``)."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _to(x, dev)
    return [copies[dev] for dev in mesh.devices]


put_replicated = replicate


def shard_photons(x, mesh: Mesh) -> Sharded:
    """This process's slabs of ``x`` (``transport.Photons`` or a per-lane
    tensor, the same global value on every process), each copied to its
    shard's device.  The capacity must divide into equal slabs
    (:func:`pad_capacity`)."""
    cap = x.capacity if isinstance(x, tr.Photons) else x.shape[0]
    if cap % mesh.n_shards:
        raise ValueError(f"photon capacity {cap} not divisible by mesh size {mesh.n_shards}; "
                         "use pad_capacity()")
    s = cap // mesh.n_shards
    parts = []
    for i, dev in enumerate(mesh.devices):
        lo = (mesh.first + i) * s
        if isinstance(x, tr.Photons):
            parts.append(tr.Photons(**{k: v[lo:lo + s].to(dev, copy=True)
                                       for k, v in x.fields().items()}))
        else:
            parts.append(x[lo:lo + s].to(dev, copy=True))
    return Sharded(mesh, parts)


def spread_photons(photons: tr.Photons, mesh: Mesh, capacity: int = 0) -> Sharded:
    """The live photons of ``photons`` (the same population on every
    process) in equal runs, in order, at the start of each shard's slab:
    shard ``i`` takes the ``i``-th of ``n_shards`` near-equal runs of them,
    the rest of its slab NULL, in a population of ``pad_capacity(max(
    photons.capacity, capacity), n_shards)`` lanes.  The live lanes in
    global lane order are then the photons in their order.  (Sharding the
    population as it lies would leave the last shards empty: an injection
    fills the first 1 / capacity_factor of its power-of-two capacity.)"""
    n = mesh.n_shards
    slab = pad_capacity(max(photons.capacity, capacity), n) // n
    live = torch.nonzero(photons.alive).flatten()
    runs = np.array_split(np.arange(live.numel()), n)
    parts = []
    for i, dev in enumerate(mesh.devices):
        run = live[torch.as_tensor(runs[mesh.first + i], dtype=torch.int64,
                                   device=live.device)]
        part = tr.empty_photons(slab, photons.p.dtype, dev)
        for k, v in part.fields().items():
            v[:run.numel()] = getattr(photons, k)[run].to(dev)
        parts.append(part)
    return Sharded(mesh, parts)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (the same shape and dtype on each), stacked in
    process order: ``(processes, *t.shape)`` on the mesh's comm device.  A
    collective: every process calls it at the same point."""
    x = t.to(mesh.comm_device).contiguous()
    if not mesh.distributed:
        return x[None]
    out = [torch.empty_like(x) for _ in range(mesh.process_count)]
    dist.all_gather(out, x)
    return torch.stack(out)


def _shard_counts(sp: Sharded, masks: List[torch.Tensor]) -> List[int]:
    """Each global shard's count of ``masks`` (one a local shard): one
    collective and one host fetch."""
    local = torch.stack([m.sum().to(sp.mesh.comm_device) for m in masks])
    return _all_gather(sp.mesh, local).flatten().tolist()


# columns of a packed lane: p, comv_p, pos, s, weight, num_scatt, t_rem in the
# photons' dtype; cell, ptype, slot as int64
_FLOAT_COLS = ((("p", 4), ("comv_p", 4), ("pos", 3), ("s", 4), ("weight", 1),
                ("num_scatt", 1)))


def _pack(ph: tr.Photons, t: torch.Tensor, slots: torch.Tensor):
    f = torch.cat([ph.p, ph.comv_p, ph.pos, ph.s, ph.weight[:, None], ph.num_scatt[:, None],
                   t.to(ph.p.dtype)[:, None]], dim=1)
    i = torch.stack([ph.cell.to(torch.int64), ph.ptype.to(torch.int64), slots.to(torch.int64)],
                    dim=1)
    return f, i


def _unpack(f: torch.Tensor, i: torch.Tensor, t_dtype):
    cols, at = {}, 0
    for name, width in _FLOAT_COLS:
        cols[name] = f[:, at:at + width] if width > 1 else f[:, at]
        at += width
    ph = tr.Photons(**{k: v.contiguous() for k, v in cols.items()},
                    cell=i[:, 0].to(torch.int32), ptype=i[:, 1].to(torch.int32))
    return ph, f[:, at].to(t_dtype).contiguous(), i[:, 2].contiguous()


def gather_lanes(sp: Sharded, t: Optional[Sharded] = None, slots: Optional[Sharded] = None,
                 masks: Optional[List[torch.Tensor]] = None, device=None):
    """The lanes of ``sp`` where ``masks`` hold (one mask a local shard;
    None: every lane), over every process in global lane order, with their
    ``t`` (zeros without) and ``slots`` (each lane's global index without),
    on ``device`` (default: the first local device): (Photons, t, slots).
    Every process gets the same value.  A collective: one count fetch, then
    two all-gathers of the lanes, each shard's padded to the largest
    shard's count."""
    mesh = sp.mesh
    device = mesh.devices[0] if device is None else torch.device(device)
    counts = (None if masks is None else _shard_counts(sp, masks))
    m = sp.slab if counts is None else max(counts)
    fs, is_ = [], []
    for k, part in enumerate(sp.parts):
        tk = (t.parts[k] if t is not None else
              torch.zeros(part.capacity, dtype=part.p.dtype, device=part.device))
        sk = (slots.parts[k] if slots is not None else
              sp.lo(k) + torch.arange(part.capacity, dtype=torch.int64, device=part.device))
        f, i = _pack(part, tk, sk)
        if masks is not None:
            idx = torch.nonzero(masks[k]).flatten()
            f, i = f[idx], i[idx]
            pad = m - idx.numel()
            f = torch.cat([f, f.new_zeros((pad, f.shape[1]))])
            i = torch.cat([i, i.new_zeros((pad, i.shape[1]))])
        fs.append(f.to(mesh.comm_device))
        is_.append(i.to(mesh.comm_device))
    fg = _all_gather(mesh, torch.stack(fs)).reshape(mesh.n_shards, m, -1)
    ig = _all_gather(mesh, torch.stack(is_)).reshape(mesh.n_shards, m, -1)
    if counts is not None:
        fg = torch.cat([fg[k, :c] for k, c in enumerate(counts)])
        ig = torch.cat([ig[k, :c] for k, c in enumerate(counts)])
    t_dtype = t.parts[0].dtype if t is not None else sp.parts[0].p.dtype
    return _unpack(fg.reshape(-1, fg.shape[-1]).to(device),
                   ig.reshape(-1, ig.shape[-1]).to(device), t_dtype)


def fetch_global(x):
    """The global value of ``x`` on the CPU: a :class:`Sharded` population
    or tensor gathered over every process in lane order (a collective:
    every process calls it at the same point), anything else copied to the
    host."""
    if not isinstance(x, Sharded):
        return _to(x, "cpu")

    def gather(parts):
        local = torch.cat([p.to(x.mesh.comm_device) for p in parts])
        return _all_gather(x.mesh, local).reshape(-1, *local.shape[1:]).cpu()

    if isinstance(x.parts[0], tr.Photons):
        return tr.Photons(**{k: gather([getattr(p, k) for p in x.parts])
                             for k in x.parts[0].fields()})
    return gather(x.parts)


# ---------------------------------------------------------------------------
# The population on a mesh: the driver's operations between frames
# ---------------------------------------------------------------------------


def frame_stats(sp: Sharded, extra: Sequence[torch.Tensor] = ()) -> list:
    """``transport.frame_stats`` of the global population, as a list (one
    collective, one host fetch): the extremes and counts exact, the two
    means each shard's weighted by its live count.  ``extra`` holds one
    count a local shard, summed and appended."""
    rows = []
    for k, part in enumerate(sp.parts):
        row = tr.frame_stats(part).to(torch.float64)
        more = [extra[k].to(torch.float64)[None]] if extra else []
        rows.append(torch.cat([row, *more]).to(sp.mesh.comm_device))
    g = _all_gather(sp.mesh, torch.stack(rows)).reshape(sp.mesh.n_shards, -1).cpu().numpy()
    n_live = g[:, 9]
    total = max(n_live.sum(), 1.0)
    out = [g[:, 0].max(), g[:, 1].min(), (g[:, 2] * n_live).sum() / total,
           (g[:, 3] * n_live).sum() / total, g[:, 4].min(), g[:, 5].max(), g[:, 6].min(),
           g[:, 7].max(), g[:, 8].sum(), n_live.sum(), g[:, 10].sum()]
    if extra:
        out.append(g[:, 11].sum())
    return [float(v) for v in out]


def grow(sp: Sharded, new_cap: int, t_rem: Optional[Sharded] = None):
    """``transport.grow_photons`` on a mesh: ``new_cap`` (a multiple of the
    shard count) global lanes, each slab grown by its share of NULL lanes
    at its end, so no photon changes shard.  Returns (photons, t_rem or
    None)."""
    n = sp.mesh.n_shards
    if new_cap % n:
        raise ValueError(f"capacity {new_cap} not divisible by mesh size {n}")
    grown = [tr.grow_photons(p, new_cap // n, None if t_rem is None else t_rem.parts[k])
             for k, p in enumerate(sp.parts)]
    return (Sharded(sp.mesh, [g[0] for g in grown]),
            None if t_rem is None else Sharded(sp.mesh, [g[1] for g in grown]))


def append_photons(sp: Sharded, new: tr.Photons, t_rem: Optional[Sharded] = None,
                   new_t: Optional[torch.Tensor] = None):
    """``transport.append_photons_device`` on a mesh: ``new``'s live lanes
    (the same value on every process) written into the global population's
    first free slots in ascending order; each shard takes the run of new
    lanes that its free slots hold.  One count collective.  Returns
    (photons, t_rem or None)."""
    free = _shard_counts(sp, [~p.alive for p in sp.parts])
    before = np.concatenate([[0], np.cumsum(free)])
    news = put_replicated(new, sp.mesh)
    nts = put_replicated(new_t, sp.mesh)
    parts, ts = [], []
    for k, part in enumerate(sp.parts):
        g = sp.mesh.first + k
        nk = news[k]
        rank = torch.cumsum(nk.alive.to(torch.int64), 0) - 1
        take = nk.alive & (rank >= int(before[g])) & (rank < int(before[g + 1]))
        # this shard's run of new lanes moved to the front, the rest dead
        sub, safe, _ = tr._gather_first(nk, take, nk.capacity)
        ph, tk = tr.append_photons_device(part, sub, None if t_rem is None else t_rem.parts[k],
                                          None if nts[k] is None else nts[k][safe])
        parts.append(ph)
        ts.append(tk)
    return Sharded(sp.mesh, parts), None if t_rem is None else Sharded(sp.mesh, ts)


def extract_cs_subset(sp: Sharded, n_out: int, t_rem: Optional[Sharded] = None):
    """``transport.extract_cs_subset`` on a mesh: the first ``n_out`` live
    scattered-CS lanes of the global population, nulled in it and gathered
    over every process in lane order (a collective).  Returns (population,
    the gathered photons, their t_rem or zeros)."""
    cs = [p.alive & ((p.ptype == int(tr.PhotonType.COMPTONIZED))
                     | (p.ptype == int(tr.PhotonType.UNABSORBED_CS))) for p in sp.parts]
    counts = _shard_counts(sp, cs)
    before = np.concatenate([[0], np.cumsum(counts)])
    parts, subs, sub_ts = [], [], []
    for k, part in enumerate(sp.parts):
        g = sp.mesh.first + k
        take = int(np.clip(n_out - before[g], 0, counts[g]))
        nulled, sub, sub_t = tr.extract_cs_subset(
            part, take, None if t_rem is None else t_rem.parts[k])
        parts.append(nulled)
        subs.append(sub)
        sub_ts.append(sub_t)
    got, got_t, _ = gather_lanes(Sharded(sp.mesh, subs), Sharded(sp.mesh, sub_ts),
                                 masks=[s.alive for s in subs])
    return Sharded(sp.mesh, parts), got, got_t


def gather_live(sp: Sharded, n_out: int) -> tr.Photons:
    """``transport.compact_live`` of the global population on the host: its
    live lanes in global lane order, then dead pad lanes to ``n_out`` (the
    persistence subset; a collective, run on the main thread)."""
    ph = gather_lanes(sp, masks=[p.alive for p in sp.parts], device="cpu")[0]
    n = ph.capacity
    if n_out <= n:
        return ph
    pad = tr.empty_photons(n_out - n, ph.p.dtype, "cpu")
    return tr.Photons(**{k: torch.cat([v, getattr(pad, k)]) for k, v in ph.fields().items()})


# ---------------------------------------------------------------------------
# The sharded frame
# ---------------------------------------------------------------------------


def _reduce_chunk(mesh: Mesh, results: list) -> torch.Tensor:
    """The shards' chunk results summed over the process's shards, then over
    every process in one collective: [n_scatt, n_active, n_cs, shards done,
    max n_rounds] (int64, on the comm device; no host fetch)."""
    dev = mesh.devices[0]
    vec = torch.stack([
        sum(r.n_scatt.to(dev, torch.int64) for r in results),
        sum(r.n_active.to(dev, torch.int64) for r in results),
        sum(tr._count_cs(r.photons).to(dev, torch.int64) for r in results),
        sum(r.all_done.to(dev, torch.int64) for r in results),
        torch.tensor(max(r.n_rounds for r in results), dtype=torch.int64, device=dev),
    ])
    rows = _all_gather(mesh, vec)
    return torch.cat([rows[:, :4].sum(0), rows[:, 4:].amax(0)])


def _write_back_local(result: Sharded, slots: torch.Tensor, ph: tr.Photons,
                      t: Optional[torch.Tensor] = None, result_t: Optional[list] = None):
    """Write gathered working lanes into the slabs of ``result`` that own
    their ``slots`` (in place); ``t`` into ``result_t``'s slabs alike."""
    s = result.slab
    for k, part in enumerate(result.parts):
        lo = result.lo(k)
        keep = (slots >= lo) & (slots < lo + s)
        at = (slots[keep] - lo).to(part.device)
        for name, v in part.fields().items():
            v[at] = getattr(ph, name)[keep].to(v.device)
        if result_t is not None:
            result_t[k][at] = t[keep].to(result_t[k].device)


def _compact_sharded(result: Sharded, slots: Optional[Sharded], work: Sharded,
                     work_t: Sharded, new_cap: int):
    """``transport._compact_step`` on a mesh (JAX's ``_compact_step_sharded``):
    the working set gathered in global lane order (the first compaction,
    where the working set is the population, gathers its active lanes
    alone), written back into the population's slabs, its active lanes
    compacted into ``pad_capacity(new_cap, n)`` lanes on every process
    alike, in equal slabs."""
    mesh = work.mesh
    new_cap = pad_capacity(new_cap, mesh.n_shards)
    if slots is None:
        masks = [p.alive & (t > 0) for p, t in zip(work.parts, work_t.parts)]
        ph, t, sl = gather_lanes(work, work_t, masks=masks)
    else:
        ph, t, sl = gather_lanes(work, work_t, slots)
        _write_back_local(result, sl, ph)
    sub, sub_t, sub_slots = tr._gather_active(ph, t, sl, new_cap, result.capacity)
    return (result, shard_photons(sub, mesh), shard_photons(sub_t, mesh),
            shard_photons(sub_slots, mesh))


def _finish_sharded(result: Sharded, slots: Sharded, work: Sharded, work_t: Sharded):
    """``transport._write_back`` on a mesh: the compacted working set
    gathered and written into the slabs that own its lanes, with each
    slab's frame time left."""
    ph, t, sl = gather_lanes(work, work_t, slots)
    result_t = [torch.zeros(p.capacity, dtype=t.dtype, device=p.device) for p in result.parts]
    _write_back_local(result, sl, ph, t, result_t)
    return result, Sharded(result.mesh, result_t)


def sharded_transport_frame(
    cfg: Config,
    mesh: Mesh,
    photons,
    frame,
    index,
    dt_max,
    generator: Optional[torch.Generator] = None,
    stokes_on: bool = True,
    chunk_rounds: int = 64,
    fused: Optional[bool] = None,
    s_rows: int = 128,
    rounds_fn=fr.fused_rounds,
    xsec_table=None,
    t_rem0: Optional[Sharded] = None,
    cs_limit: Optional[int] = None,
    key: Optional[Key] = None,
    inner_rounds: int = 4,
) -> tr.FrameResult:
    """Transport one hydro frame with the photon axis sharded over ``mesh``
    (the mesh twin of ``transport.transport_frame``, whose arguments it
    takes): ``photons`` a :class:`Sharded` population (or a population of
    the same value on every process, sharded here), ``frame`` and ``index``
    replicated to the shards' devices here.

    The engine is ``transport.frame_engine``'s, chosen on shard 0's slab
    (the kernel's setup built once a device).  The kernel's chunks
    each draw ``n_shards`` seeds from ``generator`` in global shard order,
    shard ``i`` taking seed ``i`` (every process draws all of them, so the
    generators stay in step; a one-shard mesh draws what
    ``transport_frame`` draws); the XLA engine splits the chunk's key
    ``n_shards`` ways, shard ``i`` taking key ``i`` (JAX's
    ``jax.random.split(sub, n_shards)``).  The capacity must divide into
    equal slabs (ValueError otherwise).  The result's ``photons`` and
    ``t_rem`` are :class:`Sharded`.

    Results differ across mesh sizes, as the JAX package's: each shard
    draws its own stream, so a photon's draws depend on the shard
    boundaries; a fixed mesh is bit-reproducible.
    """
    n = mesh.n_shards
    if not isinstance(photons, Sharded):
        photons = shard_photons(photons, mesh)
    sites = list(zip(mesh.devices, replicate(frame, mesh), replicate(index, mesh)))
    if t_rem0 is None:
        t_rem0 = Sharded(mesh, [tr.frame_time(p, dt_max) for p in photons.parts])

    def step(eng: tr.FrameEngine, work: Sharded, work_t: Sharded,
             sub: Optional[Key]) -> tr.ChunkResult:
        draws = [tr.draw_seed(generator) for _ in range(n)] if eng.fused else sub.split(n)
        results = []
        for i, (ph, t) in enumerate(zip(work.parts, work_t.parts)):
            g = mesh.first + i
            with tr.device_scope(mesh.devices[i]):
                before = fr.fused_rounds.launches
                results.append(eng.step(i, ph, t, draws[g], stokes_on=stokes_on,
                                        max_rounds=chunk_rounds, inner_rounds=inner_rounds,
                                        s_rows=s_rows, rounds_fn=rounds_fn))
                if eng.fused:
                    mesh.launches[g] += fr.fused_rounds.launches - before
        red = _reduce_chunk(mesh, results)
        # the process's own shards' searched lanes, for its counter
        searched = [r.n_searched.to(red.device) for r in results if r.n_searched is not None]
        return tr.ChunkResult(
            photons=Sharded(mesh, [r.photons for r in results]),
            t_rem=Sharded(mesh, [r.t_rem for r in results]),
            n_scatt=red[0], n_rounds=red[4], all_done=red[3] == n, n_active=red[1],
            n_cs=red[2], n_searched=sum(searched) if searched else None)

    return tr.transport_frame(
        cfg, photons, None, None, dt_max, generator, stokes_on=stokes_on,
        chunk_rounds=chunk_rounds, fused=fused, xsec_table=xsec_table, t_rem0=t_rem0,
        cs_limit=cs_limit, key=key, min_compact_capacity=max(tr.MIN_COMPACT_CAPACITY, n * 128),
        shards=tr.Shards(sites, step, _compact_sharded, _finish_sharded))
