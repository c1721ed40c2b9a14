"""Distribution layer: one rank's photon axis sharded over a mesh of devices
and processes (port of ``mcrat_tpu.parallel``).

The reference distributes work with MPI over viewing-angle bins x injection
frames, plus OpenMP threads within a rank; photons never migrate between
ranks (SURVEY.md section 2.6).  Here, as in the JAX package, one rank's
photon population is split into equal slabs, one per shard of a
:class:`~mcrat_tpu_torch.parallel.mesh.Mesh`; the hydro frame and the
spatial index are replicated; each shard transports its slab alone and the
statistics ride one collective a chunk (``torch.distributed``: NCCL between
cards, gloo between CPU processes).
"""

from .mesh import (  # noqa: F401
    Mesh,
    Sharded,
    fetch_global,
    init_distributed,
    make_mesh,
    pad_capacity,
    replicate,
    shard_photons,
    sharded_transport_frame,
    shutdown_distributed,
    spread_photons,
)
