"""mcrat_tpu_torch: the PyTorch/CUDA port of mcrat_tpu.

A second package beside the JAX reference ``mcrat_tpu``.  Users run it as
``python -m mcrat_tpu_torch.cli run --mcpar mc.par ...`` (``driver.run_rank``:
inject -> ``transport_frame`` per hydro frame -> checkpoint -> per-rank
photon dump -> merge; ``analysis`` reads the merged frames).  It runs
``transport.inject_photons`` -> ``photons_from_arrays`` -> ``transport_frame``
on any (dims x geometry) frame, on a rectilinear grid or on an AMR cell list
(``grid.BinnedIndex``, ``io.flash.cells_from_blocks``), with DIRECT (Thomson)
or TABLE (hot cross-section) optical depth, thermal and nonthermal
electrons, cyclo-synchrotron pool photons, float32, in PyTorch, with the fused transport round as a
hand-written CUDA kernel (``ops/fused_round.py``, ``csrc/fused_round.cu``)
on an NVIDIA H100; float64 runs take the XLA engine (``transport_rounds``);
one rank's photon axis shards over a mesh of devices and processes
(``parallel``); ``serial`` holds the reference-ordered oracle.  Entry points
put their tensors on ``DEFAULT_DEVICE`` ("cuda") unless the caller passes
``device=``; without a card they raise.

Module names mirror ``mcrat_tpu`` so each counterpart is easy to find.  The
package imports torch and numpy and nothing of the JAX package: it keeps its
own ``config`` and ``constants``.  A frame no index or geometry of the JAX
package describes raises ``NotImplementedError``.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .config import (  # noqa: F401
    PHOTON_CHAR_TYPES,
    PHOTON_TYPE_CHARS,
    BFieldCalc,
    Config,
    Dims,
    Geometry,
    HydroSim,
    McPar,
    NonthermalDist,
    PhotonType,
    SimType,
    Spectrum,
    TauCalculation,
)
from .constants import (  # noqa: F401
    A_RAD,
    C_LIGHT,
    H_OVER_MEC2,
    K_B,
    KB_OVER_MEC2,
    M_EL,
    M_P,
    ME_C,
    ME_C2,
    PL_CONST,
    THOM_X_SECT,
)
from .device import DEFAULT_DEVICE, resolve_device  # noqa: F401
from .driver import (  # noqa: F401
    WorkAssignment,
    decompose_work,
    default_synthetic_factory,
    merge_rank_outputs,
    run_elastic,
    run_rank,
)
from .io.hydro import HydroPaths  # noqa: F401
from .io.mcpar import read_mcpar, write_mcpar  # noqa: F401
