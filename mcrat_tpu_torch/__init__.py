"""mcrat_tpu_torch: the PyTorch/CUDA port of mcrat_tpu.

A second package beside the JAX reference ``mcrat_tpu``.  It runs
``transport.inject_photons`` -> ``photons_from_arrays`` -> ``transport_frame``
on any (dims x geometry) frame with a rectilinear grid -- 2-D and 2.5-D
cartesian/cylindrical/spherical, 3-D cartesian/spherical/polar, uniform or
not -- with DIRECT (Thomson) optical depth, thermal electrons, float32, in
PyTorch, with the fused transport round as a hand-written CUDA kernel
(``ops/fused_round.py``, ``csrc/fused_round.cu``) on an NVIDIA H100.

Module names mirror ``mcrat_tpu`` so each counterpart is easy to find.  The
package imports torch and numpy and never jax; from the JAX package it takes
only the pure-Python ``config`` and ``constants`` modules.  Configurations
outside the slice raise ``NotImplementedError`` naming the ROADMAP item that
will port them.
"""

__version__ = "0.1.0"

from mcrat_tpu import constants  # noqa: F401
from mcrat_tpu.config import (  # noqa: F401
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
from mcrat_tpu.constants import (  # noqa: F401
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
