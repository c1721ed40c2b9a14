"""Physical constants in cgs units, as MCRaT defines them (Src/mclib.c:4-5).

Frozen copy of the values in ``mcrat_tpu_torch/constants.py:7-41`` that the
reference reads.
"""

C_LIGHT = 2.99792458e10  # speed of light [cm/s]
K_B = 1.380658e-16  # Boltzmann constant [erg/K]
M_P = 1.6726231e-24  # proton mass [g]
THOM_X_SECT = 6.65246e-25  # Thomson cross section [cm^2]
M_EL = 9.1093879e-28  # electron mass [g]
ME_C2 = M_EL * C_LIGHT * C_LIGHT  # electron rest energy [erg]
KB_OVER_MEC2 = K_B / ME_C2  # k_B T / (m_e c^2) per kelvin
