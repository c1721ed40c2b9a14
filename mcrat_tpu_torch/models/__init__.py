"""Analytic outflow models (port of ``mcrat_tpu.models``)."""
from .analytic import (  # noqa: F401
    amr_blocks_2d,
    apply_simulation_type,
    cylindrical_prep,
    make_grid_2d,
    spherical_prep,
    structured_fireball_prep,
    synthetic_spherical_frame,
)
