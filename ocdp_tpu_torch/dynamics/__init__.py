"""Plant dynamics of the rollouts: orbital mechanics and relative motion."""

from .orbital import (
    MU_EARTH,
    kepler_universal,
    lagrange_f_g,
    lagrange_fdot_gdot,
    propagate_kepler,
    stumpff_C,
    stumpff_S,
    sv_from_coe,
    target_orbit_R0V0,
)
from .relmotion import cw_relative_rates, target_states

__all__ = [
    "MU_EARTH",
    "stumpff_C",
    "stumpff_S",
    "kepler_universal",
    "lagrange_f_g",
    "lagrange_fdot_gdot",
    "propagate_kepler",
    "sv_from_coe",
    "target_orbit_R0V0",
    "cw_relative_rates",
    "target_states",
]
