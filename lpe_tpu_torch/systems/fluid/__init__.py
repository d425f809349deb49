"""SPH fluid system (implemented in sph.py; wired here)."""
from __future__ import annotations


def make_fluid(spec, cfg, *, device, mesh=None):
    if spec.n_liquid == 0:
        return None
    from .sph import make_fluid_system
    return make_fluid_system(spec, cfg, device=device, mesh=mesh)
