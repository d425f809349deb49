"""Contact generation of one candidate row: the poly-poly branch of
``lpe_tpu/systems/rigid/pipeline.py`` ``_pair_contacts``, batched over
rows. The rest of the list pipeline (broadphase, solvers, the circle
single-contact cases) is ROADMAP.md Queue 1 item 5."""
from __future__ import annotations

from . import geometry as geo


def _pair_contacts(sa, sb, normal, pen, max_contacts):
    """Poly-poly manifold of each row (narrowphase.cpp:352-420): returns
    (points [N, C, 2], penetrations [N, C], valid [N, C]). ``pen`` is
    unused by polygons, as in lpe_tpu; only ``max_contacts == 2`` is
    ported."""
    del pen
    if max_contacts != 2:
        raise NotImplementedError(
            "contact manifolds other than 2 points are not ported yet "
            "(ROADMAP.md Queue 1 item 5)")
    return geo.polygon_contacts(sa, sb, normal, max_contacts)
