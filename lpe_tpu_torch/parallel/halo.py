"""Density over row-banded grids with a one-row halo exchange.

The counterpart of ``lpe_tpu/parallel/halo.py``: the standalone building
block of the row-band fluid (the whole band tick is
``systems/fluid/sph.py``'s band step). Each band's rows live on their own
device; the bands exchange one edge row with each neighbour, O(nx K) bytes
whatever the particle count, and each band runs the density kernel
(``ops.sph_kernels.density``: the CUDA kernel on a card, its plain version
on the CPU) on its block padded with those halo rows.
"""
from __future__ import annotations

import math

import torch

from ..ops import sph_kernels as SK


def make_halo_density(ny: int, nx: int, K: int, h: float, mesh):
    """Returns ``density(x, y, m, occ) -> rho`` over row-banded dense grids.

    Each input is the list of the bands' fields ``[ny / D, K, nx + 2]`` (the
    x-apron columns included, no row apron), band i on
    ``mesh.devices[i]``; ``ny`` must divide evenly by the mesh's size D.
    The output is the list of the bands' rho in the same layout, 0 in the
    apron columns and in empty slots. The halo occupancy at the global
    edges is zero."""
    D = mesh.size
    if ny % D != 0:
        raise ValueError(f"ny={ny} not divisible by the mesh's {D} bands")
    band = ny // D
    poly6 = 4.0 / (math.pi * h ** 8)

    def density(x, y, m, occ):
        blocks = []
        for fields, dev in zip(zip(x, y, m, occ), mesh.devices):
            if any(f.shape != (band, K, nx + 2) for f in fields):
                raise ValueError(f"a band's fields must be "
                                 f"[{band}, {K}, {nx + 2}]")
            D4 = torch.stack([f.to(dev) for f in fields], dim=1)
            blocks.append(torch.nn.functional.pad(D4, (0, 0, 0, 0, 0, 0,
                                                       1, 1)))
        mesh.exchange(blocks)
        out = []
        for D4 in blocks:
            rho = SK.density(D4, h=h, poly6=poly6)
            rho[:, :, 0] = 0.0
            rho[:, :, -1] = 0.0
            out.append(rho)
        return out

    return density
