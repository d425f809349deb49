"""Row-band meshes: the devices of the multi-device fluid.

The counterpart of ``lpe_tpu/parallel/sharded.py`` ``make_mesh`` and of the
halo exchange of ``lpe_tpu/systems/fluid/sph.py`` step_halo (``_exch``,
:1733-1743). ``lpe_tpu`` runs one process over a list of devices
(``shard_map``); so does this package: band ``i`` of the fluid grid lives on
``mesh.devices[i]``, and the exchange between bands is copies between
their tensors, slice copies where two bands share a device and peer copies
between cards. There is no ``torch.distributed`` path: ``lpe_tpu`` has no
multi-process feature, and NCCL refuses two ranks on one card.
"""
from __future__ import annotations

import torch


class BandMesh:
    """An ordered list of devices, one a band; ``devices[0]`` leads (the
    state and every system but the fluid's bands live there)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.size = len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"BandMesh({[str(d) for d in self.devices]})"

    def exchange(self, blocks, planes=slice(None)):
        """Refresh the halo rows of the band blocks ``blocks`` (one a band,
        in band order, each ``[rows, F, K, cols]`` on its band's device)
        in place, for the planes ``planes``: band i's row 0 takes band
        i-1's last interior row and its row -1 band i+1's first. A block's
        planes are stacked, so a direction of a band pair is one copy. The
        halo rows at the global edges are the grid's apron rows, which
        every producer of a block writes as zeros; they are left as
        they are. One band: nothing to do. Returns the number of bytes
        copied."""
        moved = 0
        for i in range(1, len(blocks)):
            lo, hi = blocks[i - 1], blocks[i]
            hi[0, planes].copy_(lo[-2, planes], non_blocking=True)
            lo[-1, planes].copy_(hi[1, planes], non_blocking=True)
            moved += 2 * hi[0, planes].numel() * hi.element_size()
        return moved


def split_runs(starts, devices):
    """Whole blocks to devices in contiguous runs: the block starts
    ``starts`` cut into len(devices) runs as even as they come, in order,
    each with its device (an empty run is left out)."""
    n, D = len(starts), len(devices)
    runs = [(dev, starts[d * n // D:(d + 1) * n // D])
            for d, dev in enumerate(devices)]
    return [(dev, run) for dev, run in runs if run]


def make_mesh(n_devices: int | None = None, devices=None) -> BandMesh:
    """A mesh of ``n_devices`` bands. Without ``devices``, the first
    ``n_devices`` CUDA cards (all of them without ``n_devices``); it raises
    when there are fewer, and never takes the CPU or a card twice on its
    own. ``devices`` lists the bands' devices (the first ``n_devices`` of
    them): ``[torch.device("cuda", 0)] * 4`` puts four bands on one card,
    ``["cpu"] * 8`` eight on the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(
                f"make_mesh: {n_devices or 'all'} CUDA cards asked for, "
                f"{count} present; pass devices= to place bands yourself")
        return BandMesh([torch.device("cuda", i) for i in range(n)])
    devices = list(devices)
    n = len(devices) if n_devices is None else n_devices
    if n < 1 or n > len(devices):
        raise ValueError(f"make_mesh: {n} bands over {len(devices)} devices")
    return BandMesh(devices[:n])
