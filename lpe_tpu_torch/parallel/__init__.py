"""Row-band meshes: the devices of the multi-device fluid.

The counterpart of ``lpe_tpu/parallel/sharded.py`` ``make_mesh`` and of the
halo exchange of ``lpe_tpu/systems/fluid/sph.py`` step_halo (``_exch``,
:1733-1743). ``lpe_tpu`` runs one process over a list of devices
(``shard_map``); so does this package: band ``i`` of the fluid grid lives on
``mesh.devices[i]``, and the exchange between bands is copies between
their tensors, slice copies where two bands share a device and peer copies
between cards. There is no ``torch.distributed`` path: ``lpe_tpu`` has no
multi-process feature, and NCCL refuses two ranks on one card.

``split_runs`` and ``Runs`` cut whole blocks or rows into contiguous runs,
one a device, for the systems split by entity (gravity's receiver blocks,
the rigid list pipeline's pairs and contact rows).
"""
from __future__ import annotations

import torch


class BandMesh:
    """An ordered list of devices, one a band; ``devices[0]`` leads (the
    state lives there, and what no system splits runs there)."""

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
    ``starts`` cut into as many runs as there are blocks or devices,
    whichever is fewer, as even as they come, in order, each with its
    device. With fewer blocks than devices the first devices take one
    block each and the others none, so the first device always holds the
    first block."""
    n = len(starts)
    k = min(n, len(devices))
    return [(devices[d], starts[d * n // k:(d + 1) * n // k])
            for d in range(k)]


class Runs:
    """``n`` rows cut into contiguous runs, one a device of ``devices``
    (``split_runs``: a device beyond the row count takes none), and the
    transfers that take a tensor's rows to their runs and bring the runs'
    results back to ``lead`` in row order. Without ``devices`` (or with
    one) the rows are one whole run on ``lead``: ``cut``, ``copy`` and
    ``join`` then hand their arguments back, and the caller runs its
    single-device ops. The first device must be ``lead``.

    ``stats`` (``copies`` and ``bytes``) counts the tensors a split moves
    and their bytes, every run's but the first, which sits on the lead
    device: what a mesh of distinct cards moves, also where the runs share
    a card (there ``.to`` copies nothing). ``over`` cuts other rows over
    the same devices into the same counts."""

    def __init__(self, n: int, devices, lead, stats=None):
        self.lead = torch.device(lead)
        self.devices = None if devices is None or len(devices) < 2 \
            else [torch.device(d) for d in devices]
        if self.devices is None:
            self.runs = [(self.lead, 0, n)]
        elif self.devices[0] != self.lead:
            raise ValueError(f"cannot split over {devices}: the first "
                             f"is not the lead device {self.lead}")
        else:
            self.runs = [(dev, run[0], run[-1] + 1)
                         for dev, run in split_runs(range(n), self.devices)]
        self.whole = self.devices is None
        self.stats = dict(copies=0, bytes=0) if stats is None else stats

    def over(self, n: int) -> "Runs":
        """``n`` other rows over the same devices, counted in ``stats``."""
        return Runs(n, self.devices, self.lead, self.stats)

    def __len__(self):
        return len(self.runs)

    def _moved(self, i, t):
        if i > 0:
            self.stats["copies"] += 1
            self.stats["bytes"] += t.numel() * t.element_size()

    def cut(self, t):
        """Each run's rows of ``t`` (rows on dim 0), on its device."""
        if self.whole:
            return [t]
        out = []
        for i, (dev, a, b) in enumerate(self.runs):
            out.append(t[a:b].to(dev, non_blocking=True))
            self._moved(i, out[-1])
        return out

    def cut_dict(self, d):
        """``cut`` of each tensor of the dict ``d``, as one dict a run."""
        cols = {k: self.cut(v) for k, v in d.items()}
        return [{k: cols[k][i] for k in d} for i in range(len(self.runs))]

    def copy(self, t):
        """``t`` whole on each run's device."""
        if self.whole:
            return [t]
        out = []
        for i, (dev, _, _) in enumerate(self.runs):
            out.append(t.to(dev, non_blocking=True))
            self._moved(i, t)
        return out

    def join(self, parts):
        """The tensors ``parts`` (each on its run's device, in the order
        of ``cut``'s runs, or several such lists one after another) on the
        lead device, concatenated on dim 0; one tensor is handed back."""
        if len(parts) == 1:
            return parts[0]
        if not self.whole:
            n = len(self.runs)
            for i, t in enumerate(parts):
                self._moved(i % n, t)
            parts = [t.to(self.lead, non_blocking=True) for t in parts]
        return torch.cat(parts)


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
