"""sph_kernel_roofline (%): the sum of each traced launch's bound over the
sum of those launches' measured device time, for the kernels of the
stacked SPH chain (migrate, pair sweep, coupling9). A launch's bound
comes from ``bounds.sph_launch_bounds`` at the cell occupancy of its
block's start (the positions that block took), with the walls of the
benchmark's own inputs. Kernels without a bound there are left out of
both sums. Moves ticks_per_s."""
import torch

from benchmark import bounds


def read(tr):
    inp = tr.inputs
    boxes = []
    for p, v in zip(inp["wall_pos"], inp["wall_verts"][:, :4]):
        w = p[None, :] + v
        boxes.append([w[:, 0].min(), w[:, 1].min(), w[:, 0].max(),
                      w[:, 1].max()])
    boxes = torch.tensor(boxes, dtype=torch.float64)
    per_block = [bounds.sph_launch_bounds(tr.conf, inp["size"], obs["pos"],
                                          boxes, 4)
                 for obs in tr.block_inputs]
    need = spent = 0.0
    for name, _, dur, b in tr.ops:
        if 0 <= b < len(per_block) and name in per_block[b]:
            need += per_block[b][name]
            spent += dur * 1e-6
    if spent <= 0:
        return None
    return 100.0 * need / spent
