"""The grid-rigid narrowphase kernel, with its plain PyTorch version.

``narrowphase`` launches the hand-written CUDA kernel
``csrc/narrowphase.cu`` (built by ``_build.py``) for CUDA tensors and runs
``narrowphase_plain`` for CPU tensors; any other device raises, and a CUDA
input the kernel does not take raises too. ``narrowphase.launches`` and
``narrowphase.plain_calls`` count the two; ``reset_counters()`` zeroes them.

It replaces ``lpe_tpu/ops/pallas_rigid.py`` ``make_narrowphase`` and keeps
its contract: rows of two polygon shapes in, ``(hit [N], nrm [N, 2],
pen [N], pts [N, 2, 2], pens [N, 2], cval [N, 2])`` out, where ``cval`` is
already ANDed with ``hit`` (the TPU kernel's ``oka``/``okb``). The plain
version is the vmapped XLA pair it stands in for: ``geometry.sat_contact``
then ``pipeline._pair_contacts`` with C = 2.
"""
from __future__ import annotations

import torch

from ..systems.rigid import geometry as geo
from ..systems.rigid.pipeline import _pair_contacts
from .sph_kernels import KernelOp, _check

V_MIN, V_MAX = 3, 16      # the vertex counts csrc/narrowphase.cu instantiates


def _shape(pos, angle, verts, nverts):
    V = verts.shape[1]
    vmask = torch.arange(V, device=verts.device)[None, :] < nverts[:, None]
    return dict(pos=pos, angle=angle, verts=verts, nverts=nverts,
                vmask=vmask)


def narrowphase_plain(a_pos, a_angle, a_verts, a_nverts,
                      b_pos, b_angle, b_verts, b_nverts):
    """Poly-poly SAT + incident-edge clip of each row: pos [N, 2], angle
    [N], verts [N, V, 2] (local), nverts [N] int32 per side."""
    sa = _shape(a_pos, a_angle, a_verts, a_nverts)
    sb = _shape(b_pos, b_angle, b_verts, b_nverts)
    hit, nrm, pen = geo.sat_contact(sa, sb, any_circle=False)
    pts, pens, cval = _pair_contacts(sa, sb, nrm, pen, 2)
    return hit, nrm, pen, pts, pens, cval & hit[:, None]


def _narrowphase_cuda(a_pos, a_angle, a_verts, a_nverts,
                      b_pos, b_angle, b_verts, b_nverts):
    from . import _build
    N, V = a_verts.shape[0], a_verts.shape[1]
    if not (V_MIN <= V <= V_MAX):
        raise ValueError(f"narrowphase: V={V} vertices per ring; the kernel "
                         f"takes {V_MIN} to {V_MAX}")
    for side, (pos, ang, verts, nv) in (
            ("a", (a_pos, a_angle, a_verts, a_nverts)),
            ("b", (b_pos, b_angle, b_verts, b_nverts))):
        _check(f"narrowphase {side}_pos", pos, (N, 2))
        _check(f"narrowphase {side}_angle", ang, (N,))
        _check(f"narrowphase {side}_verts", verts, (N, V, 2))
        _check(f"narrowphase {side}_nverts", nv, (N,), torch.int32)
    # cos and sin exactly as the plain version (geometry.world_verts)
    # takes them
    ca, sa_ = torch.cos(a_angle), torch.sin(a_angle)
    cb, sb_ = torch.cos(b_angle), torch.sin(b_angle)
    dev = a_pos.device
    f32 = torch.float32
    hit = torch.empty((N,), dtype=torch.bool, device=dev)
    nrm = torch.empty((N, 2), dtype=f32, device=dev)
    pen = torch.empty((N,), dtype=f32, device=dev)
    pts = torch.empty((N, 2, 2), dtype=f32, device=dev)
    pens = torch.empty((N, 2), dtype=f32, device=dev)
    cval = torch.empty((N, 2), dtype=torch.bool, device=dev)
    _build.call("lpe_narrowphase", a_pos, ca, sa_, a_verts, a_nverts,
                b_pos, cb, sb_, b_verts, b_nverts, hit, nrm, pen, pts, pens,
                cval, _build.NarrowParams(N, V))
    return hit, nrm, pen, pts, pens, cval


narrowphase = KernelOp("narrowphase", narrowphase_plain, _narrowphase_cuda)
OPS = (narrowphase,)


def reset_counters():
    for op in OPS:
        op.launches = 0
        op.plain_calls = 0
