"""Rigid-water constraints — PyTorch counterpart of
gromacs_fep_gpu_tpu/md/constraints.py (_solve3x3, settle_positions,
n_constraints) and of the velocity constraint of md/simulator.py
(constrain_velocities).

SETTLE-class constraints by a fixed number of batched Newton iterations on
the three Lagrange multipliers per water (the JAX formulation, scalarized
per component, closed-form 3x3 solve).  LINCS is not ported: a system with
general constraints raises in the simulator.
"""
from __future__ import annotations

import torch

from ..core import pbc as pbc_mod
from ..core.types import SettleGroups


def _solve3x3(a, b):
    """Batched closed-form 3x3 solve via the adjugate."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.ones_like(det))
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c10 * b1 + c20 * b2) * inv_det,
                        (c01 * b0 + c11 * b1 + c21 * b2) * inv_det,
                        (c02 * b0 + c12 * b1 + c22 * b2) * inv_det], -1)


def settle_positions(x0, x1, box, settle: SettleGroups, invmass,
                     n_iter: int = 5):
    """Constrain updated positions x1 so each water keeps its geometry.

    x0: positions before the update (on the constraint manifold); x1:
    unconstrained update.  Newton on the multipliers of
    c_k = |r'_k|^2 - d_k^2 with x' = x1 - sum_k l_k invm grad c_k(x0)."""
    if settle.atoms.shape[0] == 0:
        return x1
    o, h1, h2 = settle.atoms[:, 0], settle.atoms[:, 1], settle.atoms[:, 2]
    mask = settle.mask
    w_o = invmass[o] * mask
    w_h = invmass[h1] * mask
    a1 = pbc_mod.pbc_dx(x0[o] - x0[h1], box).unbind(-1)
    a2 = pbc_mod.pbc_dx(x0[o] - x0[h2], box).unbind(-1)
    a3 = pbc_mod.pbc_dx(x0[h1] - x0[h2], box).unbind(-1)
    u1 = pbc_mod.pbc_dx(x1[o] - x1[h1], box).unbind(-1)
    u2 = pbc_mod.pbc_dx(x1[o] - x1[h2], box).unbind(-1)
    u3 = pbc_mod.pbc_dx(x1[h1] - x1[h2], box).unbind(-1)
    d_oh2 = settle.d_oh ** 2
    d_hh2 = settle.d_hh ** 2
    woh = w_o + w_h

    def bond_vectors(l1, l2, l3):
        r1 = [u1[d] - 2 * l1 * woh * a1[d] - 2 * l2 * w_o * a2[d]
              + 2 * l3 * w_h * a3[d] for d in range(3)]
        r2 = [u2[d] - 2 * l1 * w_o * a1[d] - 2 * l2 * woh * a2[d]
              - 2 * l3 * w_h * a3[d] for d in range(3)]
        r3 = [u3[d] + 2 * l1 * w_h * a1[d] - 2 * l2 * w_h * a2[d]
              - 4 * l3 * w_h * a3[d] for d in range(3)]
        return r1, r2, r3

    def dot(r, a):
        return r[0] * a[0] + r[1] * a[1] + r[2] * a[2]

    z = torch.zeros_like(w_o)
    l1, l2, l3 = z, z, z
    for _ in range(n_iter):
        r1, r2, r3 = bond_vectors(l1, l2, l3)
        c1 = (dot(r1, r1) - d_oh2) * mask
        c2 = (dot(r2, r2) - d_oh2) * mask
        c3 = (dot(r3, r3) - d_hh2) * mask
        jac = torch.stack([
            torch.stack([-4 * woh * dot(r1, a1) - (1.0 - mask),
                         -4 * w_o * dot(r1, a2), 4 * w_h * dot(r1, a3)], -1),
            torch.stack([-4 * w_o * dot(r2, a1),
                         -4 * woh * dot(r2, a2) - (1.0 - mask),
                         -4 * w_h * dot(r2, a3)], -1),
            torch.stack([4 * w_h * dot(r3, a1), -4 * w_h * dot(r3, a2),
                         -8 * w_h * dot(r3, a3) - (1.0 - mask)], -1)], -2)
        dl = _solve3x3(jac, -torch.stack([c1, c2, c3], -1))
        l1 = l1 + dl[..., 0] * mask
        l2 = l2 + dl[..., 1] * mask
        l3 = l3 + dl[..., 2] * mask

    d_o = torch.stack([-2 * w_o * (l1 * a1[d] + l2 * a2[d])
                       for d in range(3)], -1)
    d_h1 = torch.stack([2 * w_h * (l1 * a1[d] - l3 * a3[d])
                        for d in range(3)], -1)
    d_h2 = torch.stack([2 * w_h * (l2 * a2[d] + l3 * a3[d])
                        for d in range(3)], -1)
    # each atom belongs to at most one water: an index_add is a scatter of
    # disjoint rows
    return x1.index_add(0, torch.cat([o, h1, h2]),
                        torch.cat([d_o, d_h1, d_h2]))


def n_constraints(system) -> int:
    return 3 * int(system.settle.atoms.shape[0])


def constrain_velocities(x_ref, v, box, settle: SettleGroups, invmass,
                         dt: float):
    """Project velocities onto the constraint manifold by constraining
    x + dt v (reference: constr.cpp ConstraintVariable::Velocities)."""
    xv = settle_positions(x_ref, x_ref + dt * v, box, settle, invmass)
    return (xv - x_ref) / dt
