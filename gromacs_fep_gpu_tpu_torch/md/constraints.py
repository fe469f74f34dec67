"""Holonomic constraints — PyTorch counterpart of
gromacs_fep_gpu_tpu/md/constraints.py (_solve3x3, settle_positions,
lincs_positions, constrain, n_constraints) and of the velocity constraint
of md/simulator.py (constrain_velocities).

SETTLE-class constraints by a fixed number of batched Newton iterations on
the three Lagrange multipliers per water (the JAX formulation, scalarized
per component, closed-form 3x3 solve).  General bond constraints by
matrix-free LINCS (reference: mdlib/lincs.cpp:1023 do_lincs): a truncated
series for the coupling matrix's inverse applied with gathers and
index_add, then lincs_iter rounds of length correction; with perturbed
lengths the accumulated multipliers give the constraint dH/dlambda.  Both
are stock PyTorch, as the JAX package leaves them to XLA.  JAX's
_cluster_shake (direct M-SHAKE on small clusters) has no caller there and
is not ported.

The constraint virial (with_virial=True) is taken over the constraint
pairs: each SETTLE bond and LINCS row pulls its two atoms with equal and
opposite forces along its direction at x0, so Xi_aa = -1/2 sum_i x_i,a
f_i,a = -1/2 sum over the pairs of r_a F_a with r the pair's pbc_dx
vector at the constrained positions.  It is the same for a molecule whose
atoms lie in different periodic images as for the molecule made whole, and
it reads no difference of ~1 nm positions.  The functions return it times
dt^2 (they do not know dt): the caller divides.
"""
from __future__ import annotations

import torch

from ..core import pbc as pbc_mod
from ..core.types import LincsConstraints, SettleGroups


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
                     n_iter: int = 5, with_virial: bool = False):
    """Constrain updated positions x1 so each water keeps its geometry.

    x0: positions before the update (on the constraint manifold); x1:
    unconstrained update.  Newton on the multipliers of
    c_k = |r'_k|^2 - d_k^2 with x' = x1 - sum_k l_k invm grad c_k(x0).

    with_virial=True also returns the (3,) diagonal constraint virial
    times dt^2: bond k moves its atoms by -+2 l_k invm a_k (a_k its vector
    at x0), so Xi_aa dt^2 = sum_k l_k r_k,a a_k,a with r_k the bond's
    vector after the solve."""
    if settle.atoms.shape[0] == 0:
        return (x1, x1.new_zeros(3)) if with_virial else x1
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
    xc = x1.index_add(0, torch.cat([o, h1, h2]),
                      torch.cat([d_o, d_h1, d_h2]))
    if not with_virial:
        return xc
    r1, r2, r3 = bond_vectors(l1, l2, l3)
    vir = torch.stack([torch.sum((l1 * r1[d] * a1[d] + l2 * r2[d] * a2[d]
                                  + l3 * r3[d] * a3[d]) * mask)
                       for d in range(3)])
    return xc, vir


def lincs_positions(x0, x1, box, lincs: LincsConstraints, invmass,
                    lam_bonded=None, order: int = 4, n_rounds: int = 2,
                    with_dhdl: bool = False, with_virial: bool = False):
    """Matrix-free LINCS (reference: mdlib/lincs.cpp:1023 do_lincs).

    x' = x1 - invm B^T S (I + A + A^2 + ...) S (B x1 - d) with
    A = I - S B invm B^T S, B the unit bond directions at x0 and S =
    diag(1/sqrt(w_i + w_j)); then n_rounds of length correction against
    the rotation error.  The target lengths are mixed at lam_bonded.

    with_dhdl=True also returns dH/dlambda * dt^2 from the accumulated
    multipliers, -sum_b mlambda_b (lenB_b - lenA_b) (lincs.cpp:1257; the
    caller divides by dt^2, constr.cpp:2678).  with_virial=True also
    returns (last) the (3,) diagonal constraint virial times dt^2: row b
    moves its atoms by -+invm mlambda_b u_b, so Xi_aa dt^2 = 1/2 sum_b
    mlambda_b r_b,a u_b,a with r_b the row's vector after the solve."""
    nc = lincs.atoms.shape[0]
    if nc == 0:
        return _lincs_out(x1, x1.new_zeros(()) if with_dhdl else None,
                          x1.new_zeros(3) if with_virial else None)
    ai, aj = lincs.atoms[:, 0], lincs.atoms[:, 1]
    lam = 0.0 if lam_bonded is None else lam_bonded
    d = (1.0 - lam) * lincs.length_a + lam * lincs.length_b
    mask = lincs.mask

    r0 = pbc_mod.pbc_dx(x0[ai] - x0[aj], box)
    u = r0 * torch.rsqrt(torch.sum(r0 * r0, -1, keepdim=True) + 1e-32)
    wi, wj = invmass[ai], invmass[aj]
    sdiag = torch.rsqrt(wi + wj + 1e-32)

    def apply_BinvmBt(v):
        """S B invm B^T S v (v over the constraints)."""
        sv = (sdiag * v * mask)[:, None] * u
        f = torch.zeros_like(x1).index_add(0, ai, sv).index_add(0, aj, -sv)
        f = f * invmass[:, None]
        return torch.sum((f[ai] - f[aj]) * u, -1) * sdiag * mask

    def project(xp, rhs, mlam):
        # (I - A)^-1 rhs ~ sum_{k <= order} A^k rhs
        acc = term = rhs
        for _ in range(order):
            term = term - apply_BinvmBt(term)
            acc = acc + term
        ml = sdiag * acc * mask
        g = ml[:, None] * u
        xp = xp.index_add(0, ai, -wi[:, None] * g).index_add(
            0, aj, wj[:, None] * g)
        return xp, mlam + ml

    # the projection removes the component of x1 - x0 along the bonds
    r1 = pbc_mod.pbc_dx(x1[ai] - x1[aj], box)
    rhs = sdiag * (torch.sum(u * r1, -1) - d) * mask
    xp, mlam = project(x1, rhs, torch.zeros_like(d))
    for _ in range(n_rounds):
        rc = pbc_mod.pbc_dx(xp[ai] - xp[aj], box)
        len2 = torch.sum(rc * rc, -1)
        # p = sqrt(2 d^2 - len^2), the reference's correction step
        p = torch.sqrt(torch.clamp(2.0 * d * d - len2, min=0.0))
        xp, mlam = project(xp, sdiag * (d - p) * mask, mlam)
    dhdl = vir = None
    if with_dhdl:
        dhdl = -torch.sum(mlam * (lincs.length_b - lincs.length_a) * mask)
    if with_virial:
        rf = pbc_mod.pbc_dx(xp[ai] - xp[aj], box)
        vir = 0.5 * torch.sum((mlam * mask)[:, None] * rf * u, 0)
    return _lincs_out(xp, dhdl, vir)


def _lincs_out(xp, dhdl, vir):
    """xp, followed by whichever of dhdl and vir was asked for."""
    extra = tuple(v for v in (dhdl, vir) if v is not None)
    return (xp,) + extra if extra else xp


def constrain(x0, x1, box, system, invmass, lam_bonded=None,
              order: int = 4, n_rounds: int = 2, with_dhdl: bool = False,
              with_virial: bool = False):
    """Every holonomic constraint of `system` on the updated positions x1:
    SETTLE, then LINCS.  with_dhdl=True also returns dH/dlambda * dt^2 of
    the perturbed constraint lengths (SETTLE waters are never perturbed);
    with_virial=True also returns (last) the (3,) diagonal constraint
    virial of both times dt^2, over the constraint pairs (independent of
    the periodic images the atoms lie in)."""
    if not with_virial:
        xc = settle_positions(x0, x1, box, system.settle, invmass)
        return lincs_positions(x0, xc, box, system.lincs, invmass,
                               lam_bonded, order, n_rounds, with_dhdl)
    xc, vir_s = settle_positions(x0, x1, box, system.settle, invmass,
                                 with_virial=True)
    out = lincs_positions(x0, xc, box, system.lincs, invmass, lam_bonded,
                          order, n_rounds, with_dhdl, with_virial=True)
    return out[:-1] + (out[-1] + vir_s,)


def n_constraints(system) -> int:
    return (3 * int(system.settle.atoms.shape[0])
            + int(system.lincs.atoms.shape[0]))


def has_perturbed_lengths(system) -> bool:
    """Host-side: whether any LINCS row has lenB != lenA (reads the
    lengths back once)."""
    lc = system.lincs
    return lc.atoms.shape[0] > 0 and bool(
        (lc.length_a != lc.length_b).any())


def constrain_velocities(x_ref, v, box, system, invmass, dt: float,
                         lam_bonded=None, order: int = 4,
                         n_rounds: int = 2):
    """Project velocities onto the constraint manifold by constraining
    x + dt v (reference: constr.cpp ConstraintVariable::Velocities; the
    JAX simulator's constrain_velocities)."""
    xv = constrain(x_ref, x_ref + dt * v, box, system, invmass, lam_bonded,
                   order, n_rounds)
    return (xv - x_ref) / dt
