"""Bonded (listed) energies with FEP A/B interpolation — PyTorch
counterpart of gromacs_fep_gpu_tpu/ops/bonded.py (every term, TERMS,
TERM_CHANNEL, RESTRAINT_TERMS; reference: listed_forces/bonded.cpp and the
fork's *_fep_gpu listed-forces kernels, listed_forces_gpu_internal.cu).

Energy-only functions of (x, box, lambda); parameters interpolate linearly
between the end states, so torch.autograd gives the forces and the
reference's dvdl.  lambda is a scalar, or an (L,) vector of a
foreign-lambda sweep, and the energy has lambda's shape: the lambda axis
rides in front of the interaction axis, so a sweep is one pass of (L, n)
tensors, not L passes.  The geometry (distances, angles, dihedrals) does
not depend on lambda and is computed once.

Which lambda component drives a term is listed_energy's business: the
terms in RESTRAINT_TERMS follow lambda_restraint, the rest lambda_bonded
(reference: ifunc.h IF_RESTRAINT).
"""
from __future__ import annotations

import math

import torch

from ..core import pbc as pbc_mod
from ..core.types import FepCoupling, InteractionList
from ..core.units import DEG2RAD


def _interp(pa, pb, lam):
    """(..., n, p) parameters at lambda of shape (...)."""
    lam = lam[..., None, None]
    return (1.0 - lam) * pa + lam * pb


def _interp_col(a, b, lam):
    """(..., n) of one parameter column at lambda of shape (...)."""
    lam = lam[..., None]
    return (1.0 - lam) * a + lam * b


def _bond_vec(x, box, i, j):
    return pbc_mod.pbc_dx(x[i] - x[j], box)


def _norm(d):
    return torch.sqrt(torch.sum(d * d, -1) + 1e-32)


def _vec_angle(a, b):
    """Angle between the rows of a and b (clipped away from 0 and pi)."""
    cos_th = torch.sum(a * b, -1) * torch.rsqrt(
        torch.sum(a * a, -1) * torch.sum(b * b, -1) + 1e-32)
    return torch.arccos(torch.clamp(cos_th, -1.0 + 1e-7, 1.0 - 1e-7))


def _wrap(d):
    """Angle difference wrapped to [-pi, pi] (round half to even, as
    jnp.round)."""
    return d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))


def bond_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Harmonic bonds: V = 1/2 k (r - b0)^2."""
    p = _interp(il.params_a, il.params_b, lam)
    dr = _norm(_bond_vec(x, box, il.atoms[:, 0], il.atoms[:, 1])) - p[..., 0]
    return torch.sum(il.mask * 0.5 * p[..., 1] * dr * dr, -1)


def angle_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Harmonic angles: V = 1/2 k (th - th0)^2, th0 in degrees."""
    p = _interp(il.params_a, il.params_b, lam)
    aj = il.atoms[:, 1]
    th = _vec_angle(_bond_vec(x, box, il.atoms[:, 0], aj),
                    _bond_vec(x, box, il.atoms[:, 2], aj))
    d = th - p[..., 0] * DEG2RAD
    return torch.sum(il.mask * 0.5 * p[..., 1] * d * d, -1)


def ub_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Urey-Bradley: harmonic angle + harmonic 1-3 distance; params (th0
    in degrees, kth, r13, kub)."""
    p = _interp(il.params_a, il.params_b, lam)
    dr = _norm(_bond_vec(x, box, il.atoms[:, 0], il.atoms[:, 2])) \
        - p[..., 2]
    return (angle_energy(x, box, il, lam)
            + torch.sum(il.mask * 0.5 * p[..., 3] * dr * dr, -1))


def dihedral_angle(x, box, atoms):
    """Signed dihedral phi of (n, 4) index rows (reference: bonded.cpp
    dih_angle): atan2(|m x n|, m . n), negative where r_ij . n < 0."""
    rij = _bond_vec(x, box, atoms[:, 0], atoms[:, 1])
    rkj = _bond_vec(x, box, atoms[:, 2], atoms[:, 1])
    rkl = _bond_vec(x, box, atoms[:, 2], atoms[:, 3])
    m = torch.linalg.cross(rij, rkj)
    n = torch.linalg.cross(rkj, rkl)
    phi = torch.atan2(_norm(torch.linalg.cross(m, n)), torch.sum(m * n, -1))
    return torch.where(torch.sum(rij * n, -1) < 0.0, -phi, phi)


def pdih_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Proper dihedrals: V = k (1 + cos(mult phi - phi0)), phi0 in degrees;
    phi0 and k interpolate, the multiplicity is state A's."""
    phi = dihedral_angle(x, box, il.atoms)
    phi0 = _interp_col(il.params_a[:, 0], il.params_b[:, 0], lam) * DEG2RAD
    k = _interp_col(il.params_a[:, 1], il.params_b[:, 1], lam)
    mult = il.params_a[:, 2]
    return torch.sum(il.mask * k * (1.0 + torch.cos(mult * phi - phi0)), -1)


def rbdih_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Ryckaert-Bellemans: V = sum_n C_n cos^n(psi), psi = phi - 180 deg."""
    cos_psi = -torch.cos(dihedral_angle(x, box, il.atoms))
    c = _interp(il.params_a, il.params_b, lam)          # (..., n, 6)
    pw = [torch.ones_like(cos_psi)]
    for _ in range(c.shape[-1] - 1):
        pw.append(pw[-1] * cos_psi)
    return torch.sum(il.mask * torch.sum(c * torch.stack(pw, -1), -1), -1)


def idih_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Harmonic (improper) dihedrals: V = 1/2 k dphi^2, dphi wrapped."""
    phi = dihedral_angle(x, box, il.atoms)
    phi0 = _interp_col(il.params_a[:, 0], il.params_b[:, 0], lam) * DEG2RAD
    k = _interp_col(il.params_a[:, 1], il.params_b[:, 1], lam)
    dphi = _wrap(phi - phi0)
    return torch.sum(il.mask * 0.5 * k * dphi * dphi, -1)


def posres_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Position restraints: V = 1/2 sum_d k_d (x_d - x0_d)^2; params (x0,
    y0, z0, kx, ky, kz) per state."""
    p = _interp(il.params_a, il.params_b, lam)
    dx = pbc_mod.pbc_dx(x[il.atoms[:, 0]] - p[..., 0:3], box)
    return torch.sum(il.mask * 0.5 * torch.sum(p[..., 3:6] * dx * dx, -1),
                     -1)


def dihres_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Flat-bottomed dihedral restraints: V = 1/2 k max(|dphi| - dphi0,
    0)^2, phi0, dphi0 (degrees) and k interpolated."""
    phi = dihedral_angle(x, box, il.atoms)
    p = _interp(il.params_a, il.params_b, lam)
    dp = _wrap(phi - p[..., 0] * DEG2RAD)
    ddp = torch.sign(dp) * torch.clamp(torch.abs(dp) - p[..., 1] * DEG2RAD,
                                       min=0.0)
    return torch.sum(il.mask * 0.5 * p[..., 2] * ddp * ddp, -1)


def angres_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Angle restraints between the vectors j - i and l - k:
    V = k (1 - cos(mult (theta - theta0))), theta0 in degrees; theta0 and k
    interpolate, the multiplicity is state A's."""
    at = il.atoms
    th = _vec_angle(_bond_vec(x, box, at[:, 1], at[:, 0]),
                    _bond_vec(x, box, at[:, 3], at[:, 2]))
    th0 = _interp_col(il.params_a[:, 0], il.params_b[:, 0], lam) * DEG2RAD
    k = _interp_col(il.params_a[:, 1], il.params_b[:, 1], lam)
    mult = il.params_a[:, 2]
    return torch.sum(il.mask * k * (1.0 - torch.cos(mult * (th - th0))), -1)


def _flat_bottom(r, low, up1, up2, k):
    """0 in [low, up1], harmonic below low and in (up1, up2], linear with
    the matching slope beyond up2."""
    return torch.where(
        r < low, 0.5 * k * (r - low) ** 2,
        torch.where(r <= up1, torch.zeros_like(r * k),
                    torch.where(r <= up2, 0.5 * k * (r - up1) ** 2,
                                0.5 * k * (up2 - up1)
                                * (2.0 * r - up2 - up1))))


def restrbond_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Flat-bottomed restraint bonds (bonds funct 10); params (low, up1,
    up2, k) per state."""
    p = _interp(il.params_a, il.params_b, lam)
    r = _norm(_bond_vec(x, box, il.atoms[:, 0], il.atoms[:, 1]))
    v = _flat_bottom(r, p[..., 0], p[..., 1], p[..., 2], p[..., 3])
    return torch.sum(il.mask * v, -1)


def fbposres_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Flat-bottomed position restraints; params (geom, x0, y0, z0, r, k),
    state A only: lambda-independent, but lambda's shape.  geom 1 sphere,
    3/4/5 an x/y/z slab, 6/7/8 a cylinder around x/y/z; a negative r
    restrains to the outside of |r|."""
    pa = il.params_a
    geom = pa[:, 0].to(torch.int64)
    dx = pbc_mod.pbc_dx(x[il.atoms[:, 0]] - pa[:, 1:4], box)
    dr = _norm(dx)
    for g in (3, 4, 5):
        dr = torch.where(geom == g, torch.abs(dx[:, g - 3]), dr)
    for g in (6, 7, 8):
        a, b = [d for d in range(3) if d != g - 6]
        dr = torch.where(geom == g,
                         torch.sqrt(dx[:, a] ** 2 + dx[:, b] ** 2 + 1e-32),
                         dr)
    r = pa[:, 4]
    dev = torch.where(r < 0.0, torch.clamp(torch.abs(r) - dr, min=0.0),
                      torch.clamp(dr - torch.abs(r), min=0.0))
    e = torch.sum(il.mask * 0.5 * pa[:, 5] * dev * dev)
    return e + torch.zeros(lam.shape, dtype=e.dtype, device=e.device)


def disres_energy(x, box, il: InteractionList, lam,
                  fc: float = 1000.0) -> torch.Tensor:
    """NMR distance restraints with instantaneous r^-3 averaging over the
    pairs that share a label (reference: listed_forces/disre.cpp
    ta_disres, conservative weighting); params (lo, up1, up2, weight,
    label), labels dense ids from build_system.  Per label: 0 in [lo,
    up1], 0.5 fc dr^2 outside up to up2, linear beyond.  The segment sums
    and maxima run along the last axis under the leading lambda axis."""
    p = _interp(il.params_a, il.params_b, lam)           # (..., n, 5)
    w = p[..., 3] * il.mask
    n = il.n
    label = il.params_a[:, 4].to(torch.int64)
    rm3 = (torch.sum(_bond_vec(x, box, il.atoms[:, 0], il.atoms[:, 1]) ** 2,
                     -1) + 1e-32) ** -1.5
    zeros = torch.zeros(w.shape[:-1] + (n,), dtype=w.dtype, device=w.device)
    s3 = zeros.index_add(-1, label, w * rm3)
    sw = zeros.index_add(-1, label, w)
    valid = sw > 0.0
    rav = torch.where(valid, s3 / torch.clamp(sw, min=1e-32),
                      torch.ones_like(s3)) ** (-1.0 / 3.0)
    idx = label.expand(w.shape)
    keep = il.mask > 0

    def seg_max(v):
        """Per-label bound: the largest over the label's live pairs (all
        of them hold the same value)."""
        return zeros.scatter_reduce(-1, idx, torch.where(keep, v, -1e30),
                                    "amax", include_self=False)
    lo, up1, up2 = (seg_max(p[..., c]) for c in range(3))
    v = _flat_bottom(rav, lo, up1, up2, fc)
    return torch.sum(torch.where(valid, v, torch.zeros_like(v)), -1)


TERMS = {
    "bonds": bond_energy,
    "angles": angle_energy,
    "ub": ub_energy,
    "pdihs": pdih_energy,
    "rbdihs": rbdih_energy,
    "idihs": idih_energy,
    "posres": posres_energy,
    "dihres": dihres_energy,
    "angres": angres_energy,
    "restrbonds": restrbond_energy,
    "disres": disres_energy,
    "fbposres": fbposres_energy,
}

# the EnergyTerms field each term accumulates into
TERM_CHANNEL = {
    "bonds": "bonds",
    "angles": "angles",
    "ub": "angles",
    "pdihs": "dihedrals",
    "rbdihs": "dihedrals",
    "idihs": "impropers",
    "posres": "restraints",
    "dihres": "restraints",
    "angres": "restraints",
    "restrbonds": "restraints",
    "disres": "restraints",
    "fbposres": "restraints",
}

# terms whose lambda dependence follows the RESTRAINT coupling component
# (reference: ifunc.h IF_RESTRAINT-flagged types route dvdl to
# FreeEnergyPerturbationCouplingType::Restraint)
RESTRAINT_TERMS = frozenset({"posres", "dihres", "angres", "restrbonds",
                             "disres", "fbposres"})


def listed_energy(name: str, x, box, il: InteractionList, lam,
                  disre_fc: float = 1000.0) -> torch.Tensor:
    """Term `name`'s energy at the lambda vector lam, (7,) or (L, 7): a
    RESTRAINT_TERMS member at lam[..., RESTRAINT], any other term at
    lam[..., BONDED]; disres with the force constant disre_fc (mdp
    disre-fc)."""
    comp = (FepCoupling.RESTRAINT if name in RESTRAINT_TERMS
            else FepCoupling.BONDED)
    lam_t = lam[..., comp]
    if name == "disres":
        return disres_energy(x, box, il, lam_t, disre_fc)
    return TERMS[name](x, box, il, lam_t)
