"""Bonded energies with FEP A/B interpolation — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/bonded.py (bond_energy, angle_energy, TERMS,
TERM_CHANNEL).

Energy-only functions of (x, box, lambda_bonded); parameters interpolate
linearly between the end states, so torch.autograd gives the forces and
the reference's dvdl.  lambda is a scalar, or an (L,) vector of a
foreign-lambda sweep, and the energy has lambda's shape.  Only harmonic
bonds and angles are ported: the solvation ligand has 4 bonds and 6 angles.
"""
from __future__ import annotations

import torch

from ..core import pbc as pbc_mod
from ..core.types import InteractionList
from ..core.units import DEG2RAD


def _interp(pa, pb, lam):
    """(..., n, p) parameters at lambda of shape (...)."""
    lam = lam[..., None, None]
    return (1.0 - lam) * pa + lam * pb


def bond_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Harmonic bonds: V = 1/2 k (r - b0)^2."""
    p = _interp(il.params_a, il.params_b, lam)
    dx = pbc_mod.pbc_dx(x[il.atoms[:, 0]] - x[il.atoms[:, 1]], box)
    dr = torch.sqrt(torch.sum(dx * dx, -1) + 1e-32) - p[..., 0]
    return torch.sum(il.mask * 0.5 * p[..., 1] * dr * dr, -1)


def angle_energy(x, box, il: InteractionList, lam) -> torch.Tensor:
    """Harmonic angles: V = 1/2 k (th - th0)^2, th0 in degrees."""
    p = _interp(il.params_a, il.params_b, lam)
    aj = il.atoms[:, 1]
    rij = pbc_mod.pbc_dx(x[il.atoms[:, 0]] - x[aj], box)
    rkj = pbc_mod.pbc_dx(x[il.atoms[:, 2]] - x[aj], box)
    cos_th = torch.sum(rij * rkj, -1) * torch.rsqrt(
        torch.sum(rij * rij, -1) * torch.sum(rkj * rkj, -1) + 1e-32)
    th = torch.arccos(torch.clamp(cos_th, -1.0 + 1e-7, 1.0 - 1e-7))
    d = th - p[..., 0] * DEG2RAD
    return torch.sum(il.mask * 0.5 * p[..., 1] * d * d, -1)


TERMS = {"bonds": bond_energy, "angles": angle_energy}
TERM_CHANNEL = {"bonds": "bonds", "angles": "angles"}
