"""Solvation-FEP model — PyTorch counterpart of
gromacs_fep_gpu_tpu/models/solvation.py (methane_like_ligand,
ligand_geometry, solvation_system): a 5-site ligand decoupled from TIP3P
water, the flagship benchmark system."""
from __future__ import annotations

import numpy as np

from ..core.topology import MoleculeType, build_system, lj_table_from_sigma_eps
from ..core.types import make_state
from ..core.units import BOLTZ
from .water import (M_H, M_O, O_EPS, O_SIGMA, _random_rotations,
                    tip3p_moltype, water_template)

# types: 0 = water O, 1 = water H (no LJ), 2 = ligand C, 3 = ligand H,
# 4 = dummy (decoupled)
LIG_C_SIGMA, LIG_C_EPS = 0.35, 0.45
LIG_H_SIGMA, LIG_H_EPS = 0.25, 0.10


def methane_like_ligand(decouple: bool = True) -> MoleculeType:
    """5-site tetrahedral ligand; state B = fully decoupled."""
    return MoleculeType(
        name="LIG",
        types_a=[2, 3, 3, 3, 3], charges_a=[-0.4, 0.1, 0.1, 0.1, 0.1],
        masses_a=[12.011, 1.008, 1.008, 1.008, 1.008],
        types_b=[4] * 5 if decouple else None,
        charges_b=[0.0] * 5 if decouple else None,
        bonds=[((0, i), (0.109, 280000.0)) for i in range(1, 5)],
        angles=[((i, 0, j), (109.47, 300.0))
                for i in range(1, 5) for j in range(i + 1, 5)],
        nrexcl=3)


def ligand_geometry() -> np.ndarray:
    d = 0.109
    t = d / np.sqrt(3.0)
    return np.array([[0.0, 0.0, 0.0], [t, t, t], [t, -t, -t],
                     [-t, t, -t], [-t, -t, t]])


def solvation_system(n_side: int = 8, spacing: float = 0.31, seed: int = 0,
                     temperature: float | None = 300.0,
                     decouple: bool = True, device="cuda"):
    """Ligand at the box centre + TIP3P lattice (one water removed).
    Returns (System, State) on `device`."""
    sigma = [O_SIGMA, 0.1, LIG_C_SIGMA, LIG_H_SIGMA, 0.1]
    eps = [O_EPS, 0.0, LIG_C_EPS, LIG_H_EPS, 0.0]
    nbfp = lj_table_from_sigma_eps(sigma, eps, comb_rule=3)
    nbfp[4, :, :] = 0.0
    nbfp[:, 4, :] = 0.0
    nbfp[1, :, :] = 0.0
    nbfp[:, 1, :] = 0.0

    box_l = n_side * spacing
    center = np.array([box_l / 2] * 3)
    rng = np.random.RandomState(seed)
    grid = np.mgrid[0:n_side, 0:n_side, 0:n_side].reshape(3, -1).T
    centers = (grid + 0.5) * spacing
    keep = np.argsort(np.linalg.norm(centers - center, axis=1))[1:]
    centers = centers[keep]
    n_water = centers.shape[0]

    lig = methane_like_ligand(decouple)
    system = build_system([(lig, 1), (tip3p_moltype(), n_water)], nbfp,
                          device=device)

    rots = _random_rotations(n_water, rng)
    tpl = water_template()
    xw = (centers[:, None, :] + np.einsum('nij,kj->nki', rots, tpl)
          ).reshape(-1, 3)
    xl = ligand_geometry() + center
    x = np.concatenate([xl, xw])
    box = np.diag([box_l] * 3).astype(np.float32)

    n_atoms = x.shape[0]
    masses = np.concatenate([[12.011, 1.008, 1.008, 1.008, 1.008],
                             np.tile([M_O, M_H, M_H], n_water)])
    if temperature is not None:
        sd = np.sqrt(BOLTZ * temperature / masses)[:, None]
        v = rng.normal(0.0, 1.0, (n_atoms, 3)) * sd
        v -= (masses[:, None] * v).sum(0) / masses.sum()
    else:
        v = np.zeros((n_atoms, 3))
    state = make_state(x.astype(np.float32), v.astype(np.float32), box,
                       device=device)
    return system, state
