"""TIP3P water — PyTorch counterpart of gromacs_fep_gpu_tpu/models/water.py
(tip3p_moltype, water_template, _random_rotations).  Same numpy RandomState
stream, so the generated arrays are identical."""
from __future__ import annotations

import numpy as np

from ..core.topology import MoleculeType

# TIP3P parameters
O_SIGMA = 0.315061   # nm
O_EPS = 0.636386     # kJ/mol
Q_O = -0.834
Q_H = 0.417
M_O = 15.99940
M_H = 1.00800
D_OH = 0.09572       # nm
ANGLE_HOH = 104.52   # degrees
D_HH = 2.0 * D_OH * np.sin(np.deg2rad(ANGLE_HOH / 2.0))


def tip3p_moltype(rigid: bool = True, type_o: int = 0, type_h: int = 1
                  ) -> MoleculeType:
    if not rigid:
        raise NotImplementedError("flexible TIP3P is not ported yet")
    mol = MoleculeType(name="SOL", types_a=[type_o, type_h, type_h],
                       charges_a=[Q_O, Q_H, Q_H], masses_a=[M_O, M_H, M_H],
                       nrexcl=3)
    mol.settle = (0, 1, 2, D_OH, float(D_HH))
    return mol


def water_template() -> np.ndarray:
    """(3,3) O,H1,H2 positions, O at origin, in the xz plane."""
    half = np.deg2rad(ANGLE_HOH / 2.0)
    return np.array([
        [0.0, 0.0, 0.0],
        [D_OH * np.sin(half), 0.0, D_OH * np.cos(half)],
        [-D_OH * np.sin(half), 0.0, D_OH * np.cos(half)],
    ], np.float64)


def _random_rotations(n, rng):
    """Uniform random rotation matrices via QR of gaussian matrices."""
    a = rng.normal(size=(n, 3, 3))
    q, r = np.linalg.qr(a)
    d = np.sign(np.einsum('nii->ni', r))
    q = q * d[:, None, :]
    det = np.linalg.det(q)
    q[det < 0, :, 0] *= -1.0
    return q
