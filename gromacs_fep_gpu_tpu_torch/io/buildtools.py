"""System-construction tools — PyTorch-port copy of solvate from
gromacs_fep_gpu_tpu/io/buildtools.py (numpy only; insert-molecules and
genion are not ported yet, ROADMAP item 8).

Reference: src/gromacs/gmxpreprocess/solvate.cpp (tile a solvent
configuration over the box, remove solvent overlapping the solute).  It
operates on coordinate sets — the data the gro files carry — and leaves
topology bookkeeping to the user's [ molecules ] section, exactly like
the reference tool (which prints the molecule count to splice into the
.top).  The rotations come from the port's models/water.py, the same
numpy RandomState stream as the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..models.water import _random_rotations, water_template


def _min_image(d: np.ndarray, box_diag: np.ndarray) -> np.ndarray:
    return d - box_diag * np.round(d / box_diag)


def solvate(solute_x: np.ndarray, box: np.ndarray,
            spacing: float = 0.31, shell: float = 0.24,
            seed: int = 2021
            ) -> Tuple[np.ndarray, int]:
    """Fill the box with TIP3P-geometry waters avoiding the solute.

    Returns (water_x (3*nwater, 3) with O,H1,H2 per molecule, n_water).
    spacing sets the target density (0.31 nm lattice ~ 33.4 /nm^3, the
    SPC216 density); shell is the minimum O-to-solute-atom distance
    (solvate.cpp removes solvent with atom pairs under the vdW sum).
    """
    bd = np.diag(np.asarray(box, np.float64))
    n_side = np.maximum((bd / spacing).astype(int), 1)
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in n_side],
                                indexing="ij"), -1).reshape(-1, 3)
    centers = (grid + 0.5) * (bd / n_side)
    if solute_x is not None and len(solute_x):
        d = _min_image(centers[:, None, :]
                       - np.asarray(solute_x)[None, :, :], bd)
        keep = (np.sqrt((d * d).sum(-1)).min(1) >= shell)
        centers = centers[keep]
    rots = _random_rotations(len(centers), rng)
    tmpl = water_template()
    xw = (centers[:, None, :]
          + np.einsum("nij,aj->nai", rots, tmpl)).reshape(-1, 3)
    return xw.astype(np.float32), len(centers)
