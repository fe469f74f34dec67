"""PDB coordinate file reader — PyTorch-port copy of
gromacs_fep_gpu_tpu/io/pdbio.py (box_from_cryst1, parse_pdb, read_pdb,
read_structure; numpy only).

Reference: src/gromacs/fileio/pdbio.cpp — ATOM/HETATM fixed columns,
coordinates in Angstrom (GROMACS stores nm: /10 on read, *10 on write),
CRYST1 cell (a b c alpha beta gamma) converted to/from the GROMACS
lower-triangular box matrix (matrix_convert semantics), MODEL/ENDMDL
frames, TER records ignored on read.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

_A2NM = 0.1


def box_from_cryst1(a: float, b: float, c: float, alpha: float,
                    beta: float, gamma: float) -> np.ndarray:
    """CRYST1 lengths (nm) + angles (deg) -> lower-triangular box matrix
    (reference: pdbio.cpp matrix_convert)."""
    if a * b * c == 0.0:
        return np.zeros((3, 3))
    ca, cb, cg = (math.cos(math.radians(v)) for v in (alpha, beta, gamma))
    sg = math.sin(math.radians(gamma))
    box = np.zeros((3, 3))
    box[0, 0] = a
    box[1, 0] = b * cg
    box[1, 1] = b * sg
    box[2, 0] = c * cb
    box[2, 1] = c * (ca - cb * cg) / sg
    box[2, 2] = math.sqrt(max(c * c - box[2, 0] ** 2 - box[2, 1] ** 2, 0.0))
    # squash numerical dust so rectangular cells stay exactly diagonal
    box[np.abs(box) < 1e-9] = 0.0
    return box


def parse_pdb(text: str, model: int = 0):
    """Returns (names, resnames, x (N,3) nm, v=None, box (3,3) nm) for
    the model-th MODEL (or the whole file when no MODEL records).
    Velocities don't exist in PDB; the tuple matches read_gro's."""
    names: List[str] = []
    resnames: List[str] = []
    xs: List[List[float]] = []
    box = np.zeros((3, 3))
    cur_model = 0
    seen_model = False
    for line in text.splitlines():
        rec = line[:6]
        if rec == "CRYST1":
            a, b, c = (float(line[6:15]), float(line[15:24]),
                       float(line[24:33]))
            al, be, ga = (float(line[33:40]), float(line[40:47]),
                          float(line[47:54]))
            box = box_from_cryst1(a * _A2NM, b * _A2NM, c * _A2NM,
                                  al, be, ga)
        elif rec == "MODEL ":
            if seen_model:
                cur_model += 1
            seen_model = True
        elif rec in ("ATOM  ", "HETATM") and cur_model == model:
            names.append(line[12:16].strip())
            resnames.append(line[17:21].strip())
            xs.append([float(line[30:38]) * _A2NM,
                       float(line[38:46]) * _A2NM,
                       float(line[46:54]) * _A2NM])
        elif rec == "ENDMDL" and cur_model == model and xs:
            break
    if not xs:
        raise ValueError(f"no ATOM records (model {model})")
    return names, resnames, np.asarray(xs, np.float64), None, box


def read_pdb(path: str, model: int = 0):
    with open(path) as f:
        return parse_pdb(f.read(), model)


def read_structure(path: str):
    """Extension-dispatched coordinate reader: .gro or .pdb, returning the
    read_gro tuple (names, resnames, x, v-or-None, box).  .g96 raises: its
    reader is not ported yet (ROADMAP item 8)."""
    low = path.lower()
    if low.endswith(".pdb"):
        return read_pdb(path)
    if low.endswith(".g96"):
        raise NotImplementedError(f"{path}: .g96 input is not ported yet "
                                  "(ROADMAP item 8)")
    from .groio import read_gro
    return read_gro(path)
