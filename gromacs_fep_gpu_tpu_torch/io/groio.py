"""gro coordinate file reader/writer — PyTorch-port copy of
gromacs_fep_gpu_tpu/io/groio.py (read_gro, write_gro; numpy only)
(reference: src/gromacs/fileio/groio.cpp — fixed-column GROMOS87
format)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def read_gro(path: str):
    """Returns (names, resnames, x (N,3), v (N,3) or None, box (3,3))."""
    with open(path) as f:
        lines = f.read().splitlines()
    try:
        natoms = int(lines[1].split()[0])
        if len(lines) < 3 + natoms:
            raise ValueError(f"truncated: {natoms} atoms declared, "
                             f"{len(lines)} lines")
    except (ValueError, IndexError) as e:
        raise ValueError(f"{path} is not a .gro file: {e}") from None
    names, resnames = [], []
    x = np.zeros((natoms, 3))
    v = np.zeros((natoms, 3))
    have_v = False
    for i in range(natoms):
        ln = lines[2 + i]
        resnames.append(ln[5:10].strip())
        names.append(ln[10:15].strip())
        x[i] = [float(ln[20:28]), float(ln[28:36]), float(ln[36:44])]
        if len(ln) >= 68:
            v[i] = [float(ln[44:52]), float(ln[52:60]), float(ln[60:68])]
            have_v = True
    bvals = [float(t) for t in lines[2 + natoms].split()]
    box = np.zeros((3, 3))
    box[0, 0], box[1, 1], box[2, 2] = bvals[0], bvals[1], bvals[2]
    if len(bvals) == 9:
        (box[0, 1], box[0, 2], box[1, 0],
         box[1, 2], box[2, 0], box[2, 1]) = bvals[3:9]
    return names, resnames, x, (v if have_v else None), box


def write_gro(path: str, title: str, names: List[str], resnames: List[str],
              x: np.ndarray, v: Optional[np.ndarray], box: np.ndarray,
              resids: Optional[List[int]] = None):
    n = len(names)
    x = np.asarray(x)
    with open(path, "w") as f:
        f.write(title + "\n")
        f.write(f"{n:5d}\n")
        for i in range(n):
            rid = (resids[i] if resids is not None else i + 1) % 100000
            line = (f"{rid:5d}{resnames[i]:<5.5s}{names[i]:>5.5s}"
                    f"{(i + 1) % 100000:5d}"
                    f"{x[i, 0]:8.3f}{x[i, 1]:8.3f}{x[i, 2]:8.3f}")
            if v is not None:
                line += f"{v[i, 0]:8.4f}{v[i, 1]:8.4f}{v[i, 2]:8.4f}"
            f.write(line + "\n")
        b = np.asarray(box)
        vals = [b[0, 0], b[1, 1], b[2, 2]]
        if np.abs(b - np.diag(np.diag(b))).max() > 0:
            vals += [b[0, 1], b[0, 2], b[1, 0], b[1, 2], b[2, 0], b[2, 1]]
        f.write(" ".join(f"{val:10.5f}" for val in vals) + "\n")
