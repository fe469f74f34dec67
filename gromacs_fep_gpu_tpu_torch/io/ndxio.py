"""GROMACS .ndx index-file reader — PyTorch-port copy of
gromacs_fep_gpu_tpu/io/ndxio.py (parse_ndx, read_ndx, default_groups,
resolve_group; numpy only).

Reference: src/gromacs/topology/index.cpp (init_index / write_index) —
`[ name ]` sections of whitespace-separated 1-based atom indices, with
optional range notation not used by gmx itself (plain lists only).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def parse_ndx(text: str) -> Dict[str, np.ndarray]:
    """name -> 0-based atom index array (the text stores 1-based)."""
    groups: Dict[str, List[int]] = {}
    current = None
    for raw in text.splitlines():
        line = raw.split(";")[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            current = line[1:-1].strip()
            groups.setdefault(current, [])
            continue
        if current is None:
            raise ValueError("ndx: indices before any [ group ]")
        for tok in line.split():
            groups[current].append(int(tok) - 1)
    return {k: np.asarray(v, np.int32) for k, v in groups.items()}


def read_ndx(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        return parse_ndx(f.read())


def default_groups(atom_names: Sequence[str],
                   res_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """The automatic groups gmx make_ndx seeds (analysegroups):
    System, Water (SOL residues), non-Water."""
    n = len(atom_names)
    res = [r.strip() for r in res_names]
    water = np.asarray([i for i in range(n)
                        if res[i] in ("SOL", "WAT", "HOH")], np.int32)
    nonw = np.asarray([i for i in range(n)
                       if res[i] not in ("SOL", "WAT", "HOH")], np.int32)
    out = {"System": np.arange(n, dtype=np.int32)}
    if water.size:
        out["Water"] = water
    if nonw.size:
        out["non-Water"] = nonw
    return out


def resolve_group(spec: str, ndx: Dict[str, np.ndarray],
                  n_atoms: int) -> np.ndarray:
    """A group reference: a name from the .ndx / defaults, or an inline
    whitespace list of 1-based indices."""
    if spec in ndx:
        g = ndx[spec]
        if g.size and (g.min() < 0 or g.max() >= n_atoms):
            raise ValueError(f"group '{spec}' has out-of-range atoms")
        return g
    toks = spec.split()
    if toks and all(t.lstrip("-").isdigit() for t in toks):
        g = np.asarray([int(t) - 1 for t in toks], np.int32)
        if g.size and (g.min() < 0 or g.max() >= n_atoms):
            raise ValueError(f"inline group '{spec}' out of range")
        return g
    raise ValueError(f"unknown index group '{spec}' "
                     f"(available: {sorted(ndx)})")
