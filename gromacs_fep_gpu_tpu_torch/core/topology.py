"""Host-side topology construction — PyTorch counterpart of
gromacs_fep_gpu_tpu/core/topology.py (MoleculeType, build_system,
lj_table_from_sigma_eps).

Only the parts of a molecule template the solvation-FEP path uses are
ported: per-atom A/B data, harmonic bonds and angles, 1-4 pairs, SETTLE
groups and exclusions from the bond graph.  MoleculeType has no field for
any other interaction class yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import InteractionList, SettleGroups, System
from .units import ONE_4PI_EPS0

_TERM_SHAPES = {"bonds": (2, 2), "angles": (3, 2)}


@dataclasses.dataclass
class MoleculeType:
    """One molecule template with optional B (perturbed) state."""
    name: str
    types_a: List[int]
    charges_a: List[float]
    masses_a: List[float]
    types_b: Optional[List[int]] = None
    charges_b: Optional[List[float]] = None
    masses_b: Optional[List[float]] = None
    # (atom indices, params_a[, params_b]); params_b missing => = A
    bonds: List[Tuple] = dataclasses.field(default_factory=list)
    angles: List[Tuple] = dataclasses.field(default_factory=list)
    # 1-4 pairs: ((i, j), (qi*qj, c6, c12)[, B-state params])
    pairs14: List[Tuple] = dataclasses.field(default_factory=list)
    settle: Optional[Tuple[int, int, int, float, float]] = None
    extra_exclusions: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    nrexcl: int = 3

    @property
    def n_atoms(self) -> int:
        return len(self.types_a)

    def bond_graph_edges(self) -> List[Tuple[int, int]]:
        edges = [(int(b[0][0]), int(b[0][1])) for b in self.bonds]
        if self.settle is not None:
            o, h1, h2 = self.settle[:3]
            edges += [(o, h1), (o, h2), (h1, h2)]
        return edges

    def generate_exclusions(self) -> List[set]:
        """All atom pairs within nrexcl bonds, plus extras."""
        n = self.n_atoms
        adj = [set() for _ in range(n)]
        for i, j in self.bond_graph_edges():
            adj[i].add(j)
            adj[j].add(i)
        excl = [set() for _ in range(n)]
        for i in range(n):
            frontier = {i}
            seen = {i}
            for _ in range(self.nrexcl):
                frontier = set().union(*(adj[a] for a in frontier)) - seen
                seen |= frontier
            excl[i] = seen - {i}
        for i, j in self.extra_exclusions:
            excl[i].add(j)
            excl[j].add(i)
        return excl


def lj_table_from_sigma_eps(sigma: Sequence[float], eps: Sequence[float],
                            comb_rule: int = 2) -> np.ndarray:
    """(T, T, 2) c6/c12 table from per-type sigma/epsilon (float32)."""
    sigma = np.asarray(sigma, np.float64)
    eps = np.asarray(eps, np.float64)
    if comb_rule == 2:   # Lorentz-Berthelot
        sij = 0.5 * (sigma[:, None] + sigma[None, :])
        eij = np.sqrt(eps[:, None] * eps[None, :])
    elif comb_rule == 3:  # geometric on sigma and eps
        sij = np.sqrt(sigma[:, None] * sigma[None, :])
        eij = np.sqrt(eps[:, None] * eps[None, :])
    else:
        raise ValueError(comb_rule)
    s6 = sij ** 6
    c6 = 4.0 * eij * s6
    c12 = 4.0 * eij * s6 * s6
    return np.stack([c6, c12], axis=-1).astype(np.float32)


def _pad_rows(rows, k: int, p: int, dev) -> InteractionList:
    n = len(rows)
    atoms = np.zeros((n, k), np.int64)
    pa = np.zeros((n, p), np.float32)
    pb = np.zeros((n, p), np.float32)
    for r, (idx, par_a, par_b) in enumerate(rows):
        atoms[r] = idx
        pa[r] = par_a
        pb[r] = par_a if par_b is None else par_b
    return InteractionList(
        atoms=torch.as_tensor(atoms, device=dev),
        params_a=torch.as_tensor(pa, device=dev),
        params_b=torch.as_tensor(pb, device=dev),
        mask=torch.ones((n,), device=dev))


def build_system(molecules: Sequence[Tuple[MoleculeType, int]],
                 nbfp: np.ndarray, device="cuda", fudge_qq: float = 1.0,
                 epsilon_r: float = 1.0) -> System:
    """Flatten (molecule, count) blocks into one System on `device`.
    The 1-4 charge products are scaled by epsfac * fudge_qq once here."""
    dev = torch.device(device)
    epsfac = ONE_4PI_EPS0 / epsilon_r
    pair14_rows = []
    qa, qb, ta, tb, ma, mb = [], [], [], [], [], []
    excl_sets: List[set] = []
    term_rows = {k: [] for k in _TERM_SHAPES}
    settle_rows = []
    offset = 0
    for mol, count in molecules:
        nm = mol.n_atoms
        cb = mol.charges_b if mol.charges_b is not None else mol.charges_a
        tbv = mol.types_b if mol.types_b is not None else mol.types_a
        mbv = mol.masses_b if mol.masses_b is not None else mol.masses_a
        mol_excl = mol.generate_exclusions()
        for _ in range(count):
            qa += list(mol.charges_a)
            qb += list(cb)
            ta += list(mol.types_a)
            tb += list(tbv)
            ma += list(mol.masses_a)
            mb += list(mbv)
            excl_sets += [{e + offset for e in s} for s in mol_excl]
            for name in _TERM_SHAPES:
                for row in getattr(mol, name):
                    idx = tuple(int(a) + offset for a in row[0])
                    term_rows[name].append(
                        (idx, row[1], row[2] if len(row) > 2 else None))
            for row in mol.pairs14:
                idx = tuple(int(a) + offset for a in row[0])
                scaled = [None if par is None else
                          (par[0] * epsfac * fudge_qq, par[1], par[2])
                          for par in (row[1],
                                      row[2] if len(row) > 2 else None)]
                pair14_rows.append((idx, scaled[0], scaled[1]))
            if mol.settle is not None:
                o, h1, h2, doh, dhh = mol.settle
                settle_rows.append(((o + offset, h1 + offset, h2 + offset),
                                    doh, dhh))
            offset += nm

    n = offset
    max_excl = max(max((len(s) for s in excl_sets), default=1), 1)
    excl = np.full((n, max_excl), -1, np.int64)
    for i, s in enumerate(excl_sets):
        for k, e in enumerate(sorted(s)):
            excl[i, k] = e
    bonded = {name: _pad_rows(rows, *_TERM_SHAPES[name], dev)
              for name, rows in term_rows.items() if rows}
    ns = len(settle_rows)
    settle = SettleGroups(
        atoms=torch.as_tensor(np.array([r[0] for r in settle_rows],
                                       np.int64).reshape(ns, 3), device=dev),
        d_oh=torch.as_tensor(np.array([r[1] for r in settle_rows],
                                      np.float32), device=dev),
        d_hh=torch.as_tensor(np.array([r[2] for r in settle_rows],
                                      np.float32), device=dev),
        mask=torch.ones((ns,), device=dev))
    qa = np.asarray(qa, np.float32)
    qb = np.asarray(qb, np.float32)
    ta_ = np.asarray(ta, np.int64)
    tb_ = np.asarray(tb, np.int64)
    ma_ = np.asarray(ma, np.float32)
    mb_ = np.asarray(mb, np.float32)
    perturbed = (qa != qb) | (ta_ != tb_) | (ma_ != mb_)

    def t(a):
        return torch.as_tensor(a, device=dev)
    return System(charge_a=t(qa), charge_b=t(qb), type_a=t(ta_),
                  type_b=t(tb_), mass_a=t(ma_), mass_b=t(mb_),
                  perturbed=t(perturbed),
                  nbfp=t(np.asarray(nbfp, np.float32)), exclusions=t(excl),
                  bonded=bonded, settle=settle, n_atoms=n,
                  pairs14=(_pad_rows(pair14_rows, 2, 3, dev)
                           if pair14_rows else None))
