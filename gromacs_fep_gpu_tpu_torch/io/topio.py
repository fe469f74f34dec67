"""GROMACS .top parser — PyTorch-port counterpart of
gromacs_fep_gpu_tpu/io/topio.py (parse_top, _resolve_molecule,
convert_moltype_couple, decouple_moltype, make_hbond_constraints,
system_from_top; reference: src/gromacs/gmxpreprocess/topio.cpp +
toppush.cpp, couple-moltype from toppush.cpp:2726 convert_moltype_couple,
constraints = h-bonds | all-bonds from topshake.cpp make_shake).

The numpy code is a copy, cut to what the port's MoleculeType
(core/topology.py) can hold: the cpp subset (#include, #define,
#ifdef/#ifndef/#else/#endif), [ defaults ] with combination rules 1-3,
gen-pairs, fudgeLJ and fudgeQQ, [ atomtypes ] (ptype A), [ nonbond_params ],
[ bondtypes ], [ angletypes ], [ dihedraltypes ] (funct 1/2/3/4/9,
wildcards, the 2- and 4-atom forms), [ pairtypes ], [ constrainttypes ],
[ moleculetype ], [ atoms ] with B-state columns, [ bonds ] (funct 1, 10),
[ angles ] (funct 1, 5), [ dihedrals ] (funct 1/2/3/4/9), [ pairs ] (funct
1), [ constraints ] (funct 1, 2, with B lengths), [ settles ],
[ exclusions ], [ position_restraints ] (funct 1 with A/B force constants,
funct 2 flat-bottomed), [ dihedral_restraints ], [ angle_restraints ],
[ system ] and [ molecules ].  Rows without parameters resolve against the
bonded-type databases as grompp does: canonical atom order by bonded-type
id, the most exact wildcard dihedral match (every line of it for funct 9,
in file order), the B state through the B atom types with a fall-back to
A and a warning for perturbed atoms.

Every other directive that carries interactions, and every other function
type, raises NotImplementedError naming it (distance and orientation
restraints, CMAP, virtual sites, ...): the port never drops an
interaction silently, where the JAX parser drops a directive it does not
know ([ pairs_nb ], [ intermolecular_interactions ]).  Type-database
directives whose entries only such rows could use ([ cmaptypes ],
[ implicit_genborn_params ]) are read past.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.topology import MoleculeType, build_system
from ..core.types import System


@dataclasses.dataclass
class AtomType:
    name: str
    btype: str            # bonded type name (defaults to name)
    atnum: int
    mass: float
    charge: float
    ptype: str
    v: float              # sigma (rule 2/3) or c6 (rule 1)
    w: float              # eps   (rule 2/3) or c12 (rule 1)
    index: int


# A-state force parameters per (directive, funct) the port can hold
_NPARAM = {
    ("bonds", 1): 2,
    ("bonds", 10): 4,
    ("angles", 1): 2,
    ("angles", 5): 4,
    ("dihedrals", 1): 3,
    ("dihedrals", 9): 3,
    ("dihedrals", 4): 3,
    ("dihedrals", 2): 2,
    ("dihedrals", 3): 6,
    ("pairs", 1): 2,
    ("constraints", 1): 1,
    ("constraints", 2): 1,
    ("dihedral_restraints", 1): 3,
    ("angle_restraints", 1): 3,
}

# atoms per row of each interaction directive the port reads
_ARITY = {"bonds": 2, "pairs": 2, "angles": 3, "dihedrals": 4,
          "constraints": 2, "dihedral_restraints": 4,
          "angle_restraints": 4}

# dihedral funct -> type-database group (F_PDIHS covers funct 1 and 9)
_DIH_GROUP = {1: "pdihs", 9: "pdihs", 2: "idihs", 3: "rbdihs", 4: "pidihs"}

_NO_JAX = ("the JAX package has no counterpart: its parser drops the "
           "directive silently")

# directives whose rows the port's MoleculeType has no field for, with
# what lifts each
_UNPORTED = {
    "angle_restraints_z": _NO_JAX,
    "distance_restraints": "ROADMAP slice 15",
    "orientation_restraints": "ROADMAP slice 15",
    "cmap": "ROADMAP slice 15", "polarization": "ROADMAP slice 15",
    "water_polarization": "ROADMAP slice 15",
    "thole_polarization": "ROADMAP slice 15",
    "virtual_sites1": "ROADMAP item 6", "virtual_sites2": "ROADMAP item 6",
    "virtual_sites3": "ROADMAP item 6", "virtual_sites4": "ROADMAP item 6",
    "virtual_sitesn": "ROADMAP item 6", "pairs_nb": _NO_JAX,
    "intermolecular_interactions": _NO_JAX,
}

# type databases of interactions the port cannot hold: read past (any
# molecule row that would use them raises)
_SKIPPED_DB = ("cmaptypes", "implicit_genborn_params")

_SECTIONS = ("defaults", "atomtypes", "nonbond_params", "bondtypes",
             "angletypes", "dihedraltypes", "pairtypes", "constrainttypes",
             "moleculetype",
             "atoms", "settles", "exclusions", "position_restraints",
             "system", "molecules") + tuple(_ARITY) + _SKIPPED_DB


class BondedDB:
    """Type databases keyed by canonicalized bonded-type-id tuples."""

    def __init__(self):
        self.bt_ids: Dict[str, int] = {}
        self.bonds: Dict[Tuple[int, int], Tuple] = {}
        self.angles: Dict[Tuple[int, int, int], Tuple] = {}
        self.pairs: Dict[Tuple[int, int], Tuple] = {}
        self.constraints: Dict[Tuple[int, int], Tuple] = {}
        # group -> [(4 type ids, -1 = wildcard X, params)] in file order
        self.dihedrals: Dict[str, List[Tuple]] = {
            g: [] for g in ("pdihs", "idihs", "rbdihs", "pidihs")}

    def bt_id(self, name: str) -> int:
        if name == "X":
            return -1
        if name not in self.bt_ids:
            self.bt_ids[name] = len(self.bt_ids)
        return self.bt_ids[name]

    @staticmethod
    def canon2(k):
        return k if k[0] <= k[1] else (k[1], k[0])

    @staticmethod
    def canon3(k):
        return k if k[0] <= k[2] else (k[2], k[1], k[0])

    @staticmethod
    def canon4(k):
        # reference: grompp.cpp sortDihedralAtomIds (reverse if al < ai)
        return k if k[0] <= k[3] else (k[3], k[2], k[1], k[0])

    def add(self, section: str, names: List[str], funct: int, params: Tuple):
        ids = tuple(self.bt_id(n) for n in names)
        if section == "bondtypes":
            self.bonds[self.canon2(ids)] = params
        elif section == "angletypes":
            self.angles[self.canon3(ids)] = params
        elif section == "pairtypes":
            self.pairs[self.canon2(ids)] = params
        elif section == "constrainttypes":
            self.constraints[self.canon2(ids)] = params
        elif section == "dihedraltypes":
            if len(names) == 2:   # two-atom form: X-a-b-X on the inner pair
                ids = (-1, ids[0], ids[1], -1)
            # a funct no row can use (every [ dihedrals ] funct outside
            # _NPARAM raises) is kept under its own key, never looked up
            group = _DIH_GROUP.get(funct, f"funct {funct}")
            self.dihedrals.setdefault(group, []).append((self.canon4(ids),
                                                         params))

    def lookup_dihedral_terms(self, group: str, ids4) -> List[Tuple]:
        """Every database line of the most exact wildcard match, in file
        order, trying both orientations (canon4 cannot orient X-a-b-X
        lines; reference: toppush.cpp:1757 defaultInteractionsOfType).  An
        exact type scores over a wildcard; the first key to reach the best
        score wins."""
        key = self.canon4(tuple(ids4))
        best, best_n = None, -1
        for tids, _ in self.dihedrals[group]:
            for cand in (key, key[::-1]):
                n = 0
                for t, a in zip(tids, cand):
                    if t == a:
                        n += 1
                    elif t != -1:
                        break
                else:
                    if n > best_n:
                        best, best_n = tids, n
        return [] if best is None else [p for t, p in self.dihedrals[group]
                                        if t == best]


@dataclasses.dataclass
class ParsedTop:
    system_name: str
    molecules: List[Tuple[str, int]]
    moltypes: Dict[str, MoleculeType]
    atomtypes: Dict[str, AtomType]
    nbfp: np.ndarray
    fudge_lj: float
    fudge_qq: float
    comb_rule: int


def _strip(line: str) -> str:
    return line.split(";")[0].strip()


def _preprocess(text: str, include_dirs: List[str],
                defines: Optional[Dict[str, str]] = None) -> List[str]:
    """Minimal cpp: #include (from include_dirs), #define constants,
    #ifdef/#ifndef/#else/#endif.  A missing include raises."""
    defines = dict(defines or {})
    out: List[str] = []
    skip_stack: List[bool] = []

    def process(lines, cur_dir=None):
        for raw in lines:
            line = raw.rstrip("\n")
            s = line.strip()
            if s.startswith("#"):
                parts = s.split()
                if parts[0] == "#ifdef":
                    skip_stack.append(parts[1] not in defines)
                elif parts[0] == "#ifndef":
                    skip_stack.append(parts[1] in defines)
                elif parts[0] == "#else":
                    if skip_stack:
                        skip_stack[-1] = not skip_stack[-1]
                elif parts[0] == "#endif":
                    if skip_stack:
                        skip_stack.pop()
                elif any(skip_stack):
                    continue
                elif parts[0] == "#undef":
                    defines.pop(parts[1], None)
                elif parts[0] == "#define":
                    defines[parts[1]] = (" ".join(parts[2:])
                                         if len(parts) > 2 else "1")
                elif parts[0] == "#include":
                    # like cpp: the including file's own directory is
                    # searched first (gmxpreprocess/gmxcpp.cpp)
                    name = parts[1].strip('"<>')
                    dirs = ([cur_dir] if cur_dir else []) + include_dirs
                    for d in dirs:
                        p = os.path.join(d, name)
                        if os.path.exists(p):
                            with open(p) as f:
                                process(f.readlines(), os.path.dirname(p))
                            break
                    else:
                        raise FileNotFoundError(
                            f"top: #include {name} not found in {dirs}")
                else:
                    raise NotImplementedError(
                        f"top: preprocessor directive {parts[0]} is not "
                        "ported yet")
                continue
            if any(skip_stack):
                continue
            # substitute defines (token-wise)
            if defines and s:
                toks = line.split()
                line = " ".join(defines.get(t, t) for t in toks)
            out.append(line)

    process(text.splitlines())
    return out


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _parse_atomtype_line(t: List[str], index: int) -> AtomType:
    """Column-count-flexible atomtypes row
    (reference: toppush.cpp push_at field detection).

    Formats: name [btype] [atnum] mass charge ptype V W
    """
    name = t[0]
    # locate ptype: single letter A/S/V/D followed by >= 2 floats
    pt_idx = None
    for i in range(1, len(t) - 2):
        if t[i].upper() in ("A", "S", "V", "D") and not _is_float(t[i]) \
                and _is_float(t[i + 1]) and _is_float(t[i + 2]):
            pt_idx = i
    if pt_idx is None or pt_idx < 3:
        # no btype/atnum columns: name mass charge ptype V W
        pt_idx = 3
    mass = float(t[pt_idx - 2])
    charge = float(t[pt_idx - 1])
    ptype = t[pt_idx].upper()
    v, w = float(t[pt_idx + 1]), float(t[pt_idx + 2])
    mid = t[1:pt_idx - 2]
    btype, atnum = name, 0
    if len(mid) == 2:
        btype, atnum = mid[0], int(mid[1])
    elif len(mid) == 1:
        if _is_float(mid[0]):
            atnum = int(float(mid[0]))
        else:
            btype = mid[0]
    return AtomType(name, btype, atnum, mass, charge, ptype, v, w, index)


def _combine_lj(at_i: AtomType, at_j: AtomType, comb_rule: int
                ) -> Tuple[float, float]:
    """(c6, c12) from two atom types (reference: convparm.cpp)."""
    if comb_rule == 1:
        return (math.sqrt(at_i.v * at_j.v), math.sqrt(at_i.w * at_j.w))
    if comb_rule == 2:
        sij = 0.5 * (at_i.v + at_j.v)
    else:
        sij = math.sqrt(at_i.v * at_j.v)
    eij = math.sqrt(at_i.w * at_j.w)
    return (4.0 * eij * sij ** 6, 4.0 * eij * sij ** 12)


def _c6c12(v: float, w: float, comb_rule: int) -> Tuple[float, float]:
    """A pair parameter row: (c6, c12) as given (rule 1) or from sigma,
    epsilon (rules 2 and 3)."""
    if comb_rule == 1:
        return (v, w)
    return (4 * w * v ** 6, 4 * w * v ** 12)


@dataclasses.dataclass
class _RawMol:
    """Unresolved molecule body (resolved against the DBs at the end)."""
    name: str
    nrexcl: int
    atoms: List[Tuple] = dataclasses.field(default_factory=list)
    # each row: (section, funct, idx tuple, explicit float list)
    rows: List[Tuple] = dataclasses.field(default_factory=list)
    settle: Optional[Tuple] = None
    exclusions: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # (ai, (kx, ky, kz) A, B) and (ai, (geom, r, k))
    posres: List[Tuple] = dataclasses.field(default_factory=list)
    fbposres: List[Tuple] = dataclasses.field(default_factory=list)


def parse_top(text: str, include_dirs: Optional[List[str]] = None,
              defines: Optional[Dict[str, str]] = None) -> ParsedTop:
    lines = _preprocess(text, include_dirs or [], defines)
    section = None
    fudge_lj, fudge_qq, comb_rule = 1.0, 1.0, 2
    gen_pairs = False
    atomtypes: Dict[str, AtomType] = {}
    nb_override: Dict[Tuple[str, str], Tuple[float, float]] = {}
    db = BondedDB()
    raw_mols: Dict[str, _RawMol] = {}
    cur: Optional[_RawMol] = None
    system_name = "system"
    molecules: List[Tuple[str, int]] = []

    for line in lines:
        s = _strip(line)
        if not s:
            continue
        m = re.match(r"\[\s*(\S+)\s*\]", s)
        if m:
            section = m.group(1).lower()
            if section in _UNPORTED:
                where = f" in molecule {cur.name}" if cur else ""
                raise NotImplementedError(
                    f"top: [ {section} ]{where} is not ported yet "
                    f"({_UNPORTED[section]})")
            if section not in _SECTIONS:
                raise NotImplementedError(
                    f"top: directive [ {section} ] is not ported yet")
            continue
        t = s.split()
        if section == "defaults":
            # nbfunc comb-rule [gen-pairs [fudgeLJ [fudgeQQ]]]
            if int(t[0]) != 1:
                raise NotImplementedError(
                    f"top: [ defaults ] nbfunc {t[0]} (Buckingham) is not "
                    "ported yet")
            comb_rule = int(t[1])
            if comb_rule not in (1, 2, 3):
                raise ValueError(f"top: combination rule {comb_rule}")
            if len(t) > 2:
                gen_pairs = t[2].lower() in ("yes", "true", "1")
            if len(t) > 3:
                fudge_lj = float(t[3])
            if len(t) > 4:
                fudge_qq = float(t[4])
        elif section == "atomtypes":
            at = _parse_atomtype_line(t, len(atomtypes))
            atomtypes[at.name] = at
            db.bt_id(at.btype)
        elif section == "nonbond_params":
            if int(t[2]) != 1:
                raise NotImplementedError(
                    f"top: [ nonbond_params ] funct {t[2]} is not ported yet")
            nb_override[(t[0], t[1])] = (float(t[3]), float(t[4]))
        elif section in ("bondtypes", "angletypes", "pairtypes",
                         "constrainttypes"):
            na = {"bondtypes": 2, "angletypes": 3, "pairtypes": 2,
                  "constrainttypes": 2}[section]
            db.add(section, t[:na], int(t[na]),
                   tuple(float(v) for v in t[na + 1:]))
        elif section == "dihedraltypes":
            # the 4-atom or the legacy 2-atom form; funct follows the names
            na = 4 if (len(t) > 4 and not _is_float(t[2])
                       and not _is_float(t[3])) else 2
            db.add(section, t[:na], int(t[na]),
                   tuple(float(v) for v in t[na + 1:]))
        elif section in _SKIPPED_DB:
            continue
        elif section == "moleculetype":
            cur = _RawMol(name=t[0], nrexcl=int(t[1]))
            raw_mols[cur.name] = cur
        elif section == "atoms":
            # nr type resnr residue atom cgnr [charge [mass [typeB
            # [chargeB [massB]]]]]
            tname = t[1]
            at = atomtypes[tname]
            charge = float(t[6]) if len(t) > 6 else at.charge
            mass = float(t[7]) if len(t) > 7 else at.mass
            if len(t) > 8:
                tb = t[8]
                qb = float(t[9]) if len(t) > 9 else atomtypes[tb].charge
                mb = float(t[10]) if len(t) > 10 else atomtypes[tb].mass
            else:
                tb, qb, mb = tname, charge, mass
            for nm in (tname, tb):
                if atomtypes[nm].ptype != "A":
                    raise NotImplementedError(
                        f"top: atom type {nm} of ptype "
                        f"{atomtypes[nm].ptype} (shell or virtual site) is "
                        "not ported yet (ROADMAP item 6)")
            cur.atoms.append((tname, charge, mass, tb, qb, mb, t[4]))
        elif section in _ARITY:
            k = _ARITY[section]
            idx = tuple(int(v) - 1 for v in t[:k])
            funct = int(t[k])
            if (section, funct) not in _NPARAM:
                raise NotImplementedError(
                    f"top: [ {section} ] funct {funct} in molecule "
                    f"{cur.name} is not supported (nor by the JAX package)")
            cur.rows.append((section, funct, idx,
                             [float(v) for v in t[k + 1:]]))
        elif section == "position_restraints":
            ai, funct = int(t[0]) - 1, int(t[1])
            vals = [float(v) for v in t[2:]]
            if funct == 2:      # flat-bottomed: geom r k
                cur.fbposres.append((ai, tuple(vals[:3])))
            elif funct == 1:    # kx ky kz [kxB kyB kzB]
                ka = tuple(vals[:3])
                cur.posres.append((ai, ka, tuple(vals[3:6])
                                   if len(vals) >= 6 else ka))
            else:
                raise NotImplementedError(
                    f"top: [ position_restraints ] funct {funct} in "
                    f"molecule {cur.name} is not supported (nor by the JAX "
                    "package)")
        elif section == "settles":
            ow = int(t[0]) - 1
            cur.settle = (ow, ow + 1, ow + 2, float(t[2]), float(t[3]))
        elif section == "exclusions":
            ai = int(t[0]) - 1
            for v in t[1:]:
                cur.exclusions.append((ai, int(v) - 1))
        elif section == "system":
            system_name = s
        elif section == "molecules":
            molecules.append((t[0], int(t[1])))

    # ---- LJ table from atomtypes ----
    T = len(atomtypes)
    names = [None] * T
    for at in atomtypes.values():
        names[at.index] = at.name
    nbfp = np.zeros((T, T, 2), np.float64)
    for i in range(T):
        for j in range(T):
            nbfp[i, j] = _combine_lj(atomtypes[names[i]], atomtypes[names[j]],
                                     comb_rule)
    for (na, nb_), (v, w) in nb_override.items():
        i, j = atomtypes[na].index, atomtypes[nb_].index
        nbfp[i, j] = nbfp[j, i] = _c6c12(v, w, comb_rule)

    # ---- resolve molecule bodies against the databases ----
    moltypes = {raw.name: _resolve_molecule(raw, atomtypes, db, comb_rule,
                                            fudge_lj, gen_pairs)
                for raw in raw_mols.values()}
    return ParsedTop(system_name=system_name, molecules=molecules,
                     moltypes=moltypes, atomtypes=atomtypes,
                     nbfp=nbfp.astype(np.float32), fudge_lj=fudge_lj,
                     fudge_qq=fudge_qq, comb_rule=comb_rule)


def _resolve_molecule(raw: _RawMol, atomtypes: Dict[str, AtomType],
                      db: BondedDB, comb_rule: int, fudge_lj: float,
                      gen_pairs: bool) -> MoleculeType:
    mol = MoleculeType(name=raw.name, types_a=[], charges_a=[], masses_a=[],
                       types_b=[], charges_b=[], masses_b=[],
                       nrexcl=raw.nrexcl,
                       atom_names=[a[6] for a in raw.atoms])
    bt_a, bt_b = [], []            # per-atom bonded-type ids
    for (tname, q, m_, tb, qb, mb, _) in raw.atoms:
        mol.types_a.append(atomtypes[tname].index)
        mol.types_b.append(atomtypes[tb].index)
        mol.charges_a.append(q)
        mol.charges_b.append(qb)
        mol.masses_a.append(m_)
        mol.masses_b.append(mb)
        bt_a.append(db.bt_id(atomtypes[tname].btype))
        bt_b.append(db.bt_id(atomtypes[tb].btype))
    type_names_a = [a[0] for a in raw.atoms]
    type_names_b = [a[3] for a in raw.atoms]

    def pert(idx) -> bool:
        """PERTURBED(atom) over any atom of the interaction."""
        return any(mol.types_a[i] != mol.types_b[i]
                   or mol.charges_a[i] != mol.charges_b[i]
                   or mol.masses_a[i] != mol.masses_b[i] for i in idx)

    def pair_lookup(key, names_):
        hit = db.pairs.get(key)
        if hit is not None:
            return _c6c12(hit[0], hit[1], comb_rule)
        if gen_pairs:
            # generate from atomtypes, scaled by fudgeLJ
            # (reference: toppush.cpp generate_nbparams gen-pairs)
            c6, c12 = _combine_lj(atomtypes[names_[0]], atomtypes[names_[1]],
                                  comb_rule)
            return (fudge_lj * c6, fudge_lj * c12)
        return None

    for (section, funct, idx, vals) in raw.rows:
        npA = _NPARAM[(section, funct)]
        if section == "pairs":
            if len(vals) >= 2:
                pa = _c6c12(vals[0], vals[1], comb_rule)
                pb = (_c6c12(vals[2], vals[3], comb_rule)
                      if len(vals) >= 4 else pa)
            else:
                pa = pair_lookup(db.canon2((bt_a[idx[0]], bt_a[idx[1]])),
                                 [type_names_a[i] for i in idx])
                if pa is None:
                    raise ValueError(f"{raw.name}: no pairtype for pair "
                                     f"{idx}")
                pb = pair_lookup(db.canon2((bt_b[idx[0]], bt_b[idx[1]])),
                                 [type_names_b[i] for i in idx]) or pa
            mol.pairs_raw.append((idx[0], idx[1], pa, pb))
            continue
        if len(vals) >= npA:
            pa = tuple(vals[:npA])
            if len(vals) >= 2 * npA:
                pb = tuple(vals[npA:2 * npA])
            else:
                pb = pa
                if pert(idx) and section != "constraints":
                    warnings.warn(
                        f"{raw.name}: {section} {idx} explicit A-state "
                        "parameters copied to B for perturbed atoms")
            terms = [(pa, pb)]
        else:
            terms = _db_lookup(db, section, funct, idx, bt_a, bt_b,
                               pert(idx), raw.name)
        for pa, pb in terms:
            _store_interaction(mol, section, funct, idx, pa, pb)

    mol.settle = raw.settle
    mol.extra_exclusions.extend(raw.exclusions)
    # the reference positions are grompp's (-r or the input conformation)
    for ai, ka, kb in raw.posres:
        mol.posres.append(((ai,), (0.0, 0.0, 0.0) + ka,
                           (0.0, 0.0, 0.0) + kb))
    for ai, (geom, r, k) in raw.fbposres:
        mol.fbposres.append(((ai,), (geom, 0.0, 0.0, 0.0, r, k)))
    return mol


def _db_lookup(db: BondedDB, section: str, funct: int, idx, bt_a, bt_b,
               perturbed: bool, mol_name: str) -> List[Tuple]:
    """A/B parameters of a row without explicit ones (reference:
    toppush.cpp:1990-2240 push_bond): a list of (pa, pb), longer than one
    only for a funct-9 dihedral whose type has several lines.  A perturbed
    row takes B from the B atom types, or A with a warning where they
    have no entry; A and B must then hold as many lines."""
    def one(bt) -> List[Tuple]:
        if section == "bonds":
            hit = db.bonds.get(db.canon2((bt[idx[0]], bt[idx[1]])))
        elif section == "angles":
            hit = db.angles.get(db.canon3((bt[idx[0]], bt[idx[1]],
                                           bt[idx[2]])))
        elif section == "constraints":
            hit = db.constraints.get(db.canon2((bt[idx[0]], bt[idx[1]])))
        elif section == "dihedrals":
            terms = db.lookup_dihedral_terms(_DIH_GROUP[funct],
                                             tuple(bt[i] for i in idx))
            # only funct 9 repeats (toppush.cpp bAllowRepeat)
            return terms if funct == 9 else terms[:1]
        else:               # restraints take no database entry
            hit = None
        return [] if hit is None else [hit]

    la = one(bt_a)
    if not la:
        raise ValueError(f"{mol_name}: no default {section} type for atoms "
                         f"{tuple(i + 1 for i in idx)}")
    lb = la
    if perturbed:
        lb = one(bt_b)
        if not lb:
            warnings.warn(
                f"{mol_name}: no default {section} type for perturbed "
                "atoms, using the same parameters for both states "
                "(grompp: toppush.cpp:2233)")
            lb = la
        elif len(lb) != len(la):
            raise ValueError(
                f"{mol_name}: perturbed {section} {tuple(i + 1 for i in idx)}"
                f" has {len(la)} A-state but {len(lb)} B-state multiple "
                "terms (reference errors likewise)")
    return list(zip(la, lb))


# (directive, funct) -> the MoleculeType field its rows go to
_FIELD = {("bonds", 1): "bonds", ("bonds", 10): "restrbonds",
          ("angles", 1): "angles", ("angles", 5): "ub",
          ("dihedrals", 1): "pdihs", ("dihedrals", 9): "pdihs",
          ("dihedrals", 4): "pdihs", ("dihedrals", 2): "idihs",
          ("dihedrals", 3): "rbdihs", ("dihedral_restraints", 1): "dihres",
          ("angle_restraints", 1): "angres"}


def _store_interaction(mol: MoleculeType, section: str, funct: int, idx,
                       pa: Tuple, pb: Tuple):
    """Append one resolved row to its MoleculeType field, each state's
    parameters padded with zeros to the term's count.  A constraint row
    is (i, j, lenA, lenB), with a fifth entry 2 for funct 2 (no
    exclusions)."""
    if section == "constraints":
        row = (idx[0], idx[1], pa[0], pb[0])
        mol.constraints.append(row if funct == 1 else row + (2,))
        return
    n = _NPARAM[(section, funct)]

    def pad(p):
        return tuple(p[:n]) + (0.0,) * max(0, n - len(p))
    getattr(mol, _FIELD[(section, funct)]).append((idx, pad(pa), pad(pb)))


# ---------------------------------------------------------------------------
# grompp transforms: 1-4 pair resolution, couple-moltype, h-bond
# constraints
# ---------------------------------------------------------------------------

def _finalize_pairs(mol: MoleculeType, fudge_qq: float):
    """Turn raw pair rows into pairs14 entries with final qq (fudge
    applied once here)."""
    for (ai, aj, pa, pb) in mol.pairs_raw:
        qa = fudge_qq * mol.charges_a[ai] * mol.charges_a[aj]
        qb = fudge_qq * mol.charges_b[ai] * mol.charges_b[aj]
        mol.pairs14.append(((ai, aj), (qa,) + tuple(pa), (qb,) + tuple(pb)))
    mol.pairs_raw = []


def convert_moltype_couple(mol: MoleculeType, decoupled_type: int,
                           fudge_qq: float, couple_lam0: str,
                           couple_lam1: str, intramol: bool,
                           nbfp: np.ndarray) -> MoleculeType:
    """couple-moltype decoupling (reference: toppush.cpp:2778
    convert_moltype_couple).

    1. 1-4 pairs are frozen: full-strength LJ+Coulomb with the original
       charges, independent of lambda (convert_pairs_to_pairsQ).
    2. couple-intramol=no: every non-excluded intramolecular pair becomes
       an explicit plain pair (original charges/types), and ALL
       intramolecular pairs become exclusions (generate_LJCpairsNB +
       set_excl_all).
    3. decouple_atoms: state A/B charges zeroed and/or types pointed at the
       all-zero decoupled type according to couple_lambda0/1 ('vdw-q',
       'vdw', 'q', 'none': which interactions are ON in that state).
    """
    for v in (couple_lam0, couple_lam1):
        if v not in ("vdw-q", "vdw", "q", "none"):
            raise ValueError(f"couple-lambda = {v}")
    mol = dataclasses.replace(mol)
    # 1. freeze 1-4 pairs with the pre-decoupling charges
    mol.pairs14 = []
    for (ai, aj, pa, pb) in mol.pairs_raw:
        qa = fudge_qq * mol.charges_a[ai] * mol.charges_a[aj]
        mol.pairs14.append(((ai, aj), (qa,) + tuple(pa), (qa,) + tuple(pa)))
    mol.pairs_raw = []

    if not intramol:
        # 2. explicit plain pairs for all non-excluded intramolecular pairs
        # (LJC_PAIRS_NB: no fudge factor), then exclude everything
        excl = mol.generate_exclusions()
        n = mol.n_atoms
        for i in range(n):
            for j in range(i + 1, n):
                if j in excl[i]:
                    continue
                qq = mol.charges_a[i] * mol.charges_a[j]
                c6 = float(nbfp[mol.types_a[i], mol.types_a[j], 0])
                c12 = float(nbfp[mol.types_a[i], mol.types_a[j], 1])
                mol.pairs14.append(((i, j), (qq, c6, c12), (qq, c6, c12)))
        mol.extra_exclusions = list(mol.extra_exclusions) + [
            (i, j) for i in range(n) for j in range(i + 1, n)]

    # 3. decouple atoms
    q_off_a = couple_lam0 in ("none", "vdw")
    v_off_a = couple_lam0 in ("none", "q")
    q_off_b = couple_lam1 in ("none", "vdw")
    v_off_b = couple_lam1 in ("none", "q")
    mol.charges_a = [0.0 if q_off_a else q for q in mol.charges_a]
    mol.types_a = [decoupled_type if v_off_a else t for t in mol.types_a]
    mol.charges_b = [0.0 if q_off_b else q for q in mol.charges_b]
    mol.types_b = [decoupled_type if v_off_b else t for t in mol.types_b]
    return mol


def make_hbond_constraints(mol: MoleculeType, all_bonds: bool = False):
    """constraints = h-bonds | all-bonds: move the (hydrogen) bonds into
    the constraint list with their A/B equilibrium lengths (reference:
    gmxpreprocess/topshake.cpp make_shake; a hydrogen is an atom whose name
    starts with H, topshake.cpp:55).  Mutates mol.bonds and
    mol.constraints."""
    names = mol.atom_names
    keep = []
    for row in mol.bonds:
        idx, pa = row[0], row[1]
        pb = row[2] if len(row) > 2 and row[2] is not None else pa
        i, j = idx
        is_h = all_bonds or (names is not None and (
            names[i].upper().startswith("H")
            or names[j].upper().startswith("H")))
        if is_h:
            mol.constraints.append((i, j, pa[0], pb[0]))
        else:
            keep.append(row)
    mol.bonds = keep


def decouple_moltype(mol: MoleculeType, nbfp: np.ndarray, vdw: bool = True,
                     coul: bool = True) -> Tuple[MoleculeType, np.ndarray]:
    """Full decoupling (A = on, B = off); returns the molecule and the LJ
    table grown by the all-zero decoupled type."""
    T = nbfp.shape[0]
    nbfp2 = np.zeros((T + 1, T + 1, 2), np.float32)
    nbfp2[:T, :T] = nbfp
    lam1 = "none" if (vdw and coul) else ("q" if vdw else "vdw")
    mol2 = convert_moltype_couple(mol, T, 1.0, "vdw-q", lam1, True, nbfp)
    return mol2, nbfp2


def system_from_top(text: str, include_dirs: Optional[List[str]] = None,
                    couple_moltype: Optional[str] = None,
                    couple_lam0: str = "vdw-q", couple_lam1: str = "none",
                    couple_intramol: bool = True,
                    constraints: str = "none",
                    defines: Optional[Dict[str, str]] = None,
                    epsilon_r: float = 1.0, device="cuda") -> System:
    """Parse + grompp transforms -> flat System on `device`.

    `couple_moltype=name` alone decouples the molecule fully in the B
    state (lambda0 = coupled).  A couple_moltype that names no molecule of
    [ molecules ] raises.  constraints: the mdp value; h-bonds and
    all-bonds turn bonds into LINCS rows (make_hbond_constraints), after
    the couple-moltype conversion as in JAX; any other value but none
    raises."""
    if constraints not in ("none", "h-bonds", "all-bonds"):
        raise NotImplementedError(f"constraints = {constraints} is not "
                                  "ported (none, h-bonds, all-bonds)")
    parsed = parse_top(text, include_dirs, defines)
    nbfp = parsed.nbfp
    decoupled_type = None
    if couple_moltype is not None:
        if couple_moltype not in {n for n, _ in parsed.molecules}:
            raise ValueError(f"couple-moltype {couple_moltype} is not in "
                             "[ molecules ]")
        T = nbfp.shape[0]
        nbfp = np.zeros((T + 1, T + 1, 2), np.float32)
        nbfp[:T, :T] = parsed.nbfp
        decoupled_type = T
    mols = []
    for name, count in parsed.molecules:
        mol = parsed.moltypes[name]
        if name == couple_moltype:
            mol = convert_moltype_couple(
                mol, decoupled_type, parsed.fudge_qq, couple_lam0,
                couple_lam1, couple_intramol, parsed.nbfp)
        else:
            mol = dataclasses.replace(mol, pairs14=list(mol.pairs14),
                                      pairs_raw=list(mol.pairs_raw))
            _finalize_pairs(mol, parsed.fudge_qq)
        if constraints != "none":
            mol = dataclasses.replace(mol, bonds=list(mol.bonds),
                                      constraints=list(mol.constraints))
            make_hbond_constraints(mol, all_bonds=constraints == "all-bonds")
        mols.append((mol, count))
    return build_system(mols, nbfp, device=device, fudge_qq=1.0,
                        epsilon_r=epsilon_r)
