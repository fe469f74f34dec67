"""The port's file readers and writers against the JAX package's, on the
same inputs: mdp -> MdParams/FepParams and the lambda ladder (equal by
field), the unsupported mdp options (the port raises NotImplementedError
naming the key, the JAX reader accepts the text), top -> System (the
arrays exactly equal), the unsupported topology directives (raise),
gro/pdb/solvate (byte-identical files, equal arrays), grompp (x, the
gen-vel velocities, box, PME grid, lambda vector and state exactly equal),
edr and .gmx.cpt (byte-identical, read back by the JAX readers) and md.log
(identical text; the port's Input Parameters lines are a subset of JAX's,
its MdParams having fewer fields).  The inputs are examples/solvation_fep.sh
as published, tests/test_cli.py's water box and a 5-site ligand with
bonds, angles, 1-4 pairs and B states, all built with numpy from seeds.
"""
import filecmp
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from gromacs_fep_gpu_tpu.io import cptio as jcpt
from gromacs_fep_gpu_tpu.io import edrio as jedr
from gromacs_fep_gpu_tpu.io import groio as jgro
from gromacs_fep_gpu_tpu.io import grompp as jgrompp
from gromacs_fep_gpu_tpu.io import logio as jlog
from gromacs_fep_gpu_tpu.io import mdpio as jmdp
from gromacs_fep_gpu_tpu.io import pdbio as jpdb
from gromacs_fep_gpu_tpu.io import topio as jtop
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.core.types import to_numpy
from gromacs_fep_gpu_tpu_torch.io import buildtools as tbuild
from gromacs_fep_gpu_tpu_torch.io import cptio as tcpt
from gromacs_fep_gpu_tpu_torch.io import edrio as tedr
from gromacs_fep_gpu_tpu_torch.io import groio as tgro
from gromacs_fep_gpu_tpu_torch.io import grompp as tgrompp
from gromacs_fep_gpu_tpu_torch.io import logio as tlog
from gromacs_fep_gpu_tpu_torch.io import mdpio as tmdp
from gromacs_fep_gpu_tpu_torch.io import pdbio as tpdb
from gromacs_fep_gpu_tpu_torch.io import topio as ttop

from test_cli import MDP as CLI_MDP, TOP as CLI_TOP
from torch_bridge import system_arrays

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LIG, EX_TOP, EX_MDP, N_WIN = chip_smoke.example_inputs()

LIGAND_TOP = """
[ defaults ]
1 1 yes 0.5 0.8333

[ atomtypes ]
C1  12.011  0.0  A  2.0e-3  4.0e-6
C2  12.011  0.0  A  2.4e-3  5.0e-6
H1   1.008  0.0  A  1.0e-4  1.0e-8
OW  15.9994 0.0  A  2.6e-3  2.6e-6
HW   1.008  0.0  A  0.0     0.0

[ bondtypes ]
C1 C2 1 0.153 224262.4

[ pairtypes ]
C1 H1 1 1.5e-4 2.0e-7

[ moleculetype ]
LIG 3

[ atoms ]
1 C1 1 LIG CA 1 -0.20 12.011 C2 0.00 12.011
2 C2 1 LIG CB 1  0.10 12.011
3 H1 1 LIG HA 1  0.05  1.008 H1 0.00 1.008
4 H1 1 LIG HB 1  0.05  1.008
5 H1 1 LIG HC 1  0.00  1.008

[ bonds ]
1 2 1
1 3 1 0.109 284512.0 0.110 284000.0
2 4 1 0.109 284512.0
2 5 1 0.109 284512.0

[ angles ]
3 1 2 1 109.5 292.88 110.0 290.0
1 2 4 1 109.5 292.88
1 2 5 1 109.5 292.88
4 2 5 1 107.8 276.14

[ pairs ]
3 4 1
3 5 1 1.2e-4 1.5e-7 1.1e-4 1.4e-7

[ moleculetype ]
SOL 2

[ atoms ]
1 OW 1 SOL OW  1 -0.834 15.9994
2 HW 1 SOL HW1 1  0.417 1.008
3 HW 1 SOL HW2 1  0.417 1.008

[ settles ]
1 1 0.09572 0.15139

[ exclusions ]
1 2 3
2 3

[ system ]
ligand in water

[ molecules ]
LIG 2
SOL 3
"""


# [ dihedraltypes ] with wildcards (X), the legacy 2-atom form, several
# funct-9 lines, funct 2/3/4; Urey-Bradley from [ angletypes ] and
# explicit; a restraint bond (funct 10); position restraints funct 1 (A/B)
# and funct 2 under #ifdef; dihedral and angle restraints; a perturbed
# atom (H21 -> HX) whose B lookups hit an exact, a wildcard and a missing
# entry
BONDED_TOP = """
[ defaults ]
1 2 yes 0.5 0.8333

[ atomtypes ]
CA  CT  6  12.011  0.0  A  0.34   0.36
CB  CT  6  12.011  0.0  A  0.34   0.36
OH  OH  8  15.999  0.0  A  0.30   0.70
HO  HO  1   1.008  0.0  A  0.0    0.0
HC  HC  1   1.008  0.0  A  0.25   0.12
HX  HX  1   1.008  0.0  A  0.24   0.10

[ bondtypes ]
CT CT 1 0.153 224262.4
CT HC 1 0.109 284512.0
CT HX 1 0.110 290000.0
CT OH 1 0.141 267776.0
OH HO 1 0.0945 462750.4

[ angletypes ]
HC CT HC 1 107.8 276.144
HC CT CT 1 110.7 313.8
HX CT CT 1 111.0 300.0
CT CT OH 5 109.5 418.4 0.24 5000.0
HC CT OH 1 109.5 292.88
CT OH HO 1 108.5 460.24

[ dihedraltypes ]
X  CT CT X  9   0.0 0.6 3
X  CT CT X  9 180.0 0.3 2
HC CT CT HC 9   0.0 0.5 3
HC CT CT HC 9   0.0 0.2 1
CT CT OH HO 3 -0.4435 3.83255 0.72801 -4.11705 0.0 0.0
X  CT OH X  3  0.9414 2.8242 0.0 -3.7656 0.0 0.0
X  CT HC OH 2   0.0 40.0
X  X  CT CT 4 180.0 4.6 2
CT OH 1 0.0 2.0 3

[ moleculetype ]
MOL 3

[ atoms ]
1 CA 1 MOL C1  1 -0.18 12.011
2 HC 1 MOL H11 1  0.06  1.008
3 HC 1 MOL H12 1  0.06  1.008
4 CB 1 MOL C2  1  0.145 12.011
5 HC 1 MOL H21 1  0.06  1.008 HX 0.0 1.008
6 OH 1 MOL O   1 -0.683 15.999
7 HO 1 MOL HO  1  0.352 1.008

[ bonds ]
1 2 1
1 3 1
1 4 1
4 5 1
4 6 1
6 7 1
1 7 10 0.2 0.3 0.4 1000.0 0.2 0.35 0.45 500.0

[ angles ]
2 1 3 1
2 1 4 1
3 1 4 1
1 4 5 1
1 4 6 5
5 4 6 1
4 6 7 1
2 1 7 5 100.0 300.0 0.25 4000.0

[ dihedrals ]
2 1 4 5 9
3 1 4 6 9
1 4 6 7 3
5 4 6 7 3
2 1 4 6 1 0.0 5.0 2
4 1 5 6 2
2 3 1 4 4
1 4 6 7 1

[ pairs ]
2 5 1
3 6 1

[ position_restraints ]
1 1 1000 1000 1000
6 1 500 600 700 100 200 300
#ifdef POSRES
4 2 1 0.5 800
7 2 6 0.3 400
#endif

[ dihedral_restraints ]
1 4 6 7 1 180.0 20.0 10.0 170.0 25.0 50.0

[ angle_restraints ]
2 1 6 7 1 90.0 10.0 2 100.0 20.0 2

[ system ]
bonded terms

[ molecules ]
MOL 2
"""


def _example_mdp(window=2):
    return EX_MDP.format(nsteps=200, window=window)


MDPS = {"example": _example_mdp(),
        "test_cli": CLI_MDP,
        "pme_mts": chip_smoke.pme_mdp(_example_mdp(1)),
        "em_traj": chip_smoke.mdp_with(_example_mdp(1), {
            "integrator": "steep", "emtol": 250, "emstep": 0.02,
            "nbfgscorr": 5, "nstxout": 50, "nstvout": 50,
            "nstxout-compressed": 10, "compressed-x-precision": 100})}
# MdParams fields the JAX package lacks: it writes v into every trr frame
PORT_ONLY = {"nstvout": {"em_traj": 50}}


def _field_value(v):
    return v.value if hasattr(v, "value") and not isinstance(v, int) else v


@pytest.mark.parametrize("name", sorted(MDPS))
def test_mdp_params_match_jax(name):
    tp, tl = tmdp.mdp_to_params(MDPS[name])
    jp, jl = jmdp.mdp_to_params(MDPS[name])
    for obj_t, obj_j in ((tp, jp), (tp.fep, jp.fep)):
        for f in obj_t.__dataclass_fields__:
            if f in PORT_ONLY:
                assert getattr(obj_t, f) == PORT_ONLY[f].get(name, 0), f
                continue
            if f == "fep":
                continue
            assert _field_value(getattr(obj_t, f)) == \
                _field_value(getattr(obj_j, f)), f
    assert (tl is None) == (jl is None)
    if tl is not None:
        np.testing.assert_array_equal(tl, jl)
    assert tmdp.mdp_extras(MDPS[name]) == {
        k: v for k, v in jmdp.mdp_extras(MDPS[name]).items()
        if k in tmdp.mdp_extras(MDPS[name])}


# (mdp lines, the key the port's message names): every key of
# mdpio._UNSUPPORTED (each raises NotImplementedError naming it)
UNSUPPORTED = [
    ("integrator = bd", "integrator"),
    ("integrator = md-vv", "integrator"),
    # the minimizers run; these keep their ids with the raises they meet:
    # mts with a minimizer, cg and l-bfgs with constraints
    ("mts = yes\nintegrator = steep", "mts"),
    ("constraints = h-bonds\nintegrator = cg", "constraints"),
    ("constraints = all-bonds\nintegrator = l-bfgs", "constraints"),
    ("integrator = nm", "integrator"),
    ("integrator = tpi", "integrator"),
    ("tcoupl = berendsen", "tcoupl"), ("tcoupl = nose-hoover", "tcoupl"),
    ("tcoupl = andersen-massive", "tcoupl"),
    ("pcoupl = parrinello-rahman\npcoupltype = anisotropic", "pcoupltype"),
    ("pcoupl = berendsen\npcoupltype = surface-tension", "pcoupltype"),
    ("pcoupl = mttk", "pcoupl"),
    ("pcoupl = c-rescale\npcoupltype = semiisotropic", "pcoupltype"),
    # bond constraints run on LINCS only; angle constraints not at all
    ("constraint-algorithm = shake\nconstraints = h-bonds",
     "constraint-algorithm"),
    ("constraint-algorithm = shake\nconstraints = all-bonds",
     "constraint-algorithm"),
    ("constraints = h-angles", "constraints"),
    ("constraints = all-angles", "constraints"),
    ("free-energy = yes\nsc-function = gapsys", "sc-function"),
    ("vdwtype = pme", "vdwtype"),
    ("free-energy = expanded\nfep-lambdas = 0 1\nnstexpanded = 10",
     "free-energy"),
    ("free-energy = yes\nfep-lambdas = 0 1\nawh = yes\n"
     "awh1-dim1-coord-provider = fep-lambda", "awh"),
    ("pull = yes\npull-ngroups = 2\npull-ncoords = 1\n"
     "pull-group1-atoms = 1\npull-group2-atoms = 2", "pull"),
    ("nwall = 2", "nwall"),
    ("electric-field-x = 1 0.5 0 0", "electric-field-x"),
    ("density-guided-simulation-active = yes", "density-guided-simulation"),
    # trajectories are written; these keep their ids with the raises they
    # meet: v on other steps than x, an xtc of a group
    ("nstvout = 5\nnstxout = 10", "nstvout"),
    ("compressed-x-grps = Protein\nnstxout-compressed = 10",
     "compressed-x-grps"),
    ("delta-lambda = 0.001", "delta-lambda"),
    ("annealing = single\nannealing-npoints = 2\nannealing-time = 0 10\n"
     "annealing-temp = 300 320", "annealing"),
    ("tc-grps = Protein SOL\nref-t = 300 300\ntau-t = 0.1 0.1", "tc-grps"),
    ("coulombtype = ewald", "coulombtype"),
    ("vdw-modifier = exact-cutoff", "vdw-modifier"),
    ("cutoff-scheme = group", "cutoff-scheme"),
    ("comm-mode = angular", "comm-mode"),
    ("simulated-tempering = yes\nfep-lambdas = 0 1\n"
     "temperature-lambdas = 0 1", "simulated-tempering"),
    ("orire = yes", "orire"), ("disre = simple", "disre"),
    ("ewald-geometry = 3dc", "ewald-geometry"),
    ("epsilon-surface = 80", "epsilon-surface"),
    ("mts = yes\nmts-levels = 3", "mts-levels"),
    ("mts = yes\nmts-level2-forces = longrange-nonbonded nonbonded",
     "mts-level2-forces"),
    ("nstvout = 10", "nstvout"), ("nstfout = 10", "nstfout"),
    ("freezegrps = System\nfreezedim = Y Y Y", "freezegrps"),
    ("acc-grps = System\naccelerate = 0.1 0 0", "acc-grps"),
    ("cos-acceleration = 0.1", "cos-acceleration"),
    ("deform = 0 0 0.001 0 0 0", "deform"),
    ("rotation = yes", "rotation"), ("swapcoords = Z", "swapcoords"),
    ("qmmm-active = true", "qmmm-active"),
    ("implicit-solvent = GBSA", "implicit-solvent"),
]


@pytest.mark.parametrize("lines,key", UNSUPPORTED,
                         ids=[u[0].splitlines()[-1] for u in UNSUPPORTED])
def test_unsupported_mdp_option_raises(lines, key):
    text = "integrator = md\n" + lines + "\n"
    jmdp.mdp_to_params(text)          # the JAX reader accepts the text
    with pytest.raises(NotImplementedError, match=key):
        tmdp.mdp_to_params(text)


def _tops():
    return {
        "example": (EX_TOP.format(nsol=6), dict(
            couple_moltype="LIG", couple_lam0="vdw", couple_lam1="none",
            couple_intramol=False)),
        "water": (CLI_TOP, {}),
        "ligand": (LIGAND_TOP, {}),
        "ligand_decoupled": (LIGAND_TOP, dict(
            couple_moltype="LIG", couple_lam0="vdw-q", couple_lam1="q",
            couple_intramol=False)),
        "bonded": (BONDED_TOP, dict(defines={"POSRES": "1"})),
        "bonded_decoupled": (BONDED_TOP, dict(
            couple_moltype="MOL", couple_lam0="vdw-q", couple_lam1="none",
            couple_intramol=False)),
    }


@pytest.mark.parametrize("name", sorted(_tops()))
def test_top_system_matches_jax(name):
    top, kw = _tops()[name]
    js = jtop.system_from_top(top, **kw)
    ts = ttop.system_from_top(top, device="cpu", **kw)
    want, got = system_arrays(js), to_numpy(ts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if name.startswith("ligand"):
        assert {"bonded_bonds_atoms", "bonded_angles_atoms",
                "pairs14_atoms"} <= set(got)
    if name.startswith("bonded"):
        terms = {k[len("bonded_"):-len("_atoms")] for k in got
                 if k.startswith("bonded_") and k.endswith("_atoms")}
        assert terms == {"bonds", "angles", "ub", "pdihs", "rbdihs",
                         "idihs", "posres", "dihres", "angres",
                         "restrbonds"} | (
                             {"fbposres"} if name == "bonded" else set())
        # per copy: 2 + 2 funct-9 lines, funct 1, funct 4 and the legacy
        # 2-atom funct-1 line
        assert got["bonded_pdihs_atoms"].shape[0] == 2 * 7


def test_top_dihedraltypes_lookup():
    """An exact dihedral type scores over a wildcard; funct 9 keeps every
    line of the best match in file order; a perturbed atom whose B types
    have no entry falls back to A with JAX's warning; A and B holding
    different counts of funct-9 lines raise in both packages."""
    with pytest.warns(UserWarning, match="no default angles type for "
                      "perturbed atoms"):
        mol = ttop.parse_top(BONDED_TOP).moltypes["MOL"]
    ab = [(r[1], r[2]) for r in mol.pdihs if r[0] == (1, 0, 3, 4)]
    # A: HC CT CT HC exactly (two lines), B: HX -> X CT CT X (two lines)
    assert [a for a, _ in ab] == [(0.0, 0.5, 3.0), (0.0, 0.2, 1.0)]
    assert [b for _, b in ab] == [(0.0, 0.6, 3.0), (180.0, 0.3, 2.0)]
    # the legacy 2-atom line X CT OH X (funct 1) beside funct 9's lines
    assert [r[1] for r in mol.pdihs if r[0] == (0, 3, 5, 6)] == [
        (0.0, 2.0, 3.0)]
    bad = BONDED_TOP.replace("CT OH 1 0.0 2.0 3",
                             "CT OH 1 0.0 2.0 3\nHX CT CT HC 9 0.0 0.1 3")
    for mod in (ttop, jtop):
        with pytest.raises(ValueError, match="multiple"):
            mod.parse_top(bad)


def test_grompp_posres_reference_matches_jax():
    """grompp -r: the position restraints' x0 (both states) and the
    flat-bottomed ones' from the reference coordinates, else from the
    input conformation, as in the JAX package."""
    mdp = "integrator = md\nnsteps = 10\ndefine = -DPOSRES\n"
    rng = np.random.default_rng(4)
    x = rng.uniform(0.0, 2.0, (14, 3))
    xr = x + rng.normal(0, 0.05, x.shape)
    names = ["C1", "H11", "H12", "C2", "H21", "O", "HO"] * 2
    res = ["MOL"] * 14
    box = np.diag([2.0, 2.0, 2.0])
    for ref in (None, xr):
        jp = jgrompp.preprocess_arrays(mdp, BONDED_TOP, names, res, x, None,
                                       box, posres_x=ref)
        tp = tgrompp.preprocess_arrays(mdp, BONDED_TOP, names, res, x, None,
                                       box, posres_x=ref, device="cpu")
        want, got = system_arrays(jp.system), to_numpy(tp.system)
        for name in ("posres", "fbposres"):
            for k in ("atoms", "params_a", "params_b", "mask"):
                key = f"bonded_{name}_{k}"
                assert np.array_equal(got[key], want[key]), key
        xw = x if ref is None else xr
        ai = got["bonded_posres_atoms"][:, 0]
        np.testing.assert_array_equal(got["bonded_posres_params_b"][:, :3],
                                      xw[ai].astype(np.float32))
    with pytest.raises(ValueError, match="posres reference"):
        tgrompp.preprocess_arrays(mdp, BONDED_TOP, names, res, x, None, box,
                                  posres_x=xr[:5], device="cpu")


def test_lj_table_from_types_matches_jax():
    """c6/c12 per type (combination rule 1) into the (T, T, 2) table, as
    the JAX package builds it; rules 2 and 3 take sigma/epsilon and raise
    in both."""
    from gromacs_fep_gpu_tpu.core.topology import lj_table_from_types as jlj
    from gromacs_fep_gpu_tpu_torch.core.topology import (
        lj_table_from_types as tlj)
    rng = np.random.default_rng(8)
    c6, c12 = rng.uniform(0, 5e-3, 6), rng.uniform(0, 5e-6, 6)
    np.testing.assert_array_equal(tlj(c6, c12), jlj(c6, c12))
    for mod in (tlj, jlj):
        with pytest.raises(NotImplementedError):
            mod(c6, c12, comb_rule=2)


def test_sd_resets_tcoupl():
    """integrator = sd with a tcoupl: the port sets tcoupl = no with a
    warning (grompp's note), where the JAX reader keeps both thermostats;
    tau-t and ref-t stay the friction and the bath."""
    text = ("integrator = sd\ntcoupl = v-rescale\ntc-grps = System\n"
            "tau-t = 2.0\nref-t = 310\n")
    with pytest.warns(UserWarning, match="sd handles temperature"):
        tp, _ = tmdp.mdp_to_params(text)
    jp, _ = jmdp.mdp_to_params(text)
    assert tp.integrator == ttypes.IntegratorType.SD
    assert tp.tcoupl == ttypes.TcouplType.NO
    assert jp.tcoupl.value == "v-rescale"
    assert (tp.tau_t, tp.ref_t) == (jp.tau_t, jp.ref_t) == (2.0, 310.0)
    tp, _ = tmdp.mdp_to_params("integrator = sd\ndisre-fc = 250\n")
    assert tp.tcoupl == ttypes.TcouplType.NO and tp.disre_fc == 250.0


@pytest.mark.parametrize("vdw,coul", [(True, True), (True, False),
                                      (False, True)])
def test_decouple_moltype_matches_jax(vdw, coul):
    from gromacs_fep_gpu_tpu.core.topology import build_system as jbuild
    from gromacs_fep_gpu_tpu_torch.core.topology import build_system
    tp, jp = ttop.parse_top(LIGAND_TOP), jtop.parse_top(LIGAND_TOP)
    tm, tn = ttop.decouple_moltype(tp.moltypes["LIG"], tp.nbfp, vdw, coul)
    jm, jn = jtop.decouple_moltype(jp.moltypes["LIG"], jp.atomtypes, jp.nbfp,
                                   vdw, coul)
    want = system_arrays(jbuild([(jm, 2)], jn))
    got = to_numpy(build_system([(tm, 2)], tn, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


UNPORTED_TOP = [
    # funct 1 and 2 are ported (LINCS); funct 3 is no constraint type
    ("[ constraints ]\n1 2 3 0.1\n", "constraints"),
    ("[ virtual_sites3 ]\n5 1 2 3 1 0.1 0.1\n", "virtual_sites3"),
    ("[ cmap ]\n1 2 3 4 5 1\n", "cmap"),
    ("[ bonds ]\n1 2 2 0.1 1000.0\n", "bonds"),
    ("[ dihedrals ]\n1 2 3 4 5 1.0 2.0 3.0 4.0\n", "dihedrals"),
    ("[ distance_restraints ]\n1 2 1 1 0 0.1 0.2 0.3 1.0\n",
     "distance_restraints"),
    ("[ orientation_restraints ]\n1 2 1 1 1 3 6.0 0.5 1.0\n",
     "orientation_restraints"),
    ("[ position_restraints ]\n1 3 1000 1000 1000\n",
     "position_restraints"),
    ("[ pairs_nb ]\n1 2 1 0.0 0.0 0.3 0.5\n", "pairs_nb"),
    ("[ intermolecular_interactions ]\n", "intermolecular_interactions"),
]


@pytest.mark.parametrize("section,name", UNPORTED_TOP,
                         ids=[u[1] for u in UNPORTED_TOP])
def test_unported_topology_directive_raises(section, name):
    top = LIGAND_TOP.replace("[ moleculetype ]\nSOL 2",
                             section + "\n[ moleculetype ]\nSOL 2")
    with pytest.raises(NotImplementedError, match=name) as err:
        ttop.system_from_top(top, device="cpu")
    if name in ("pairs_nb", "intermolecular_interactions"):
        assert "JAX package has no counterpart" in str(err.value)
        jtop.system_from_top(top)     # which drops the directive silently


def test_gro_pdb_and_solvate_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 3.0, (7, 3))
    v = rng.normal(size=(7, 3))
    names = ["OW", "HW1", "HW2", "C", "CA", "N", "LONGNAME"]
    res = ["SOL"] * 3 + ["LIG"] * 3 + ["RESIDUE"]
    boxes = (np.diag([3.0, 3.1, 3.2]),
             np.array([[3.0, 0, 0], [0.5, 2.9, 0], [0.3, 0.2, 2.8]]))
    for i, box in enumerate(boxes):
        for vel in (None, v):
            tp, jp = tmp_path / f"t{i}.gro", tmp_path / f"j{i}.gro"
            tgro.write_gro(str(tp), "t", names, res, x, vel, box)
            jgro.write_gro(str(jp), "t", names, res, x, vel, box)
            assert filecmp.cmp(tp, jp, shallow=False)
            for a, b in zip(tgro.read_gro(str(tp)), jgro.read_gro(str(jp))):
                np.testing.assert_array_equal(a, b)
    pdb = tmp_path / "s.pdb"
    pdb.write_text(
        "CRYST1   30.000   31.000   32.000  90.00  90.00  90.00 P 1\n"
        + "".join(f"ATOM  {i + 1:5d} {n:<4.4s} {r:<4.4s} {i + 1:4d}    "
                  f"{10 * a[0]:8.3f}{10 * a[1]:8.3f}{10 * a[2]:8.3f}"
                  "  1.00  0.00\n"
                  for i, (n, r, a) in enumerate(zip(names, res, x)))
        + "END\n")
    for a, b in zip(tpdb.read_structure(str(pdb)),
                    jpdb.read_structure(str(pdb))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="g96"):
        tpdb.read_structure(str(tmp_path / "x.g96"))
    # solvate around the example's ligand, the same seed
    (tmp_path / "lig.gro").write_text(LIG)
    from gromacs_fep_gpu_tpu.io.buildtools import solvate as jsolvate
    from gromacs_fep_gpu_tpu_torch import cli
    cli.main(["solvate", "-cp", str(tmp_path / "lig.gro"), "-box", "1.55",
              "-o", str(tmp_path / "t.gro"), "-seed", "11"])
    nm, rs, xl, _, _ = jgro.read_gro(str(tmp_path / "lig.gro"))
    box = np.eye(3, dtype=np.float32) * 1.55
    xw, n_w = jsolvate(xl, box, seed=11)
    jgro.write_gro(str(tmp_path / "j.gro"), "solvated by tpumd",
                   nm + ["OW", "HW1", "HW2"] * n_w, rs + ["SOL"] * (3 * n_w),
                   np.concatenate([xl, xw]), None, box)
    assert n_w > 50
    assert filecmp.cmp(tmp_path / "t.gro", tmp_path / "j.gro", shallow=False)
    xt, nt = tbuild.solvate(xl, box, seed=11)
    assert nt == n_w and np.array_equal(xt, xw)


@pytest.mark.parametrize("mdp", ["example", "pme_mts"])
def test_grompp_matches_jax(mdp):
    text = mdp_text = MDPS[mdp].replace("gen-temp = 300",
                                        "gen-temp = 300\ngen-seed = 5")
    top = EX_TOP.format(nsol=27)
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.9, (82, 3))
    names = ["C1"] + ["OW", "HW1", "HW2"] * 27
    res = ["LIG"] + ["SOL"] * 81
    box = np.diag([1.9, 1.9, 1.9])
    jp = jgrompp.preprocess_arrays(mdp_text, top, names, res, x, None, box)
    tp = tgrompp.preprocess_arrays(text, top, names, res, x, None, box,
                                   device="cpu")
    assert tp.params.pme_grid == jp.params.pme_grid
    if mdp == "pme_mts":
        assert tp.params.pme_grid is not None
    for k in ("x", "v", "box", "lam"):
        assert np.array_equal(getattr(tp.state, k).numpy(),
                              np.asarray(getattr(jp.state, k))), k
    assert tp.state.fep_state == int(jp.state.fep_state)
    assert float(tp.state.v.abs().max()) > 0.0
    np.testing.assert_array_equal(tp.all_lambda, jp.all_lambda)
    assert tp.separate_dvdl == jp.separate_dvdl
    assert tgrompp.gromacs_pme_grid(np.diag([5.0] * 3), 0.12) == (42, 42, 42)


def _frames(rng, n=6, n_win=5):
    """EdrFrame arguments with Delta H blocks on every other frame."""
    out = []
    for i in range(n):
        e = rng.normal(size=5).astype(np.float32)
        dh = rng.normal(size=n_win) if i % 2 == 0 else None
        out.append((i * 0.002, i, e, dh))
    return out


def _write_edr(mod, path, frames):
    comps = [2, 3]
    with mod.EdrWriter(path, ["Potential", "Kinetic En.", "Total Energy",
                              "Temperature", "Pressure"],
                       ["kJ/mol", "kJ/mol", "kJ/mol", "K", "bar"]) as ew:
        for t, step, e, dh in frames:
            blocks = []
            if dh is not None:
                blocks.append(mod.dhcoll_block(
                    temperature=300.0, start_time=t, delta_time=0.004,
                    start_lambda=-1.0, lambda_index=1,
                    native_lambda_vec=[0.0, 0.25], lambda_components=comps))
                blocks.append(mod.dh_block(mod.DHBT_DHDL, [1.5]))
                for w in range(len(dh)):
                    blocks.append(mod.dh_block(mod.DHBT_DH, [dh[w]],
                                               foreign_lambda=[0.0,
                                                               w / 4]))
            ew.write_frame(mod.EdrFrame(t=t, step=step, ener=e,
                                        blocks=blocks, dt=0.002))


def test_edr_cpt_and_log_writers_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    frames = _frames(rng)
    _write_edr(tedr, str(tmp_path / "t.edr"), frames)
    _write_edr(jedr, str(tmp_path / "j.edr"), frames)
    assert filecmp.cmp(tmp_path / "t.edr", tmp_path / "j.edr",
                       shallow=False)
    names, _, back = jedr.read_edr(str(tmp_path / "t.edr"))
    assert names[0] == "Potential" and len(back) == len(frames)
    np.testing.assert_array_equal(back[2].ener, frames[2][2])

    kw = dict(x=rng.normal(size=(9, 3)), v=rng.normal(size=(9, 3)),
              box=np.diag([2.0, 2.0, 2.0]), lam=np.linspace(0, 1, 7),
              fep_state=2, step=140, t=0.28, therm_integral=-3.5,
              boxv=np.zeros((3, 3)))
    tcpt.write_gmx_cpt(str(tmp_path / "t.cpt"), **kw)
    jcpt.write_gmx_cpt(str(tmp_path / "j.cpt"), **kw)
    assert filecmp.cmp(tmp_path / "t.cpt", tmp_path / "j.cpt",
                       shallow=False)
    cp = jcpt.read_gmx_cpt(str(tmp_path / "t.cpt"))
    assert cp.step == 140 and cp.natoms == 9
    np.testing.assert_array_equal(cp.state["x"],
                                  kw["x"].astype(np.float32))

    # md.log: the same frames through both writers
    n = 12
    terms = rng.normal(size=(n, 12))
    terms[:, [2, 4, 5, 6, 7, 8, 9, 10, 11]] = 0.0
    base = dict(epot=terms.sum(1), ekin=rng.uniform(size=n),
                temp=rng.uniform(290, 310, n), pres=np.zeros(n),
                dvdl=rng.normal(size=(n, 7)), constr_rmsd=np.zeros(n))
    tlg = types.SimpleNamespace(terms=terms, **base)
    jlg = types.SimpleNamespace(terms=types.SimpleNamespace(**{
        k: terms[:, c] for c, k in enumerate(ttypes._ENERGY_FIELDS)}),
        **base)
    tparams = tmdp.mdp_to_params(MDPS["example"])[0]
    jparams = jmdp.mdp_to_params(MDPS["example"])[0]
    system = types.SimpleNamespace(n_atoms=193)
    texts = {}
    for tag, mod, params, lg in (("t", tlog, tparams, tlg),
                                 ("j", jlog, jparams, jlg)):
        w = mod.MdLogWriter(str(tmp_path / f"{tag}.log"), params, system,
                            argv=["mdrun", "-s", "x.tpz"])
        w.write_frames(lg, np.arange(n) * 0.002, 5, 0.002)
        w.write_performance("report", 12.5, 3.0, n, 193)
        w.close()
        texts[tag] = (tmp_path / f"{tag}.log").read_text()
    head_t, rest_t = texts["t"].split("\nSystem: ")
    head_j, rest_j = texts["j"].split("\nSystem: ")
    assert rest_t == rest_j
    assert "LJ (SR)" in rest_t and "A V E R A G E S" in rest_t
    lines_j = set(head_j.splitlines())
    # every parameter line but those of the port's own fields (PORT_ONLY)
    assert all(line in lines_j for line in head_t.splitlines()
               if line.split("=")[0].strip() not in PORT_ONLY)
