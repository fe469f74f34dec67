"""mdp parameter file parsing into MdParams — PyTorch-port counterpart of
gromacs_fep_gpu_tpu/io/mdpio.py (parse_mdp, _lambda_vector, mdp_extras,
mdp_to_params; the readir analogue, reference:
src/gromacs/gmxpreprocess/readir.cpp:2152 get_ir, FEP keys :2544-2588).

The numpy code is a copy (the port imports nothing of the JAX package).
Where the JAX reader keeps a default for a value it does not know, or
accepts a setting whose physics the port lacks, this reader raises
NotImplementedError naming the key and the value (unsupported_options):
nothing is dropped silently.  Keys that only shape output the port writes
(nstenergy, nstcalcenergy, nstlog, energygrps) are accepted.

Under integrator = sd, tau-t is the inverse friction and ref-t the bath:
the reader sets tcoupl = no with a warning, as grompp does (readir.cpp:
sd handles temperature coupling itself), where the JAX reader keeps the
tcoupl and its step then thermostats twice.

pcoupl = berendsen | c-rescale | parrinello-rahman with pcoupltype =
isotropic, and berendsen | parrinello-rahman with semiisotropic (ref-p and
compressibility then take two values, xy and z); mttk, anisotropic,
surface-tension and semiisotropic c-rescale raise.

constraints = h-bonds | all-bonds make LINCS rows of the bonds (io/topio.py
make_hbond_constraints) solved with lincs-order and lincs-iter; h-angles,
all-angles and constraint-algorithm = shake raise, where the JAX reader
treats the angle settings as none.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.types import (CoulombType, FepCoupling, FepParams,
                          IntegratorType, MdParams, PcouplType, SoftcoreType,
                          TcouplType, VdwModifier)

_COUL = {"cut-off": CoulombType.CUTOFF, "cutoff": CoulombType.CUTOFF,
         "reaction-field": CoulombType.REACTION_FIELD, "pme": CoulombType.PME}
_VMOD = {"none": VdwModifier.NONE,
         "potential-shift": VdwModifier.POTENTIAL_SHIFT,
         "potential-shift-verlet": VdwModifier.POTENTIAL_SHIFT,
         "potential-switch": VdwModifier.POTENTIAL_SWITCH,
         "force-switch": VdwModifier.FORCE_SWITCH}
_INTEG = {"md": IntegratorType.MD, "sd": IntegratorType.SD}
_TC = {"no": TcouplType.NO, "v-rescale": TcouplType.V_RESCALE}
_PC = {"no": PcouplType.NO, "berendsen": PcouplType.BERENDSEN,
       "c-rescale": PcouplType.C_RESCALE,
       "parrinello-rahman": PcouplType.PARRINELLO_RAHMAN}
_PCT = ("isotropic", "semiisotropic")
_SC = {"beutler": SoftcoreType.BEUTLER}

_LAMBDA_KEYS = {
    FepCoupling.FEP: "fep-lambdas",
    FepCoupling.MASS: "mass-lambdas",
    FepCoupling.COUL: "coul-lambdas",
    FepCoupling.VDW: "vdw-lambdas",
    FepCoupling.BONDED: "bonded-lambdas",
    FepCoupling.RESTRAINT: "restraint-lambdas",
    FepCoupling.TEMPERATURE: "temperature-lambdas",
}


def _first(v: str) -> str:
    return v.split()[0].lower() if v.split() else ""


def _nonzero(v: str) -> bool:
    return any(float(t) != 0.0 for t in v.split())


# (key, rejects(value), what lifts it): the settings whose physics or
# output the port does not have yet.  Enumerated keys (integrator,
# coulombtype, tcoupl, ...) reject every value outside their table in
# mdp_to_params as well.
_UNSUPPORTED = (
    ("integrator", lambda v: _first(v) not in _INTEG,
     "ROADMAP item 5 (bd, md-vv) or slice 16 (steep, cg, l-bfgs, nm, "
     "tpi)"),
    ("tcoupl", lambda v: _first(v) not in _TC, "ROADMAP item 5"),
    ("tc-grps", lambda v: len(v.split()) > 1,
     "ROADMAP item 5 (one coupling group)"),
    ("pcoupl", lambda v: _first(v) not in _PC,
     "ROADMAP item 5: GROMACS runs MTTK with md-vv"),
    ("constraints", lambda v: _first(v) not in ("none", "h-bonds",
                                                "all-bonds", ""),
     "angle constraints; the JAX reader drops h-angles and all-angles "
     "silently"),
    ("constraint-algorithm", lambda v: _first(v) not in ("lincs", ""),
     "LINCS only"),
    ("sc-function", lambda v: _first(v) not in _SC,
     "ROADMAP slice 6 (Gapsys soft-core)"),
    ("vdwtype", lambda v: _first(v) not in ("cut-off", "cutoff", "shift",
                                            "switch"),
     "ROADMAP slice 15 (LJ-PME)"),
    ("coulombtype", lambda v: _first(v) not in _COUL,
     "no route in the port"),
    ("vdw-modifier", lambda v: _first(v) not in _VMOD,
     "no route in the port"),
    ("cutoff-scheme", lambda v: _first(v) != "verlet",
     "the Verlet scheme only"),
    ("comm-mode", lambda v: _first(v) != "linear",
     "linear COM removal only"),
    ("free-energy", lambda v: _first(v) not in ("no", "yes"),
     "ROADMAP item 7 (expanded ensemble)"),
    ("simulated-tempering", lambda v: _first(v) != "no", "ROADMAP item 7"),
    ("awh", lambda v: _first(v) != "no", "ROADMAP item 7 (AWH)"),
    ("delta-lambda", _nonzero, "ROADMAP item 5 (slow growth)"),
    ("pull", lambda v: _first(v) != "no", "ROADMAP slice 15 (pull)"),
    ("nwall", _nonzero, "ROADMAP slice 15 (walls)"),
    ("electric-field-x", _nonzero, "ROADMAP slice 15 (electric field)"),
    ("electric-field-y", _nonzero, "ROADMAP slice 15 (electric field)"),
    ("electric-field-z", _nonzero, "ROADMAP slice 15 (electric field)"),
    ("density-guided-simulation-active",
     lambda v: _first(v) not in ("no", "false"),
     "ROADMAP slice 15 (density fitting)"),
    ("orire", lambda v: _first(v) != "no",
     "ROADMAP slice 15 (orientation restraints)"),
    ("disre", lambda v: _first(v) != "no",
     "ROADMAP slice 15 (distance restraints)"),
    ("annealing", lambda v: any(t.lower() != "no" for t in v.split()),
     "ROADMAP item 5 (simulated annealing)"),
    ("ewald-geometry", lambda v: _first(v) != "3d",
     "ROADMAP slice 15 (Ewald surface term)"),
    ("epsilon-surface", _nonzero, "ROADMAP slice 15 (Ewald surface term)"),
    ("mts-levels", lambda v: int(v) != 2, "two MTS levels only"),
    ("mts-level2-forces",
     lambda v: v.lower().split() != ["longrange-nonbonded"],
     "MTS of the PME reciprocal force only"),
    ("nstxout", _nonzero, "ROADMAP item 8 (trr output)"),
    ("nstvout", _nonzero, "ROADMAP item 8 (trr output)"),
    ("nstfout", _nonzero, "ROADMAP item 8 (trr output)"),
    ("nstxout-compressed", _nonzero, "ROADMAP item 8 (xtc output)"),
    ("freezegrps", lambda v: bool(v.split()), "frozen atoms"),
    ("acc-grps", lambda v: bool(v.split()), "accelerated groups"),
    ("cos-acceleration", _nonzero, "cosine acceleration"),
    ("deform", _nonzero, "box deformation"),
    ("rotation", lambda v: _first(v) != "no", "enforced rotation"),
    ("swapcoords", lambda v: _first(v) != "no", "computational "
     "electrophysiology"),
    ("qmmm-active", lambda v: _first(v) not in ("no", "false"), "QM/MM"),
    ("implicit-solvent", lambda v: _first(v) != "no", "implicit solvent"),
)


def parse_mdp(text: str) -> Dict[str, str]:
    kv = {}
    for line in text.splitlines():
        line = line.split(";")[0].strip()
        if not line or "=" not in line:
            continue
        k, v = line.split("=", 1)
        kv[k.strip().lower().replace("_", "-")] = v.strip()
    return kv


def _lookup(kv: Dict[str, str], key: str) -> Optional[str]:
    """mdp keys treat '-', '_' and nothing interchangeably (coulombtype /
    coulomb-type / coulomb_type)."""
    if key in kv:
        return kv[key]
    flat = key.replace("-", "")
    for k, v in kv.items():
        if k.replace("-", "") == flat:
            return v
    return None


def unsupported_options(kv: Dict[str, str]):
    """Raise NotImplementedError for the first mdp setting the port cannot
    run, naming the key, its value and what lifts it."""
    for key, rejects, lifted_by in _UNSUPPORTED:
        v = _lookup(kv, key)
        if v is not None and v.strip() and rejects(v):
            raise NotImplementedError(
                f"mdp: {key} = {v} is not ported yet ({lifted_by})")
    pc = _first(_lookup(kv, "pcoupl") or "no")
    pct = _first(_lookup(kv, "pcoupltype") or "isotropic")
    if pc != "no" and pct not in _PCT:
        raise NotImplementedError(
            f"mdp: pcoupltype = {pct} is not ported yet (ROADMAP item 5: "
            "its box turns triclinic)")
    if pc == "c-rescale" and pct != "isotropic":
        raise NotImplementedError(
            f"mdp: pcoupltype = {pct} with pcoupl = c-rescale is not ported "
            "yet (ROADMAP item 6; the JAX step runs it as isotropic)")


def _lambda_vector(kv: Dict[str, str]):
    """Assemble (7, n_lambda) all_lambda from the per-component mdp keys
    (reference: t_lambda::all_lambda; fep-lambdas is the fallback for all
    components)."""
    fep = [float(v) for v in kv.get("fep-lambdas", "").split()]
    n = len(fep)
    cols = {}
    for c, key in _LAMBDA_KEYS.items():
        vals = [float(v) for v in kv.get(key, "").split()]
        if vals:
            n = max(n, len(vals))
        cols[c] = vals
    if n == 0:
        return None
    out = np.zeros((int(FepCoupling.COUNT), n), np.float32)
    base = fep if fep else [0.0] * n
    for c in _LAMBDA_KEYS:
        vals = cols[c] or base
        if len(vals) != n:
            raise ValueError(f"lambda vector length mismatch for {c}")
        out[int(c)] = vals
    return out


def mdp_extras(text: str) -> Dict[str, object]:
    """Grompp-level keys that shape the topology/system rather than the
    run parameters (reference: readir.cpp couple-moltype :2544-2588,
    separate_dvdl :1811-1846)."""
    kv = parse_mdp(text)
    present = [bool(kv.get(k, "").split()) for k in _LAMBDA_KEYS.values()]
    # separate_dvdl: true for every component with its own lambda array,
    # Temperature never; with scalar init-lambda only, the generic Fep
    # component is separate (readir.cpp:1811-1846)
    separate = list(present)
    separate[int(FepCoupling.TEMPERATURE)] = False
    init_lambda = float(kv.get("init-lambda", "-1") or -1)
    if not any(present) and init_lambda >= 0:
        separate[int(FepCoupling.FEP)] = True
    defines = {}
    for tok in kv.get("define", "").split():
        if tok.startswith("-D"):
            name, _, val = tok[2:].partition("=")
            defines[name] = val or "1"
    # mdp `include = -I/dir1 -I/dir2`: extra topology include search dirs
    include_dirs = [tok[2:] if tok.startswith("-I") else tok
                    for tok in kv.get("include", "").split()]
    return {
        "include_dirs": include_dirs,
        "separate_dvdl": separate,
        "couple_moltype": kv.get("couple-moltype", "").strip() or None,
        "couple_lam0": kv.get("couple-lambda0", "vdw-q").lower(),
        "couple_lam1": kv.get("couple-lambda1", "vdw-q").lower(),
        "couple_intramol": kv.get("couple-intramol", "no").lower() == "yes",
        "constraints": kv.get("constraints", "none").lower(),
        "defines": defines,
        "verlet_buffer_tolerance": float(kv.get("verlet-buffer-tolerance",
                                                "0.005")),
        "nstcalcenergy": int(kv.get("nstcalcenergy", "100")),
        "gen_vel": kv.get("gen-vel", "no").lower() == "yes",
        "gen_temp": float(kv.get("gen-temp", "300")),
        "gen_seed": int(kv.get("gen-seed", "-1")),
    }


def _pair(kv: Dict[str, str], key: str, default: str):
    """(first, last or None) of a key that semiisotropic coupling gives
    two values (xy, z): ref-p, compressibility."""
    vals = [float(t) for t in kv.get(key, default).split()]
    return vals[0], (vals[-1] if len(vals) > 1 else None)


def mdp_to_params(text: str) -> Tuple[MdParams, Optional[np.ndarray]]:
    """Returns (MdParams, all_lambda or None); raises NotImplementedError
    on a setting the port cannot run (unsupported_options)."""
    kv = parse_mdp(text)
    unsupported_options(kv)

    def get(key, default, cast=float):
        v = _lookup(kv, key)
        return cast(v) if v is not None else default

    def gete(key, table, default):
        v = _lookup(kv, key)
        return default if v is None else table[v.lower()]

    all_lambda = _lambda_vector(kv)
    sc_alpha = get("sc-alpha", 0.0)
    sc_coul = kv.get("sc-coul", "no").lower() == "yes"
    # bOneLambda: a single global lambda controls everything (scalar
    # init-lambda, or only fep-lambdas given) -> soft-core must also act on
    # Coulomb or the simultaneously vanishing LJ would leave bare charges
    # (reference: readir.cpp:1890-1893 forces bScCoul = TRUE)
    one_lambda = not any(kv.get(k, "").split()
                         for c, k in _LAMBDA_KEYS.items()
                         if c != FepCoupling.FEP)
    if one_lambda and sc_alpha > 0:
        sc_coul = True
    fep = FepParams(
        enabled=kv.get("free-energy", "no").lower() == "yes",
        init_lambda_state=get("init-lambda-state", -1, int),
        init_lambda=get("init-lambda", -1.0),
        delta_lambda=get("delta-lambda", 0.0),
        sc_alpha=sc_alpha,
        sc_power=get("sc-power", 1, int),
        sc_sigma=get("sc-sigma", 0.3),
        # grompp sets sc_sigma_min = sc_sigma
        sc_sigma_min=get("sc-sigma", 0.3),
        sc_coul=sc_coul,
        softcore=gete("sc-function", _SC, SoftcoreType.BEUTLER),
        nstdhdl=get("nstdhdl", 100, int),
        calc_lambda_neighbors=get("calc-lambda-neighbors", -1, int),
    )
    vdw_modifier = gete("vdw-modifier", _VMOD, VdwModifier.POTENTIAL_SHIFT)
    # Verlet scheme reinterprets legacy vdw-type = shift/switch as the
    # corresponding modifier on a plain cutoff (reference: readir.cpp)
    vdwtype = (_lookup(kv, "vdwtype") or "cut-off").lower()
    if vdwtype == "shift":
        vdw_modifier = VdwModifier.FORCE_SWITCH
    elif vdwtype == "switch":
        vdw_modifier = VdwModifier.POTENTIAL_SWITCH

    params = MdParams(
        dt=get("dt", 0.001),
        nsteps=get("nsteps", 0, int),
        integrator=gete("integrator", _INTEG, IntegratorType.MD),
        rcoulomb=get("rcoulomb", 1.0),
        rvdw=get("rvdw", 1.0),
        rlist=get("rlist", 1.05),
        nstlist=get("nstlist", 10, int),
        coulomb=gete("coulombtype", _COUL, CoulombType.REACTION_FIELD),
        vdw_modifier=vdw_modifier,
        vdw_type="cut-off",
        epsilon_r=get("epsilon-r", 1.0),
        epsilon_rf=get("epsilon-rf", 0.0),
        rvdw_switch=get("rvdw-switch", 0.9),
        ewald_rtol=get("ewald-rtol", 1e-5),
        fourier_spacing=get("fourier-spacing", 0.12),
        pme_order=get("pme-order", 4, int),
        dispcorr=kv.get("dispcorr", "no").lower() != "no",
        tcoupl=gete("tcoupl", _TC, TcouplType.NO),
        ref_t=float(kv.get("ref-t", "300").split()[0]),
        tau_t=float(kv.get("tau-t", "1.0").split()[0]),
        nsttcouple=get("nsttcouple", 10, int),
        pcoupl=gete("pcoupl", _PC, PcouplType.NO),
        pcoupltype=kv.get("pcoupltype", "isotropic").lower(),
        ref_p=_pair(kv, "ref-p", "1.0")[0],
        ref_p_z=_pair(kv, "ref-p", "1.0")[1],
        tau_p=get("tau-p", 5.0),
        compressibility=_pair(kv, "compressibility", "4.5e-5")[0],
        compressibility_z=_pair(kv, "compressibility", "4.5e-5")[1],
        nstpcouple=get("nstpcouple", 10, int),
        ld_seed=get("ld-seed", 1993, int),
        nstcomm=get("nstcomm", 100, int),
        nstxout=get("nstxout", 0, int),
        nstxout_compressed=get("nstxout-compressed", 0, int),
        nstcalcenergy=get("nstcalcenergy", 1, int),
        nstlog=get("nstlog", 1000, int),
        # multiple time stepping (reference: readir.cpp mts block)
        mts=get("mts", "no", str).lower() in ("yes", "true"),
        mts_factor=get("mts-level2-factor", 2, int),
        mts_forces=get("mts-level2-forces", "longrange-nonbonded", str),
        disre_fc=get("disre-fc", 1000.0),
        lincs_order=get("lincs-order", 4, int),
        lincs_iter=get("lincs-iter", 2, int),
        fep=fep,
    )
    if (params.integrator == IntegratorType.SD
            and params.tcoupl != TcouplType.NO):
        warnings.warn(f"mdp: tcoupl = {params.tcoupl.value} is set to no: "
                      "integrator sd handles temperature coupling itself "
                      "(as grompp notes)")
        params = params.replace(tcoupl=TcouplType.NO)
    return params, all_lambda
