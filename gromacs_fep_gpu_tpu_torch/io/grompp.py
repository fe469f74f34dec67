"""grompp-lite: assemble (System, MdParams, State) from mdp + top + gro —
PyTorch-port counterpart of gromacs_fep_gpu_tpu/io/grompp.py
(gromacs_fft_dim, gromacs_pme_grid, initial_lambda_vector, Preprocessed,
preprocess_arrays; reference: src/gromacs/gmxpreprocess/grompp.cpp:1869
gmx_grompp).

The transforms run in the reference order: couple-moltype conversion,
constraints = h-bonds | all-bonds (bonds -> LINCS rows; integrator = cg
or l-bfgs with any constraint, SETTLE included, raises), the PME grid
(fft/calcgrid.cpp), gen-vel start velocities and the initial lambda
vector (mdlib/freeenergyparameters.cpp).  gen-vel draws from numpy's
default_rng exactly as the JAX package does, so the same seed gives the
same velocities.  The position restraints' reference positions are those
of grompp -r (posres_x), else the input conformation, as in the JAX
package.  The System and State are built on `device`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.types import (CoulombType, FepCoupling, IntegratorType,
                          MdParams, State, System, make_state)
from ..core.units import BOLTZ
from .mdpio import mdp_extras, mdp_to_params, parse_mdp
from .ndxio import default_groups, parse_ndx, resolve_group
from .topio import system_from_top

# fft/calcgrid.cpp grid-size tables
_GRID_INIT = [6, 8, 10, 12, 14, 16, 20, 24, 25, 28, 32, 36, 40, 42, 44]
_GRID_BASE = [45, 48, 50, 52, 54, 56, 60, 64, 70, 72, 75, 80, 81, 84]


def gromacs_fft_dim(nmin: int) -> int:
    """Smallest GROMACS-approved FFT size >= nmin
    (reference: fft/calcgrid.cpp:100-152 calcFftGrid)."""
    if _GRID_INIT[-1] >= nmin:
        for g in _GRID_INIT:
            if g >= nmin:
                return g
    fac2 = 1
    while fac2 * _GRID_BASE[-1] < nmin:
        fac2 *= 2
    best = None
    for base in reversed(_GRID_BASE):
        attempt = fac2 * base
        if ((attempt % 4 == 0 and attempt != 140) or attempt == 90) \
                and attempt >= nmin:
            best = attempt
    return best if best is not None else fac2 * _GRID_BASE[-1]


def gromacs_pme_grid(box: np.ndarray, spacing: float, pme_order: int = 4
                     ) -> Tuple[int, int, int]:
    """PME grid dims exactly as grompp computes them
    (reference: grompp.cpp:2518 calcFftGrid with minimalPmeGridSize,
    ewald/pme.cpp:457: min = 2*(order-1); spacing measured along the box
    VECTORS, not the cartesian axes)."""
    min_size = 2 * (pme_order - 1)
    dims = []
    for d in range(3):
        length = float(np.linalg.norm(box[d]))
        nmin = max(int(length / spacing + 0.999), min_size)
        dims.append(gromacs_fft_dim(nmin))
    return tuple(dims)


def initial_lambda_vector(fep, all_lambda: Optional[np.ndarray]
                          ) -> np.ndarray:
    """(7,) lambda vector at step 0
    (reference: mdlib/freeenergyparameters.cpp currentGlobalLambda +
    interpolatedLambdas)."""
    n = 0 if all_lambda is None else all_lambda.shape[1]
    if fep.init_lambda_state > -1:
        g = (fep.init_lambda_state / (n - 1)) if n > 1 else 0.0
    elif fep.init_lambda > -1:
        g = fep.init_lambda
    else:
        g = 0.0
    g = max(g, 0.0)
    if n == 0:
        return np.full((int(FepCoupling.COUNT),), g, np.float64)
    gc = min(g, 1.0)
    left = int(math.floor(gc * (n - 1)))
    right = left if left == n - 1 else left + 1
    frac = gc * (n - 1) - left
    return (all_lambda[:, left]
            + frac * (all_lambda[:, right] - all_lambda[:, left]))


def gen_velocities(masses: np.ndarray, gen_temp: float, gen_seed: int,
                   seed: int = 1993) -> np.ndarray:
    """Maxwell-Boltzmann start velocities at gen_temp, COM-stopped and
    rescaled to the exact target temperature (reference:
    gmxpreprocess/grompp.cpp maxwell_speed/low_mspeed + stopcm_gr); a
    negative gen_seed takes `seed`."""
    gseed = seed if gen_seed < 0 else gen_seed
    rng = np.random.default_rng(gseed & 0x7FFFFFFF)
    masses = np.asarray(masses, np.float64)
    has_m = masses > 0
    kT = BOLTZ * gen_temp
    sd = np.sqrt(kT / np.where(has_m, masses, 1.0))[:, None]
    v = np.where(has_m[:, None], rng.normal(size=(masses.size, 3)) * sd,
                 0.0)
    v -= (masses[:, None] * v).sum(0) / masses.sum()
    ndf = 3 * int(has_m.sum()) - 3
    t_cur = (masses[:, None] * v * v).sum() / (ndf * BOLTZ)
    v *= np.sqrt(gen_temp / max(t_cur, 1e-12))
    return v.astype(np.float32)


def set_posres_reference(system: System, xr):
    """Fill the reference positions of the position restraints (x0 of
    both states) and of the flat-bottomed ones from xr, (N, 3) (reference:
    grompp.cpp gen_posres / the -r option)."""
    xr = np.asarray(xr, np.float32)
    if xr.shape[0] != system.n_atoms:
        raise ValueError(f"posres reference has {xr.shape[0]} atoms, "
                         f"topology {system.n_atoms}")
    for name, cols, states in (("posres", slice(0, 3),
                                ("params_a", "params_b")),
                               ("fbposres", slice(1, 4), ("params_a",))):
        il = system.bonded.get(name)
        if il is None:
            continue
        x0 = torch.as_tensor(xr, device=il.atoms.device)[il.atoms[:, 0]]
        for st in states:
            p = getattr(il, st).clone()
            p[:, cols] = x0
            setattr(il, st, p)
        if name == "fbposres":   # state A only: B mirrors it
            il.params_b = il.params_a.clone()


@dataclasses.dataclass
class Preprocessed:
    """The tpr analogue: everything mdrun needs."""
    system: System
    params: MdParams
    state: State
    all_lambda: Optional[np.ndarray]
    separate_dvdl: List[bool]
    extras: Dict[str, object]
    atom_names: List[str]
    res_names: List[str]


def preprocess_arrays(mdp_text: str, top_text: str, names, resnames,
                      x: np.ndarray, v: Optional[np.ndarray], box: np.ndarray,
                      include_dirs: Optional[List[str]] = None,
                      seed: int = 1993,
                      couple_moltype_override: Optional[str] = None,
                      ndx_text: Optional[str] = None,
                      posres_x: Optional[np.ndarray] = None,
                      device="cuda") -> Preprocessed:
    """The gmx_grompp analogue (in-memory tpr) on `device`."""
    params, all_lambda = mdp_to_params(mdp_text)
    extras = mdp_extras(mdp_text)
    if couple_moltype_override:
        extras["couple_moltype"] = couple_moltype_override
    # mdp `include =` dirs extend the caller's search path
    include_dirs = list(include_dirs or []) + list(extras["include_dirs"])

    system = system_from_top(
        top_text, include_dirs=include_dirs,
        couple_moltype=extras["couple_moltype"],
        couple_lam0=extras["couple_lam0"],
        couple_lam1=extras["couple_lam1"],
        couple_intramol=extras["couple_intramol"],
        constraints=extras["constraints"],
        defines=extras["defines"], epsilon_r=params.epsilon_r,
        device=device)
    if system.n_atoms != x.shape[0]:
        raise ValueError(f"topology has {system.n_atoms} atoms, "
                         f"coordinates {x.shape[0]}")
    set_posres_reference(system, x if posres_x is None else posres_x)
    n_settle = int(system.settle.atoms.shape[0])
    if (params.integrator in (IntegratorType.CG, IntegratorType.LBFGS)
            and n_settle + int(system.lincs.atoms.shape[0]) > 0):
        raise NotImplementedError(
            f"integrator = {params.integrator.value} with {n_settle} SETTLE "
            f"water(s) and {int(system.lincs.atoms.shape[0])} constraint(s):"
            f" {params.integrator.value} cannot run with constraints, SETTLE "
            "included (GROMACS refuses them); use integrator = steep, or "
            "flexible water (define = -DFLEXIBLE with a topology that has "
            "it)")

    # energy groups name index groups (reference: readir.cpp do_egp_flag):
    # checked here; md writes no per-group energies, as in the JAX package
    eg_names = parse_mdp(mdp_text).get("energygrps", "").split()
    if eg_names:
        ndx = default_groups(names, resnames) if len(names) else {}
        if ndx_text:
            ndx.update(parse_ndx(ndx_text))
        for nm in eg_names:
            resolve_group(nm, ndx, system.n_atoms)

    if params.coulomb == CoulombType.PME and params.pme_grid is None:
        params = params.replace(
            pme_grid=gromacs_pme_grid(box, params.fourier_spacing,
                                      params.pme_order))

    if extras.get("gen_vel"):
        v = gen_velocities(system.mass_a.cpu().numpy(),
                           float(extras.get("gen_temp", 300.0)),
                           int(extras.get("gen_seed", -1)), seed)

    lam0 = initial_lambda_vector(params.fep, all_lambda)
    fep_state = max(params.fep.init_lambda_state, 0)
    state = make_state(x, v, box, lam=lam0.astype(np.float32),
                       device=device, fep_state=fep_state)
    return Preprocessed(system=system, params=params, state=state,
                        all_lambda=all_lambda,
                        separate_dvdl=extras["separate_dvdl"],
                        extras=extras, atom_names=list(names),
                        res_names=list(resnames))
