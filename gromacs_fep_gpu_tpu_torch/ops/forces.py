"""Total-energy assembly and force evaluation on the dense O(N^2) path —
PyTorch counterpart of gromacs_fep_gpu_tpu/ops/forces.py (get_beta,
dense_group_energies, dense_energy, pairs14_energy, make_dense_force_fn).

The do_force analogue of the oracle layer: normal and soft-core FEP
non-bonded pairs, bonded terms, 1-4 pairs and the reciprocal-space energy
are summed into one differentiable scalar, and torch.autograd over (x, lam)
yields forces and the full dV/dlambda vector in one reverse pass.  The
cluster-pair path (ops/cluster_nb.py with the K1 kernel) must agree with
this module on any system, on the CPU and on the GPU alike: it is plain
tensor code in the dtype of its coordinates (float32 or float64).

Of the JAX module's optional terms only those the port's System can hold
are here, and the dispersion correction (ops/dispcorr.py), which
make_dense_force_fn adds after the gradient, as the JAX function does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import pbc as pbc_mod
from ..core.types import (CoulombType, EnergyTerms, FepCoupling, MdParams,
                          System, VdwModifier)
from ..core.units import ONE_4PI_EPS0
from . import bonded as bonded_mod
from . import nonbonded_ref as nbref
from .dispcorr import make_dispersion_correction
from .fep import FepPairData, softcore_pair_energies


def get_beta(params: MdParams) -> Optional[float]:
    if params.coulomb == CoulombType.PME:
        return nbref.ewald_beta(params.rcoulomb, params.ewald_rtol)
    return None


def _pair_setup(x, box, system: System, params: MdParams):
    """Shared dense-pair data: exclusion mask, perturbed-pair mask, the A/B
    pair parameters, r^2 and the strict upper triangle."""
    n = system.n_atoms
    epsfac = ONE_4PI_EPS0 / params.epsilon_r
    excl = nbref.exclusion_matrix(system.exclusions, n, x.dtype)
    pert = system.perturbed.to(x.dtype)
    pert_pair = torch.maximum(pert[:, None], pert[None, :])
    c6a, c12a = nbref.pair_lj_params(system, system.type_a)
    c6b, c12b = nbref.pair_lj_params(system, system.type_b)
    pair = FepPairData(
        qq_a=epsfac * system.charge_a[:, None] * system.charge_a[None, :],
        qq_b=epsfac * system.charge_b[:, None] * system.charge_b[None, :],
        c6_a=c6a, c12_a=c12a, c6_b=c6b, c12_b=c12b)
    dx = pbc_mod.pbc_dx(x[:, None, :] - x[None, :, :], box)
    r2 = torch.sum(dx * dx, -1)
    triu = torch.triu(torch.ones((n, n), dtype=x.dtype, device=x.device),
                      diagonal=1)
    return excl, pert_pair, pair, r2, triu


def dense_group_energies(x, box, lam, system: System, params: MdParams,
                         groups, beta: Optional[float] = None):
    """Per-energy-group-pair short-range (e_coul, e_lj) matrices
    (reference: mdp `energygrps`).  groups: sequence of index arrays (need
    not cover all atoms).  Returns two (G, G) matrices, each pair counted
    once in [gi, gj] with gi <= gj; exact for FEP via the soft-core path of
    dense_energy."""
    n = system.n_atoms
    lam_c, lam_v = lam[FepCoupling.COUL], lam[FepCoupling.VDW]
    excl, pert_pair, pair, r2, triu = _pair_setup(x, box, system, params)
    members = []
    for g in groups:
        m = torch.zeros((n,), dtype=x.dtype, device=x.device)
        m[torch.as_tensor(g, dtype=torch.int64, device=x.device)] = 1.0
        members.append(m)
    G = len(members)
    e_c = torch.zeros((G, G), dtype=x.dtype, device=x.device)
    e_l = torch.zeros((G, G), dtype=x.dtype, device=x.device)
    for a in range(G):
        for b in range(a, G):
            ma, mb = members[a], members[b]
            gmask = ma[:, None] * mb[None, :]
            if a != b:
                gmask = gmask + mb[:, None] * ma[None, :]
            ec_n, el_n = nbref.dense_nonbonded_energy(
                x, box, system.charge_a, pair.c6_a, pair.c12_a, excl,
                (1.0 - pert_pair) * gmask, params, beta)
            sel = pert_pair * triu * gmask
            v_c, v_v = softcore_pair_energies(
                r2, pair, lam_c, lam_v, sel * (1.0 - excl), sel * excl,
                is_self=torch.zeros_like(r2), fep=params.fep, params=params,
                beta=beta)
            e_c[a, b] = ec_n + torch.sum(v_c)
            e_l[a, b] = el_n + torch.sum(v_v)
    return e_c, e_l


def dense_energy(x, box, lam, system: System, params: MdParams,
                 beta: Optional[float] = None,
                 pme_recip_fn: Optional[Callable] = None) -> EnergyTerms:
    """Full potential-energy decomposition on the dense O(N^2) path."""
    lam_c, lam_v = lam[FepCoupling.COUL], lam[FepCoupling.VDW]
    lam_b = lam[FepCoupling.BONDED]
    excl, pert_pair, pair, r2, triu = _pair_setup(x, box, system, params)

    # normal non-bonded (unperturbed pairs; A == B there)
    e_coul_nb, e_lj_nb = nbref.dense_nonbonded_energy(
        x, box, system.charge_a, pair.c6_a, pair.c12_a, excl,
        1.0 - pert_pair, params, beta)

    # FEP soft-core pairs (>= 1 perturbed atom).  The Ewald self term of
    # the perturbed charges is part of the reciprocal term (ops/pme.py).
    sel = pert_pair * triu
    v_c_fep, v_v_fep = softcore_pair_energies(
        r2, pair, lam_c, lam_v, sel * (1.0 - excl), sel * excl,
        is_self=torch.zeros_like(r2), fep=params.fep, params=params,
        beta=beta)

    terms = EnergyTerms.zeros(x.device, x.dtype).replace(
        lj=e_lj_nb + torch.sum(v_v_fep),
        coulomb=e_coul_nb + torch.sum(v_c_fep))
    # the port has no restraint terms, so every bonded term follows
    # lambda_bonded
    for name, il in system.bonded.items():
        if il.n == 0:
            continue
        ch = bonded_mod.TERM_CHANNEL[name]
        e = bonded_mod.TERMS[name](x, box, il, lam_b)
        terms = terms.replace(**{ch: getattr(terms, ch) + e})
    if system.pairs14 is not None and system.pairs14.n > 0:
        e14c, e14l = pairs14_energy(x, box, system, lam_c, lam_v, params)
        terms = terms.replace(coul14=terms.coul14 + e14c,
                              lj14=terms.lj14 + e14l)
    if pme_recip_fn is not None:
        terms = terms.replace(
            coul_recip=terms.coul_recip + pme_recip_fn(x, box, lam_c))
    if params.vdw_type == "pme":
        raise NotImplementedError("LJ-PME is not ported yet")
    return terms


def pairs14_energy(x, box, system: System, lam_c, lam_v, params: MdParams):
    """1-4 pair interactions: bare LJ + Coulomb (no cut-off, no modifier)
    with soft-core on perturbed rows (reference: listed_forces/pairs.cpp:516
    do_pairs_general).  (coulomb, lj), with lambda's shape."""
    il = system.pairs14
    ai, aj = il.atoms[:, 0], il.atoms[:, 1]
    dxv = pbc_mod.pbc_dx(x[ai] - x[aj], box)
    r2 = torch.sum(dxv * dxv, -1)
    qq_a, c6_a, c12_a = il.params_a.unbind(-1)
    qq_b, c6_b, c12_b = il.params_b.unbind(-1)
    perturbed = (il.params_a - il.params_b).abs().amax(-1) > 0

    # plain path (state A == B); the qq carry epsfac and fudgeQQ already
    rinv = torch.rsqrt(torch.clamp(r2, min=1e-12))
    rinv6 = (rinv * rinv) ** 3
    v_c_plain = qq_a * rinv
    v_l_plain = c12_a * rinv6 * rinv6 - c6_a * rinv6

    # soft-core path for perturbed rows: the bare interaction is the
    # cut-off form with huge cut-offs and no shift
    p14 = dataclasses.replace(
        params, coulomb=CoulombType.CUTOFF, rcoulomb=1e9, rvdw=1e9,
        vdw_modifier=VdwModifier.NONE)
    pairdat = FepPairData(qq_a=qq_a, qq_b=qq_b, c6_a=c6_a, c12_a=c12_a,
                          c6_b=c6_b, c12_b=c12_b)
    v_c_sc, v_l_sc = softcore_pair_energies(
        r2, pairdat, lam_c, lam_v, included=torch.ones_like(r2),
        excluded=torch.zeros_like(r2), is_self=torch.zeros_like(r2),
        fep=params.fep, params=p14, beta=None)
    v_c = torch.where(perturbed, v_c_sc, v_c_plain)
    v_l = torch.where(perturbed, v_l_sc, v_l_plain)
    return torch.sum(il.mask * v_c, -1), torch.sum(il.mask * v_l, -1)


def make_dense_force_fn(system: System, params: MdParams,
                        pme_recip_fn: Optional[Callable] = None):
    """Returns force_fn(x, box, lam) -> (f, EnergyTerms with dvdl)."""
    beta = get_beta(params)
    disp_e_fn = (make_dispersion_correction(system, params)[0]
                 if params.dispcorr else None)

    def force_fn(x, box, lam):
        xg = x.detach().requires_grad_(True)
        lg = lam.detach().requires_grad_(True)
        with torch.enable_grad():
            terms = dense_energy(xg, box, lg, system, params, beta,
                                 pme_recip_fn)
            gx, glam = torch.autograd.grad(terms.epot, [xg, lg],
                                           allow_unused=True)
        terms = EnergyTerms(**{k: v.detach()
                               for k, v in terms.__dict__.items()})
        if glam is None:
            glam = torch.zeros_like(lam)
        if disp_e_fn is not None:
            e_dc, dvdl_dc = disp_e_fn(box, lam[FepCoupling.VDW])
            glam = glam.clone()
            glam[FepCoupling.VDW] += dvdl_dc
            terms = terms.replace(dispcorr=terms.dispcorr + e_dc)
        return -gx, terms.replace(dvdl=glam)

    return force_fn
