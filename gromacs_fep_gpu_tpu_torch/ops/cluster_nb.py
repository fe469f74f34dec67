"""Production force assembly — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/cluster_nb.py (lj_table_mode, fep_pair_energy,
make_cluster_force_fn with other_energy and the MTS recip_scale /
skip_recip path).

The plain non-bonded pairs go through the K1 kernel (ops/nb_v2u.py) on the
union lists; everything else that is cheap — soft-core FEP pairs, bonds,
angles — is one differentiable energy whose forces and dV/dlambda come from
torch.autograd (jax.grad on the JAX side).  The PME reciprocal part runs
the K2/K3 kernels (ops/pme.py make_pme_recip_pair).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import pbc as pbc_mod
from ..core.types import (EnergyTerms, FepCoupling, MdParams, System,
                          VdwModifier)
from ..core.units import ONE_4PI_EPS0
from . import bonded as bonded_mod
from .fep import FepPairData, softcore_pair_energies
from .forces import get_beta
from .nb_v2u import NbConstants, PrepV2U, cluster_forces_v2u
from .pairlist import ClusterPairlist, FepPairlist


def lj_table_mode(nbfp_np) -> str:
    """'geometric' when the (T, T, 2) table factorizes as sqrt-outer
    products (comb-rule 1/3), else 'table'."""
    nbfp_np = np.asarray(nbfp_np)
    for p in range(2):
        d = np.sqrt(np.maximum(np.diagonal(nbfp_np[:, :, p]), 0.0))
        if not np.allclose(nbfp_np[:, :, p], np.outer(d, d), rtol=1e-5,
                           atol=1e-12):
            return "table"
    return "geometric"


def fep_pair_energy(x, box, lam_c, lam_v, feplist: FepPairlist,
                    system: System, params: MdParams, beta):
    """Soft-core (coulomb, vdw) energies summed over the flat FEP pair
    list; (L,) each when the lambdas are (L,) vectors."""
    epsfac = ONE_4PI_EPS0 / params.epsilon_r
    ii, jj = feplist.iidx, feplist.jidx
    dx = pbc_mod.pbc_dx(x[ii] - x[jj], box)
    r2 = torch.sum(dx * dx, -1)
    ta_i, ta_j = system.type_a[ii], system.type_a[jj]
    tb_i, tb_j = system.type_b[ii], system.type_b[jj]
    pair = FepPairData(
        qq_a=epsfac * system.charge_a[ii] * system.charge_a[jj],
        qq_b=epsfac * system.charge_b[ii] * system.charge_b[jj],
        c6_a=system.nbfp[ta_i, ta_j, 0], c12_a=system.nbfp[ta_i, ta_j, 1],
        c6_b=system.nbfp[tb_i, tb_j, 0], c12_b=system.nbfp[tb_i, tb_j, 1])
    v_c, v_v = softcore_pair_energies(
        r2, pair, lam_c, lam_v, feplist.included, feplist.excluded,
        is_self=torch.zeros_like(r2), fep=params.fep, params=params,
        beta=beta)
    return torch.sum(v_c, -1), torch.sum(v_v, -1)


def make_cluster_force_fn(system: System, params: MdParams,
                          has_fep: Optional[bool] = None,
                          pme_recip_force_fn: Optional[Callable] = None):
    """force_fn(x, box, lam, nlist, feplist, prep, need_energy=True,
    recip_scale=1.0, skip_recip=False) -> (f, EnergyTerms).

    need_energy=False runs the force-only K1 flavour and skips the
    dV/dlambda backward pass.  recip_scale / skip_recip are multiple time
    stepping of the PME reciprocal force: on-steps apply the recip force
    scaled by the MTS factor, off-steps skip it; energies and dvdl stay
    unscaled."""
    beta = get_beta(params)
    if has_fep is None:
        has_fep = bool(system.perturbed.any())
    nbfp_np = system.nbfp.cpu().numpy()
    if (lj_table_mode(nbfp_np) != "geometric"
            or params.vdw_modifier != VdwModifier.POTENTIAL_SHIFT
            or params.vdw_type != "cut-off"):
        raise NotImplementedError(
            "only the geometric-LJ, potential-shift cluster kernel (v2u) is "
            "ported; the XLA table kernel is not")
    if params.dispcorr:
        raise NotImplementedError("dispersion correction is not ported yet")
    if (params.coulomb.value == "pme") != (pme_recip_force_fn is not None):
        raise ValueError("PME needs pme_recip_force_fn and vice versa")
    consts = NbConstants.from_params(params, beta)
    n_lam = int(FepCoupling.COUNT)

    def other_energy(x, lam, box, feplist):
        """FEP pairs + bonded terms as one scalar for autograd."""
        lam_c, lam_v = lam[FepCoupling.COUL], lam[FepCoupling.VDW]
        lam_b = lam[FepCoupling.BONDED]
        terms = EnergyTerms.zeros(x.device)
        if has_fep and feplist is not None:
            e_c, e_v = fep_pair_energy(x, box, lam_c, lam_v, feplist,
                                       system, params, beta)
            terms = terms.replace(coulomb=e_c, lj=e_v)
        for name, il in system.bonded.items():
            ch = bonded_mod.TERM_CHANNEL[name]
            e = bonded_mod.TERMS[name](x, box, il, lam_b)
            terms = terms.replace(**{ch: getattr(terms, ch) + e})
        return terms.epot, terms

    def force_fn(x, box, lam, nlist: ClusterPairlist,
                 feplist: Optional[FepPairlist] = None,
                 prep: Optional[PrepV2U] = None, need_energy: bool = True,
                 recip_scale: float = 1.0, skip_recip: bool = False):
        f_sorted, e_coul, e_lj = cluster_forces_v2u(
            x, box, nlist, prep, consts, compute_energy=need_energy)
        f_cluster = f_sorted[nlist.inv_perm]

        xg = x.detach().requires_grad_(True)
        lg = lam.detach().requires_grad_(need_energy)
        with torch.enable_grad():
            epot, terms = other_energy(xg, lg, box, feplist)
            inputs = [xg, lg] if need_energy else [xg]
            grads = torch.autograd.grad(epot, inputs, allow_unused=True)
        gx = grads[0] if grads[0] is not None else torch.zeros_like(x)
        if need_energy:
            glam = (grads[1] if grads[1] is not None
                    else torch.zeros_like(lam))
        else:
            glam = torch.full((n_lam,), float("nan"), dtype=x.dtype,
                              device=x.device)
        terms = EnergyTerms(**{k: v.detach() for k, v in
                               terms.__dict__.items()})
        f = f_cluster - gx
        if pme_recip_force_fn is not None and not skip_recip:
            e_rec, f_rec, dvdl_rec = pme_recip_force_fn(
                x, box, lam[FepCoupling.COUL])
            f = f + recip_scale * f_rec
            terms = terms.replace(coul_recip=e_rec)
            if need_energy:
                glam = glam.clone()
                glam[FepCoupling.COUL] += dvdl_rec
        terms = terms.replace(coulomb=terms.coulomb + e_coul,
                              lj=terms.lj + e_lj, dvdl=glam)
        return f, terms

    return force_fn
