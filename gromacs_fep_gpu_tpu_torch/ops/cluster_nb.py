"""Production force assembly — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/cluster_nb.py (lj_table_mode, cluster_nb_kernel,
fep_pair_energy, make_cluster_force_fn with other_energy and the MTS
recip_scale / skip_recip path).

The plain non-bonded pairs go through one of five layouts: K1 on the v2u
union lists (ops/nb_v2u.py, the default), K7a/K7b/K7c ("super",
"cluster", "v2") or the table route, the XLA cluster_nb_kernel's
counterpart (ops/nb_cluster.py).  The kernel layouts are geometric-LJ,
potential-shift kernels: a non-geometric LJ table (Lorentz-Berthelot) or
another vdW modifier demotes the force to the table route, where the JAX
package falls back from its Pallas kernels to the XLA kernel
(`effective_layout`).  LJ-PME raises.  Everything else that is cheap — soft-core FEP pairs, bonds,
angles, 1-4 pairs — is one differentiable energy whose forces and
dV/dlambda come from torch.autograd (jax.grad on the JAX side).  The PME
reciprocal part runs the K2/K3 kernels (ops/pme.py make_pme_recip_pair).
The dispersion correction (DispCorr = EnerPres) adds its energy and its
dV/dlambda_vdw; its pressure is the step's (ops/dispcorr.py p_tail).

need_virial=True (the pressure steps of an NPT run) fills terms.vir_diag
with the diagonal potential virial from the same force pass: the K1 (or
table-route) kernel's pair sums, the strain gradient of the cheap energy (taken in the
same backward pass as its forces: the energy is evaluated at x s, box s
with s = 1 + eps, eps = 0) and the reciprocal term's strain derivative on
the force pass's grids.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import pbc as pbc_mod
from ..core.types import (EnergyTerms, FepCoupling, MdParams, PcouplType,
                          System, VdwModifier)
from ..core.units import ONE_4PI_EPS0
from . import bonded as bonded_mod
from .fep import FepPairData, softcore_pair_energies
from .dispcorr import make_dispersion_correction
from .forces import get_beta, pairs14_energy
from . import nb_cluster
from .nb_v2u import NbConstants, cluster_forces_v2u
from .pairlist import ClusterPairlist, FepPairlist

LAYOUTS = ("v2u",) + nb_cluster.LAYOUTS


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


def effective_layout(nbfp_np, params: MdParams, layout: str) -> str:
    """The layout the force runs on: the kernel layouts (v2u, super,
    cluster, v2) hold the geometric-LJ, potential-shift kernels only, so a
    table-mode LJ or another vdW modifier demotes to the table route, as
    the JAX package drops use_pallas (cluster_nb.py:435-441,
    runner.py:199-207).  LJ-PME is not ported and raises."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    if params.vdw_type == "pme":
        raise NotImplementedError("LJ-PME (vdw_type = pme) is not ported "
                                  "yet")
    if params.vdw_type != "cut-off":
        raise ValueError(f"vdw_type {params.vdw_type!r}")
    if (lj_table_mode(nbfp_np) != "geometric"
            or params.vdw_modifier != VdwModifier.POTENTIAL_SHIFT):
        return "table"
    return layout


def cluster_nb_kernel(x, box, nlist: ClusterPairlist, nbfp,
                      params: MdParams, beta: Optional[float],
                      lj_mode: str = "table", compute_virial: bool = False,
                      compute_energy: bool = True):
    """Analytic forces and energies over the per-cluster list: (f_sorted
    (n_pad, 3), e_coul, e_lj[, vir_diag (3,)]), the JAX XLA kernel's
    outputs (energies halved, the virial -1/4 of the pair sums).  It runs
    the table route: its plain version (nb_cluster.cluster_nb_kernel_core)
    on CPU tensors, its CUDA kernel on CUDA tensors."""
    prep = nb_cluster.prepare_table(nlist, nbfp, lj_mode)
    return nb_cluster.cluster_forces(
        x, box, nlist, prep, NbConstants.from_params(params, beta),
        compute_energy=compute_energy, compute_virial=compute_virial)


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
                          pme_recip_force_fn: Optional[Callable] = None,
                          layout: str = "v2u",
                          nb_kernel_override: Optional[Callable] = None):
    """force_fn(x, box, lam, nlist, feplist, prep, need_energy=True,
    need_virial=False, recip_scale=1.0, skip_recip=False) -> (f,
    EnergyTerms); force_fn.layout is the layout it runs
    (effective_layout), and prep must be that layout's pack (PrepV2U or
    nb_cluster.PrepCluster).

    need_energy=False runs the force-only kernel flavour and skips the
    dV/dlambda backward pass.  need_virial=True (energies included) runs
    the kernel's virial flavour (K1 or the table route; K7a/b/c have none
    and raise) and fills terms.vir_diag.  recip_scale / skip_recip are
    multiple time stepping of the PME reciprocal force: on-steps apply the
    recip force scaled by the MTS factor, off-steps skip it; energies, dvdl
    and the virial stay unscaled.

    nb_kernel_override(x, box, nlist, prep=prep, need_energy=...) ->
    (f_sorted, e_coul, e_lj) replaces the plain non-bonded kernel: the
    domain-decomposition routes of parallel/spatial.py plug in here (the
    JAX hook of the same name), prep being their per-rebuild pack.  It has
    no virial flavour: pressure coupling raises."""
    beta = get_beta(params)
    if has_fep is None:
        has_fep = bool(system.perturbed.any())
    layout = effective_layout(system.nbfp.cpu().numpy(), params, layout)
    if params.pcoupl != PcouplType.NO and nb_kernel_override is not None:
        raise NotImplementedError(
            "pressure coupling under domain decomposition is not ported "
            "(the JAX runner keeps its decomposed virial off under DD)")
    if params.pcoupl != PcouplType.NO and layout not in ("v2u", "table"):
        raise NotImplementedError(
            f"pressure coupling on the {layout} layout: its kernel has no "
            "virial flavour (the JAX package takes an autograd pressure "
            "there); use layout v2u or table")
    disp_e_fn = (make_dispersion_correction(system, params)[0]
                 if params.dispcorr else None)
    has_pairs14 = system.pairs14 is not None and system.pairs14.n > 0
    if (params.coulomb.value == "pme") != (pme_recip_force_fn is not None):
        raise ValueError("PME needs pme_recip_force_fn and vice versa")
    consts = NbConstants.from_params(params, beta)
    n_lam = int(FepCoupling.COUNT)

    def other_energy(x, lam, box, feplist):
        """FEP pairs + bonded terms + 1-4 pairs as one scalar for
        autograd."""
        lam_c, lam_v = lam[FepCoupling.COUL], lam[FepCoupling.VDW]
        terms = EnergyTerms.zeros(x.device)
        if has_fep and feplist is not None:
            e_c, e_v = fep_pair_energy(x, box, lam_c, lam_v, feplist,
                                       system, params, beta)
            terms = terms.replace(coulomb=e_c, lj=e_v)
        for name, il in system.bonded.items():
            ch = bonded_mod.TERM_CHANNEL[name]
            e = bonded_mod.listed_energy(name, x, box, il, lam,
                                         params.disre_fc)
            terms = terms.replace(**{ch: getattr(terms, ch) + e})
        if has_pairs14:
            e14c, e14l = pairs14_energy(x, box, system, lam_c, lam_v, params)
            terms = terms.replace(coul14=terms.coul14 + e14c,
                                  lj14=terms.lj14 + e14l)
        return terms.epot, terms

    def force_fn(x, box, lam, nlist: ClusterPairlist,
                 feplist: Optional[FepPairlist] = None,
                 prep=None, need_energy: bool = True,
                 need_virial: bool = False, recip_scale: float = 1.0,
                 skip_recip: bool = False):
        if need_virial and pme_recip_force_fn is not None and skip_recip:
            raise ValueError("a pressure step must evaluate the reciprocal "
                             "term (align nstpcouple with the MTS factor)")
        if nb_kernel_override is not None:
            if need_virial:
                raise NotImplementedError("the virial under domain "
                                          "decomposition is not ported")
            out = nb_kernel_override(x, box, nlist, prep=prep,
                                     need_energy=need_energy)
        elif layout == "v2u":
            out = cluster_forces_v2u(x, box, nlist, prep, consts,
                                     compute_energy=need_energy,
                                     compute_virial=need_virial)
        else:
            if need_virial and layout != "table":
                raise NotImplementedError(
                    f"the {layout} layout has no virial flavour (the JAX "
                    "package takes an autograd pressure there): run "
                    "pressure coupling on the v2u layout or the table "
                    "route")
            if prep.layout != layout:
                raise ValueError(f"a {prep.layout} pack on the {layout} "
                                 "force")
            out = nb_cluster.cluster_forces(x, box, nlist, prep, consts,
                                            compute_energy=need_energy,
                                            compute_virial=need_virial)
        f_sorted, e_coul, e_lj = out[:3]
        f_cluster = f_sorted[nlist.inv_perm]

        xg = x.detach().requires_grad_(True)
        lg = lam.detach().requires_grad_(need_energy)
        inputs = [xg, lg] if need_energy else [xg]
        with torch.enable_grad():
            xe, boxe = xg, box
            if need_virial:
                eps = torch.zeros(3, dtype=x.dtype, device=x.device,
                                  requires_grad=True)
                s = 1.0 + eps
                xe, boxe = xg * s, box * s[None, :]
                inputs.append(eps)
            epot, terms = other_energy(xe, lg, boxe, feplist)
            # a system with no cheap term (plain water) leaves no graph
            grads = (torch.autograd.grad(epot, inputs, allow_unused=True)
                     if epot.requires_grad else [None] * len(inputs))
        gx = grads[0] if grads[0] is not None else torch.zeros_like(x)
        if need_energy:
            glam = (grads[1] if grads[1] is not None
                    else torch.zeros_like(lam))
        else:
            glam = torch.full((n_lam,), float("nan"), dtype=x.dtype,
                              device=x.device)
        terms = EnergyTerms(**{k: v.detach() for k, v in
                               terms.__dict__.items()})
        if need_virial:
            g_eps = grads[-1] if grads[-1] is not None else torch.zeros(
                3, dtype=x.dtype, device=x.device)
            terms = terms.replace(vir_diag=out[3] + 0.5 * g_eps)
        f = f_cluster - gx
        if pme_recip_force_fn is not None and not skip_recip:
            rec = pme_recip_force_fn(x, box, lam[FepCoupling.COUL],
                                     need_virial=need_virial)
            e_rec, f_rec, dvdl_rec = rec[:3]
            f = f + recip_scale * f_rec
            terms = terms.replace(coul_recip=e_rec)
            if need_energy:
                glam = glam.clone()
                glam[FepCoupling.COUL] += dvdl_rec
            if need_virial:
                terms = terms.replace(vir_diag=terms.vir_diag + rec[3])
        terms = terms.replace(coulomb=terms.coulomb + e_coul,
                              lj=terms.lj + e_lj, dvdl=glam)
        if disp_e_fn is not None:
            e_dc, dvdl_dc = disp_e_fn(box, lam[FepCoupling.VDW])
            terms = terms.replace(dispcorr=terms.dispcorr + e_dc)
            if need_energy:
                glam = glam.clone()
                glam[FepCoupling.VDW] += dvdl_dc
                terms = terms.replace(dvdl=glam)
        return f, terms

    force_fn.layout = layout
    return force_fn
