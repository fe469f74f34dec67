"""Soft-core FEP pair energies — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/fep.py (softcore_pair_energies, Beutler branch),
plus rf_constants / ewald_beta / vdw_shift_constants from
ops/nonbonded_ref.py and get_beta from ops/forces.py.

The energy is written as a differentiable function of (r^2, lambda), so
torch.autograd yields forces and dV/dlambda including the soft-core chain
rule (reference: nb_free_energy.cpp:1005-1013), as jax.grad does on the
JAX side.  Conventions (r^2 floor, r^-6 clamp, sigma^6 rules, Ewald and RF
exclusion corrections) are the JAX module's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.types import (CoulombType, FepParams, MdParams, SoftcoreType,
                          VdwModifier)

MIN_DIST_SQ = 1.0e-6
MAX_RINV_SIX = 1.0e15


def rf_constants(params: MdParams) -> Tuple[float, float]:
    """Reaction-field k_rf and c_rf (reference: forcerec.cpp calc_rffac)."""
    rc = params.rcoulomb
    eps_r, eps_rf = params.epsilon_r, params.epsilon_rf
    if eps_rf == 0.0:
        krf = 1.0 / (2.0 * rc ** 3)
    else:
        krf = (eps_rf - eps_r) / (2.0 * eps_rf + eps_r) / rc ** 3
    return krf, 1.0 / rc + krf * rc ** 2


def ewald_beta(rc: float, rtol: float) -> float:
    """Ewald splitting parameter by bisection on erfc(beta rc) = rtol
    (reference: ewald_utils.h calc_ewaldcoeff_q)."""
    lo, hi = 0.0, 50.0
    for _ in range(100):
        beta = 0.5 * (lo + hi)
        if math.erfc(beta * rc) > rtol:
            lo = beta
        else:
            hi = beta
    return 0.5 * (lo + hi)


def get_beta(params: MdParams) -> Optional[float]:
    if params.coulomb == CoulombType.PME:
        return ewald_beta(params.rcoulomb, params.ewald_rtol)
    return None


def vdw_shift_constants(params: MdParams) -> Tuple[float, float]:
    """Constant potential shifts (cpot) of dispersion and repulsion."""
    if params.vdw_modifier == VdwModifier.POTENTIAL_SHIFT:
        rc = params.rvdw
        return -1.0 / rc ** 6, -1.0 / rc ** 12
    if params.vdw_modifier == VdwModifier.NONE:
        return 0.0, 0.0
    raise NotImplementedError(
        f"vdw-modifier {params.vdw_modifier.value} is not ported yet")


class FepPairData(NamedTuple):
    """Per-pair A/B parameters (qq already carries epsfac)."""
    qq_a: torch.Tensor
    qq_b: torch.Tensor
    c6_a: torch.Tensor
    c12_a: torch.Tensor
    c6_b: torch.Tensor
    c12_b: torch.Tensor


def softcore_pair_energies(r2, pair: FepPairData, lam_coul, lam_vdw,
                           included, excluded, is_self, fep: FepParams,
                           params: MdParams, beta: Optional[float] = None):
    """Per-pair (v_coul, v_vdw) of perturbed pairs, Beutler soft-core.

    included: 1 for real non-excluded pairs; excluded: 1 for pairs on the
    exclusion list (they still get the RF/Ewald corrections); padding rows
    have both 0.  is_self: the i==i pair, counted with factor 1/2."""
    if fep.softcore != SoftcoreType.BEUTLER:
        raise NotImplementedError("Gapsys soft-core is not ported yet")
    dtype = r2.dtype
    # masked lanes park at r = 1 so no intermediate overflows before the
    # mask zeroes it (0 * inf would poison the backward pass)
    active = (included + excluded) > 0
    r2 = torch.where(active, torch.clamp(r2, min=MIN_DIST_SQ),
                     torch.ones_like(r2))
    rinv = torch.rsqrt(r2)
    r = r2 * rinv
    rp = r2 * r2 * r2

    p = fep.sc_power
    bshape = (2,) + (1,) * r2.ndim
    lfac_c = torch.stack([1.0 - lam_coul, lam_coul]).reshape(bshape)
    lfac_v = torch.stack([1.0 - lam_vdw, lam_vdw]).reshape(bshape)
    sc_lf_c = (1.0 - lfac_c) ** p
    sc_lf_v = (1.0 - lfac_v) ** p

    qq = torch.stack([pair.qq_a, pair.qq_b])
    c6 = torch.stack([pair.c6_a, pair.c6_b])
    c12 = torch.stack([pair.c12_a, pair.c12_b])

    sigma6_def = fep.sc_sigma ** 6
    sigma6_min = fep.sc_sigma_min ** 6 if fep.sc_coul else 0.0
    have_lj = (c6 > 0) & (c12 > 0)
    sigma6 = torch.where(
        have_lj,
        torch.clamp(c12 / torch.where(c6 > 0, c6, torch.ones_like(c6)),
                    min=sigma6_min),
        torch.full_like(c6, sigma6_def))

    sc_on = (~((pair.c12_a > 0) & (pair.c12_b > 0))).to(dtype)
    alpha_v = fep.sc_alpha * sc_on
    alpha_c = (fep.sc_alpha if fep.sc_coul else 0.0) * sc_on

    if fep.sc_alpha != 0.0:
        rpinv_c = 1.0 / (alpha_c * sc_lf_c * sigma6 + rp)
        rinv_c = torch.pow(torch.sqrt(rpinv_c), 1.0 / 3.0)
        rpinv_v = 1.0 / (alpha_v * sc_lf_v * sigma6 + rp)
        rinv_v = torch.pow(torch.sqrt(rpinv_v), 1.0 / 3.0)
    else:
        rpinv_c = rpinv_v = (rinv * rinv) ** 3 * torch.ones_like(sigma6)
        rinv_c = rinv_v = rinv * torch.ones_like(sigma6)
    r_c = 1.0 / rinv_c
    r_v = 1.0 / rinv_v

    inc = included
    qq_nz = (qq != 0).to(dtype)
    if params.coulomb == CoulombType.PME:
        sh_ewald = float(torch.special.erfc(
            torch.tensor(beta * params.rcoulomb, dtype=dtype))) \
            / params.rcoulomb
        mask_c = (r < params.rcoulomb).to(dtype) * qq_nz * inc
        v_c = qq * (rinv_c - sh_ewald) * mask_c
    elif params.coulomb == CoulombType.REACTION_FIELD:
        krf, crf = rf_constants(params)
        mask_c = (r_c < params.rcoulomb).to(dtype) * qq_nz * inc
        v_c = qq * (rinv_c + krf * r_c * r_c - crf) * mask_c
    else:
        mask_c = (r_c < params.rcoulomb).to(dtype) * qq_nz * inc
        v_c = qq * (rinv_c - 1.0 / params.rcoulomb) * mask_c

    rinv6 = torch.clamp(rpinv_v, max=MAX_RINV_SIX)
    mask_v = ((r_v < params.rvdw).to(dtype)
              * ((c6 != 0) | (c12 != 0)).to(dtype) * inc)
    cp6, cp12 = vdw_shift_constants(params)
    v_v = (c12 * rinv6 * rinv6 - c6 * rinv6 + c12 * cp12 - c6 * cp6) * mask_v

    v_coul = torch.sum(lfac_c * v_c, dim=0)
    v_vdw = torch.sum(lfac_v * v_v, dim=0)

    self_fac = torch.where(is_self > 0, 0.5, 1.0).to(dtype)
    if params.coulomb == CoulombType.REACTION_FIELD:
        krf, crf = rf_constants(params)
        in_rc = (r2 < params.rcoulomb ** 2).to(dtype)
        vv = (krf * r2 - crf) * self_fac * excluded * in_rc
        v_coul = v_coul + torch.sum(lfac_c * qq, dim=0) * vv
    elif params.coulomb == CoulombType.PME:
        in_rc = (r2 < params.rcoulomb ** 2).to(dtype)
        corr_mask = torch.maximum(excluded, inc * in_rc)
        v_lr = torch.erf(beta * r) * rinv * self_fac * corr_mask
        v_coul = v_coul - torch.sum(lfac_c * qq, dim=0) * v_lr
    return v_coul, v_vdw
