"""Dense O(N^2) reference non-bonded energies, the oracle layer — PyTorch
counterpart of gromacs_fep_gpu_tpu/ops/nonbonded_ref.py (exclusion_matrix,
rf_constants, forceswitch_constants, vdw_shift_constants, ewald_beta,
_coulomb_pair_energy, _lj_pair_energy, _potential_switch,
dense_nonbonded_energy, pair_lj_params).

Plays the role of the reference's plain-C kernels (kernel_ref.cpp,
nb_free_energy.cpp): the cluster-pair kernels are held against these on
small systems.  Every function is energy-only and differentiable, in the
dtype of its coordinates (float32 or float64); forces and dV/dlambda come
from torch.autograd at the assembly level (ops/forces.py).  LJ-PME is not
ported: vdw_type "pme" raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core import pbc as pbc_mod
from ..core.types import CoulombType, MdParams, System, VdwModifier
from ..core.units import ONE_4PI_EPS0


def exclusion_matrix(excl_idx: torch.Tensor, n: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Dense (n, n) mask: 1.0 where the pair is EXCLUDED."""
    rows = torch.arange(n, device=excl_idx.device)[:, None].expand_as(
        excl_idx)
    valid = excl_idx >= 0
    m = torch.zeros((n, n), dtype=dtype, device=excl_idx.device)
    m[rows[valid], excl_idx[valid]] = 1.0
    return m


def rf_constants(params: MdParams) -> Tuple[float, float]:
    """Reaction-field k_rf and c_rf (reference: forcerec.cpp calc_rffac)."""
    rc = params.rcoulomb
    eps_r, eps_rf = params.epsilon_r, params.epsilon_rf
    if eps_rf == 0.0:  # conducting boundary (infinity)
        krf = 1.0 / (2.0 * rc ** 3)
    else:
        krf = (eps_rf - eps_r) / (2.0 * eps_rf + eps_r) / rc ** 3
    return krf, 1.0 / rc + krf * rc ** 2


def forceswitch_constants(p: float, rsw: float, rc: float):
    """(c2, c3, cpot) for force-switched r^-p
    (reference: interaction_const.cpp:216 force_switch_constants):
    force/p = r^-(p+1) + c2 r^2 + c3 r^3 for r > rsw;
    potential = r^-p + (p c2/3)(r-rsw)^3 + (p c3/4)(r-rsw)^4 + cpot."""
    c2 = ((p + 1) * rsw - (p + 4) * rc) / (rc ** (p + 2) * (rc - rsw) ** 2)
    c3 = -((p + 1) * rsw - (p + 3) * rc) / (rc ** (p + 2) * (rc - rsw) ** 3)
    cpot = (-(rc ** -p) + p * c2 / 3 * (rc - rsw) ** 3
            + p * c3 / 4 * (rc - rsw) ** 4)
    return c2, c3, cpot


def vdw_shift_constants(params: MdParams) -> Tuple[float, float]:
    """Constant potential shifts (cpot) of dispersion and repulsion under
    the active vdW modifier; this is all the FEP kernel applies even for
    force-switch (reference: nb_free_energy.cpp:344-345)."""
    rc = params.rvdw
    if params.vdw_modifier == VdwModifier.POTENTIAL_SHIFT:
        return -1.0 / rc ** 6, -1.0 / rc ** 12
    if params.vdw_modifier == VdwModifier.FORCE_SWITCH:
        _, _, cpot6 = forceswitch_constants(6.0, params.rvdw_switch, rc)
        _, _, cpot12 = forceswitch_constants(12.0, params.rvdw_switch, rc)
        return cpot6, cpot12
    return 0.0, 0.0


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


def _coulomb_pair_energy(qq, r, rinv, incut, excluded, params: MdParams,
                         beta: Optional[float]):
    """Per-pair Coulomb energy including exclusion corrections: excluded
    pairs still receive the RF constant terms / the Ewald reciprocal
    compensation (the scale-don't-skip convention of
    nbnxm_cuda_kernel.cuh:487-529)."""
    included = 1.0 - excluded
    if params.coulomb == CoulombType.CUTOFF:
        return qq * (rinv - 1.0 / params.rcoulomb) * included * incut
    if params.coulomb == CoulombType.REACTION_FIELD:
        krf, crf = rf_constants(params)
        return qq * (included * rinv + krf * r * r - crf) * incut
    if params.coulomb == CoulombType.PME:
        # short range qq (erfc(br)/r - sh_ewald) inside the cut-off;
        # excluded pairs get -qq erf(br)/r at ANY distance (the reciprocal
        # sum includes them) but no shift
        sh_ewald = math.erfc(beta * params.rcoulomb) / params.rcoulomb
        sr = qq * (rinv * torch.erfc(beta * r) - sh_ewald) * included * incut
        return sr - qq * rinv * torch.erf(beta * r) * excluded
    raise ValueError(params.coulomb)


def _lj_pair_energy(c6, c12, r2, rinv2, incut, params: MdParams):
    if params.vdw_type == "pme":
        raise NotImplementedError("LJ-PME is not ported yet")
    rinv6 = rinv2 * rinv2 * rinv2
    v = c12 * rinv6 * rinv6 - c6 * rinv6
    if params.vdw_modifier == VdwModifier.POTENTIAL_SHIFT:
        rcinv6 = 1.0 / params.rvdw ** 6
        v = v - (c12 * rcinv6 * rcinv6 - c6 * rcinv6)
    elif params.vdw_modifier == VdwModifier.FORCE_SWITCH:
        # V_p = r^-p - (p c2/3) rs^3 - (p c3/4) rs^4 + cpot, rs = max(r-rsw,0)
        c2d, c3d, cp6 = forceswitch_constants(6.0, params.rvdw_switch,
                                              params.rvdw)
        c2r, c3r, cp12 = forceswitch_constants(12.0, params.rvdw_switch,
                                               params.rvdw)
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-12))
        rs = torch.clamp(r - params.rvdw_switch, min=0.0)
        rs3 = rs * rs * rs
        v = v + c12 * (-4.0 * c2r * rs3 - 3.0 * c3r * rs3 * rs + cp12) \
            - c6 * (-2.0 * c2d * rs3 - 1.5 * c3d * rs3 * rs + cp6)
    elif params.vdw_modifier == VdwModifier.POTENTIAL_SWITCH:
        # r from the floored r^2, as force-switch: sqrt(r2) at the dense
        # matrix's zero diagonal has an infinite derivative, and 0 * inf
        # made every force NaN (the JAX oracle's fault, not copied)
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-12))
        v = v * _potential_switch(r, params.rvdw_switch, params.rvdw)
    return v * incut


def _potential_switch(r, r1, rc):
    """GROMACS potential-switch polynomial (reference: forcerec.cpp
    swV3-5)."""
    t = torch.clamp((r - r1) / (rc - r1), 0.0, 1.0)
    sw = 1.0 + t ** 3 * (-10.0 + t * (15.0 - 6.0 * t))
    return torch.where(r < r1, torch.ones_like(sw), sw)


def dense_nonbonded_energy(x, box, charges, c6m, c12m, excl, pair_mask,
                           params: MdParams, beta: Optional[float] = None):
    """(e_coul, e_lj) over all pairs selected by pair_mask ((n, n) in
    {0, 1}, symmetric, 0 on the diagonal); each pair is counted once via
    the upper triangle.  c6m/c12m: per-pair (n, n) LJ parameters; excl:
    (n, n) exclusion mask."""
    n = x.shape[0]
    dx = pbc_mod.pbc_dx(x[:, None, :] - x[None, :, :], box)
    r2 = torch.sum(dx * dx, -1)
    # floor r^2 (the diagonal is exactly 0; masked lanes must stay finite
    # so that 0 * inf cannot leak through the masks, forward or backward)
    r2_safe = torch.clamp(r2, min=1e-6)
    rinv = torch.rsqrt(r2_safe)
    r = r2_safe * rinv
    sel = pair_mask * torch.triu(torch.ones((n, n), dtype=x.dtype,
                                            device=x.device), diagonal=1)
    in_coul = (r2 < params.rcoulomb ** 2).to(x.dtype)
    in_vdw = (r2 < params.rvdw ** 2).to(x.dtype)
    qq = ONE_4PI_EPS0 / params.epsilon_r * charges[:, None] * charges[None, :]
    e_coul = torch.sum(sel * _coulomb_pair_energy(qq, r, rinv, in_coul, excl,
                                                  params, beta))
    e_lj = torch.sum(sel * (1.0 - excl) * _lj_pair_energy(
        c6m, c12m, r2, rinv * rinv, in_vdw, params))
    return e_coul, e_lj


def pair_lj_params(system: System, type_idx: torch.Tensor):
    """Dense (n, n) c6/c12 from the type table for one end state."""
    tbl = system.nbfp
    return (tbl[type_idx[:, None], type_idx[None, :], 0],
            tbl[type_idx[:, None], type_idx[None, :], 1])
