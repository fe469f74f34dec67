"""Foreign-lambda energy differences for BAR/MBAR — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/foreign.py (make_lambda_energy_fn,
make_foreign_delta_fn).

The fork computes these with a dedicated energy-only CUDA kernel looping
over all lambdas (nbnxm_foreign_fep_cuda_kernel.cuh) and re-evaluates the
bonded and PME terms per lambda on the CPU.  Here the only lambda-dependent
energy terms are the FEP pair list, the perturbed bonded terms, the 1-4
pairs and the PME charge mix, all cheap next to the main kernel.  Where the
JAX side sweeps with jax.vmap over the (L, 7) lambda matrix, the port
carries an explicit leading lambda axis through the same energy functions:
one pass of (L, pairs) tensors instead of L passes, since the eager step is
bound by its number of launches.  The reciprocal term is exactly linear in
lambda_coul (ops/pme.py _recip_slope_fn), so one spread, solve and gather
serve the whole ladder.  So is the dispersion correction's energy, linear
in lambda_vdw: one expression over the (L,) lambda_vdw column.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.types import FepCoupling, MdParams, System
from . import bonded as bonded_mod
from .cluster_nb import fep_pair_energy
from .dispcorr import make_dispersion_correction
from .forces import get_beta, pairs14_energy
from .pairlist import FepPairlist


def make_lambda_energy_fn(system: System, params: MdParams,
                          pme_slope_fn: Optional[Callable] = None):
    """e_lambda(x, box, lam, feplist): only the lambda-DEPENDENT part of the
    potential, up to a lambda-independent constant.  lam is (7,) or (L, 7)
    and the result () or (L,).  Differences across lambdas equal
    full-potential differences because everything else cancels.

    pme_slope_fn(x, box) -> d E_recip / d lambda_coul (make_pme_recip_fns);
    the JAX function takes recip_fn and evaluates it once per lambda."""
    beta = get_beta(params)
    disp_e_fn = (make_dispersion_correction(system, params)[0]
                 if params.dispcorr else None)

    def e_lambda(x, box, lam, feplist: Optional[FepPairlist]):
        lam_c, lam_v = lam[..., FepCoupling.COUL], lam[..., FepCoupling.VDW]
        lam_b = lam[..., FepCoupling.BONDED]
        e = torch.zeros(lam.shape[:-1], dtype=x.dtype, device=x.device)
        if feplist is not None:
            e_c, e_v = fep_pair_energy(x, box, lam_c, lam_v, feplist,
                                       system, params, beta)
            e = e + e_c + e_v
        for name, il in system.bonded.items():
            if il.n > 0:
                e = e + bonded_mod.TERMS[name](x, box, il, lam_b)
        if system.pairs14 is not None and system.pairs14.n > 0:
            e14c, e14l = pairs14_energy(x, box, system, lam_c, lam_v, params)
            e = e + e14c + e14l
        if pme_slope_fn is not None:
            e = e + lam_c * pme_slope_fn(x, box)
        if disp_e_fn is not None:
            e = e + disp_e_fn(box, lam_v)[0]
        return e

    return e_lambda


def make_foreign_delta_fn(system: System, params: MdParams, all_lambda,
                          pme_slope_fn: Optional[Callable] = None):
    """delta_fn(x, box, lam_cur, feplist) -> (L,) with
    Delta U_l = U(lambda_l) - U(lambda_cur)  (ForeignLambdaTerms analogue,
    reference: mdtypes/enerdata.h:80).  all_lambda: (L, 7).  The current
    lambda rides as row L of the same pass, so the entry of the own window
    is exactly zero.  No gradient is taken."""
    e_lambda = make_lambda_energy_fn(system, params, pme_slope_fn)
    all_lambda = torch.as_tensor(all_lambda, device=system.device)

    def delta_fn(x, box, lam_cur, feplist):
        with torch.no_grad():
            lams = torch.cat([all_lambda.to(x.dtype),
                              lam_cur.to(x.dtype)[None]])
            e = e_lambda(x, box, lams, feplist)
            return e[:-1] - e[-1]

    return delta_fn
