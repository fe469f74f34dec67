"""Stochastic velocity rescaling and the isotropic barostats — PyTorch
counterpart of gromacs_fep_gpu_tpu/md/coupling.py (vrescale_lambda,
virial_pressure, berendsen_pscale, crescale_pscale).

The JAX functions draw their random numbers from a jax PRNG key inside.
Here the arithmetic takes the draws as arguments (`vrescale_scale`, the
C-rescale noise `xi`), so a test can feed both versions identical numbers;
the step draws them from an explicit torch.Generator on the state's
device.

C-rescale follows the reference (coupling.cpp crescale_pscale) where the
JAX function does not: its noise amplitude uses the reference temperature
ref_t, not the instantaneous one.
"""
from __future__ import annotations

import math

import torch

from ..core.units import BOLTZ, PRESFAC


def vrescale_scale(ekin, ekin_ref, ndf, dt_coupl, tau_t, r1, r2):
    """(scale, d_therm_integral) of the Bussi thermostat for given draws:
    r1 ~ N(0, 1) and r2 ~ chi^2 with ndf - 1 degrees of freedom."""
    c = math.exp(-dt_coupl / tau_t)
    ek_safe = torch.clamp(ekin, min=1e-10)
    ek_new = (ekin + (1.0 - c) * (ekin_ref * (r2 + r1 * r1) / ndf - ekin)
              + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * ekin_ref / ndf
                                      * ek_safe))
    ek_new = torch.clamp(ek_new, min=0.0)
    return torch.sqrt(ek_new / ek_safe), ekin - ek_new


def vrescale_draws(ndf: float, generator: torch.Generator, device):
    """(r1, r2) for vrescale_scale.  Above 100 degrees of freedom r2 uses
    the normal approximation N(ndf-1, 2(ndf-1)) of the JAX function;
    below it, an exact sum of ndf-1 squared normals."""
    r = torch.randn((2,), generator=generator, device=device)
    if ndf > 100:
        r2 = torch.clamp((ndf - 1.0) + math.sqrt(2.0 * (ndf - 1.0)) * r[1],
                         min=0.0)
    else:
        g = torch.randn((int(round(ndf)) - 1,), generator=generator,
                        device=device)
        r2 = torch.sum(g * g)
    return r[0], r2


def vrescale_lambda(ekin, ekin_ref, ndf, dt_coupl, tau_t,
                    generator: torch.Generator):
    """Draw (r1, r2) on the device and return (scale, d_therm_integral)."""
    r1, r2 = vrescale_draws(ndf, generator, ekin.device)
    return vrescale_scale(ekin, ekin_ref, ndf, dt_coupl, tau_t, r1, r2)


def virial_pressure(ekin_tensor, virial, volume):
    """(P, P tensor) = 2/V (Ekin - Xi) in bar, P = trace / 3 (reference:
    coupling.cpp calc_pres)."""
    p_tensor = 2.0 / volume * (ekin_tensor - virial) * PRESFAC
    return torch.diagonal(p_tensor, dim1=-2, dim2=-1).sum(-1) / 3.0, p_tensor


def berendsen_pscale(p_cur, ref_p, dt_coupl, tau_p, compressibility):
    """Isotropic Berendsen box and coordinate scale factor mu (reference:
    coupling.cpp berendsen_pcoupl: mu^3 = 1 - kappa dt/tau (P0 - P)),
    clipped to [0.98, 1.02] as in the JAX function."""
    mu = 1.0 - dt_coupl * compressibility / (3.0 * tau_p) * (ref_p - p_cur)
    return torch.clamp(torch.as_tensor(mu), 0.98, 1.02)


def crescale_pscale(p_cur, ref_p, dt_coupl, tau_p, compressibility,
                    volume, ref_t, xi):
    """Isotropic stochastic cell rescaling (Bernetti & Bussi 2020;
    reference: coupling.cpp crescale_pscale) for a given N(0, 1) draw xi:

        d ln V = -kappa dt/tau (P0 - P) + sqrt(2 kT kappa dt PRESFAC /
                 (V tau)) xi,   mu = exp(d ln V / 3),

    kT = BOLTZ ref_t (the reference temperature); clipped to [0.98, 1.02]
    as in the JAX function.  The caller scales x and the box by mu and the
    velocities by 1/mu."""
    kt = BOLTZ * ref_t
    dln_v = (compressibility * dt_coupl / tau_p * (p_cur - ref_p)
             + torch.sqrt(torch.as_tensor(
                 2.0 * kt * compressibility * dt_coupl * PRESFAC
                 / (volume * tau_p))) * xi)
    return torch.clamp(torch.exp(dln_v / 3.0), 0.98, 1.02)
