"""Stochastic velocity rescaling — PyTorch counterpart of
gromacs_fep_gpu_tpu/md/coupling.py (vrescale_lambda).

The JAX function draws its two random numbers from a jax PRNG key inside.
Here the arithmetic (`vrescale_scale`) takes the draws as arguments, so a
test can feed both versions identical numbers; `vrescale_lambda` draws them
from an explicit torch.Generator on the state's device.
"""
from __future__ import annotations

import math

import torch


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
