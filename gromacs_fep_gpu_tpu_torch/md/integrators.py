"""Leapfrog and leapfrog-Langevin updates and kinetic bookkeeping —
PyTorch counterpart of gromacs_fep_gpu_tpu/md/integrators.py (leapfrog,
langevin_sd, kinetic_energy, kinetic_energy_halfstep_avg, temperature,
remove_com_motion; reference: mdlib/update.cpp doSDUpdateGeneral and the
fork's GPU Langevin, langevin_gpu_internal.cu).

The JAX langevin_sd draws its noise from a jax PRNG key inside.  Here the
update takes the draws xi as an argument and sd_draws makes them from an
explicit torch.Generator on the state's device (the pattern of
md/coupling.py's vrescale_draws), so a test can feed both versions the
same numbers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.units import BOLTZ


def leapfrog(x, v, f, invmass, dt, scale_v: Optional[torch.Tensor] = None):
    """v(t+dt/2) = s v(t-dt/2) + f/m dt; x += v dt."""
    vnew = v if scale_v is None else v * scale_v
    vnew = vnew + f * invmass[:, None] * dt
    return x + vnew * dt, vnew


def langevin_sd(x, v, f, invmass, dt, tau_t, ref_t, xi):
    """Leapfrog Langevin, impulse form (Goga et al. JCTC 2012), for given
    N(0, 1) draws xi of v's shape:

        v'  = v + f/m dt
        v'' = a v' + sqrt((1 - a^2) kT/m) xi,   a = exp(-dt / tau_t)
        x'  = x + (v' + v'')/2 dt

    Massless atoms (invmass 0) get no noise."""
    a = math.exp(-dt / tau_t)
    v1 = v + f * invmass[:, None] * dt
    sd = torch.sqrt((1.0 - a * a) * BOLTZ * ref_t * invmass)[:, None]
    v2 = a * v1 + sd * xi
    return x + 0.5 * (v1 + v2) * dt, v2


def sd_draws(shape, generator: torch.Generator, dtype=torch.float32):
    """xi for langevin_sd: standard normals of `shape` drawn on the
    generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype)


def kinetic_energy(v, mass):
    return 0.5 * torch.sum(mass[:, None] * v * v)


def kinetic_energy_halfstep_avg(v_old, v_new, mass):
    return 0.5 * (kinetic_energy(v_old, mass) + kinetic_energy(v_new, mass))


def temperature(ekin, ndf):
    return 2.0 * ekin / (ndf * BOLTZ)


def remove_com_motion(v, mass):
    p = torch.sum(mass[:, None] * v, 0)
    return v - p / torch.sum(mass)
