"""Leapfrog update and kinetic bookkeeping — PyTorch counterpart of
gromacs_fep_gpu_tpu/md/integrators.py (leapfrog, kinetic_energy,
kinetic_energy_halfstep_avg, temperature, remove_com_motion)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.units import BOLTZ


def leapfrog(x, v, f, invmass, dt, scale_v: Optional[torch.Tensor] = None):
    """v(t+dt/2) = s v(t-dt/2) + f/m dt; x += v dt."""
    vnew = v if scale_v is None else v * scale_v
    vnew = vnew + f * invmass[:, None] * dt
    return x + vnew * dt, vnew


def kinetic_energy(v, mass):
    return 0.5 * torch.sum(mass[:, None] * v * v)


def kinetic_energy_halfstep_avg(v_old, v_new, mass):
    return 0.5 * (kinetic_energy(v_old, mass) + kinetic_energy(v_new, mass))


def temperature(ekin, ndf):
    return 2.0 * ekin / (ndf * BOLTZ)


def remove_com_motion(v, mass):
    p = torch.sum(mass[:, None] * v, 0)
    return v - p / torch.sum(mass)
