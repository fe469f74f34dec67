"""Stochastic velocity rescaling and the barostats — PyTorch counterpart
of gromacs_fep_gpu_tpu/md/coupling.py (vrescale_lambda, virial_pressure,
berendsen_pscale, crescale_pscale, parrinello_rahman_step) and of the
semiisotropic Berendsen branch of its md/simulator.py.

The JAX functions draw their random numbers from a jax PRNG key inside.
Here the arithmetic takes the draws as arguments (`vrescale_scale`, the
C-rescale noise `xi`), so a test can feed both versions identical numbers;
the step draws them from an explicit torch.Generator on the state's
device.

C-rescale follows the reference (coupling.cpp crescale_pscale) where the
JAX function does not: its noise amplitude uses the reference temperature
ref_t, not the instantaneous one.

Parrinello-Rahman follows the reference (coupling.cpp
parrinellorahman_pcoupl) where the JAX function does not: the inverse
barostat mass W^-1 = 4 pi^2 kappa / (3 tau_p^2 L_max) takes no PRESFAC
(kappa P is dimensionless in bar^-1 bar; the reference notes that the
pressure unit drops out), so the box oscillates with period tau_p; the JAX
function divides by PRESFAC, a 16.6 times heavier barostat whose period
is ~4 tau_p.  parrinello_rahman_step is the JAX function's diagonal
arithmetic without that PRESFAC; pr_boxv_step is the per-coupling-type
update the step runs (isotropic: equal relative box accelerations from
the whole pressure tensor; semiisotropic: x and y jointly, z on its own).
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


def berendsen_pscale_semiiso(p_diag, ref_p, ref_p_z, dt_coupl, tau_p,
                             compressibility, compressibility_z):
    """Semiisotropic Berendsen scale factors (mu_x, mu_y, mu_z): x and y
    jointly from (P_xx + P_yy) / 2 against ref_p and compressibility, z
    from P_zz against ref_p_z and compressibility_z (None: the xy values),
    each as berendsen_pscale (reference: coupling.cpp berendsen_pcoupl,
    epctSEMIISOTROPIC; the JAX step's semiisotropic branch)."""
    mu_xy = berendsen_pscale(0.5 * (p_diag[0] + p_diag[1]), ref_p,
                             dt_coupl, tau_p, compressibility)
    mu_z = berendsen_pscale(
        p_diag[2], ref_p if ref_p_z is None else ref_p_z, dt_coupl, tau_p,
        compressibility if compressibility_z is None else compressibility_z)
    return torch.stack([mu_xy, mu_xy, mu_z])


def parrinello_rahman_step(boxv, box, p_tensor, ref_p, dt, tau_p,
                           compressibility, volume):
    """Parrinello-Rahman box velocity update on a diagonal box, the JAX
    function's arithmetic (coupling.py parrinello_rahman_step) without its
    PRESFAC: boxv' = diag(boxv + dt V W^-1 / L_max (P - ref_p I)) with W^-1
    = 4 pi^2 kappa / (3 tau_p^2 L_max).  Equal to the JAX function called
    with compressibility * PRESFAC."""
    maxl = torch.max(torch.diagonal(box))
    winv = (4.0 * math.pi ** 2 * compressibility) / (3.0 * tau_p ** 2
                                                     * maxl)
    eye = torch.eye(3, dtype=box.dtype, device=box.device)
    boxv_new = boxv + dt * volume * winv / maxl * (p_tensor - ref_p * eye)
    return torch.diag(torch.diagonal(boxv_new))


def pr_boxv_step(boxv, box, p_diag, ref_p, ref_p_z, dt, tau_p,
                 compressibility, compressibility_z, volume,
                 pcoupltype: str):
    """The (3, 3) diagonal box velocity after one Parrinello-Rahman
    coupling step of length dt (reference: coupling.cpp
    parrinellorahman_pcoupl on a rectangular box).  With t_a = (P_aa -
    ref_aa) / b_a and W_a^-1 = 4 pi^2 kappa_a / (3 tau_p^2 L_max):
    - isotropic: every axis the same relative acceleration from the whole
      tensor, d boxv_a = dt W^-1 V b_a (sum_c t_c / b_c) / 3;
    - semiisotropic: x and y the same relative acceleration,
      d boxv_a = dt W_xy^-1 V b_a (t_x / b_x + t_y / b_y) / 2, and z its
      own, d boxv_z = dt W_z^-1 V t_z, with ref_p_z and compressibility_z
      (None: the xy values).
    On a cubic box the isotropic step is parrinello_rahman_step fed the
    scalar pressure times I."""
    b = torch.diagonal(box)
    maxl = torch.max(b)
    ref_z = ref_p if ref_p_z is None else ref_p_z
    t = torch.stack([p_diag[0] - ref_p, p_diag[1] - ref_p,
                     p_diag[2] - ref_z]) / b
    scale = (4.0 * math.pi ** 2) / (3.0 * tau_p ** 2 * maxl) * volume
    if pcoupltype == "isotropic":
        acc = scale * compressibility * b * torch.sum(t / b) / 3.0
    elif pcoupltype == "semiisotropic":
        kz = compressibility if compressibility_z is None \
            else compressibility_z
        arel = 0.5 * (t[0] / b[0] + t[1] / b[1])
        acc = torch.stack([scale * compressibility * arel * b[0],
                           scale * compressibility * arel * b[1],
                           scale * kz * t[2]])
    else:
        raise NotImplementedError(f"Parrinello-Rahman pcoupltype "
                                  f"{pcoupltype}")
    return torch.diag(torch.diagonal(boxv) + dt * acc)


def pr_box_scale(box, boxv, dt):
    """Per-axis scale of box and coordinates after a coupling step: the
    box moved by dt boxv, relative to the box, clipped to [0.99, 1.01] as
    in the JAX step."""
    b = torch.diagonal(box)
    return torch.clamp((b + dt * torch.diagonal(boxv)) / b, 0.99, 1.01)
