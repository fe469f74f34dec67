"""The MD step — PyTorch counterpart of gromacs_fep_gpu_tpu/md/simulator.py
(StepLog, degrees_of_freedom, masses_at_lambda, make_step_fn) for the
leapfrog / v-rescale / SETTLE / COM-removal / dhdl / MTS branches.

The force flavour of each step is chosen by the caller (the runner knows
it on the host, as in the JAX runner's statically-flavoured segments):
'F' force only, 'E' energies and dV/dlambda, 'f' MTS off-step (force only,
PME reciprocal skipped).  State.step is a host integer, so every step % N
trigger is decided on the host without reading the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.types import (FepCoupling, IntegratorType, MdParams, State,
                          System, TcouplType)
from ..core.units import BOLTZ
from . import constraints as constr_mod
from . import coupling as coupling_mod
from . import integrators as integ_mod


@dataclasses.dataclass
class StepLog:
    epot: torch.Tensor          # NaN on force-only steps
    ekin: torch.Tensor
    temp: torch.Tensor
    lam: torch.Tensor           # (7,)
    dvdl: torch.Tensor          # (7,), NaN on force-only steps
    constr_rmsd: torch.Tensor


def degrees_of_freedom(system: System, params: MdParams) -> float:
    ndf = 3 * system.n_atoms - constr_mod.n_constraints(system)
    if params.nstcomm > 0:
        ndf -= 3
    return float(ndf)


def masses_at_lambda(system: System, lam_mass):
    m = (1.0 - lam_mass) * system.mass_a + lam_mass * system.mass_b
    invm = torch.where(m > 0, 1.0 / torch.where(m > 0, m,
                                                torch.ones_like(m)),
                       torch.zeros_like(m))
    return m, invm


def make_step_fn(system: System, params: MdParams, force_fn: Callable,
                 generator: Optional[torch.Generator] = None):
    """step(state, flavor) -> (state, StepLog).

    force_fn(x, box, lam, flavor) -> (f, EnergyTerms); generator drives
    the v-rescale draws."""
    if params.integrator != IntegratorType.MD:
        raise NotImplementedError(f"integrator {params.integrator.value} is "
                                  "not ported yet (leapfrog only)")
    if params.tcoupl not in (TcouplType.NO, TcouplType.V_RESCALE):
        raise NotImplementedError(f"tcoupl {params.tcoupl.value} is not "
                                  "ported yet")
    if params.pcoupl.value != "no":
        raise NotImplementedError("pressure coupling is not ported yet")
    if params.fep.delta_lambda != 0.0:
        raise NotImplementedError("slow growth is not ported yet")
    if params.tcoupl == TcouplType.V_RESCALE and generator is None:
        raise ValueError("v-rescale needs a torch.Generator")
    ndf = degrees_of_freedom(system, params)
    dt = params.dt
    has_settle = constr_mod.n_constraints(system) > 0

    def step(state: State, flavor: str):
        lam = state.lam
        mass, invmass = masses_at_lambda(system, lam[FepCoupling.MASS])
        f, terms = force_fn(state.x, state.box, lam, flavor)
        do_ener = flavor == "E"

        v_scale = None
        coupl = state.coupling
        ekinh_cur = integ_mod.kinetic_energy(state.v, mass)
        if params.tcoupl == TcouplType.V_RESCALE:
            if state.step % params.nsttcouple == 0:
                ekinh_old = torch.where(coupl.ekinh_prev < 0, ekinh_cur,
                                        coupl.ekinh_prev)
                ekin_half = 0.5 * (ekinh_old + ekinh_cur)
                ekin_ref = 0.5 * ndf * BOLTZ * params.ref_t
                v_scale, d_int = coupling_mod.vrescale_lambda(
                    ekin_half, ekin_ref, ndf, params.nsttcouple * dt,
                    params.tau_t, generator)
                coupl = dataclasses.replace(
                    coupl, therm_integral=coupl.therm_integral + d_int)
        coupl = dataclasses.replace(coupl, ekinh_prev=ekinh_cur)

        x_new, v_new = integ_mod.leapfrog(state.x, state.v, f, invmass, dt,
                                          v_scale)
        constr_rmsd = torch.zeros((), dtype=x_new.dtype, device=x_new.device)
        if has_settle:
            x_c = constr_mod.settle_positions(state.x, x_new, state.box,
                                              system.settle, invmass)
            v_new = v_new + (x_c - x_new) / dt
            if flavor != "F":
                constr_rmsd = torch.sqrt(torch.mean(torch.sum(
                    (x_c - x_new) ** 2, -1)))
            x_new = x_c

        ekin = integ_mod.kinetic_energy_halfstep_avg(state.v, v_new, mass)
        temp = integ_mod.temperature(ekin, ndf)
        if params.nstcomm > 0 and state.step % params.nstcomm == 0:
            v_new = integ_mod.remove_com_motion(v_new, mass)

        nan = torch.full((), float("nan"), dtype=x_new.dtype,
                         device=x_new.device)
        log = StepLog(epot=terms.epot if do_ener else nan, ekin=ekin,
                      temp=temp, lam=lam, dvdl=terms.dvdl,
                      constr_rmsd=constr_rmsd)
        return state.replace(x=x_new, v=v_new, coupling=coupl,
                             step=state.step + 1), log

    return step


def stack_logs(logs) -> StepLog:
    """Stack per-step logs along a leading step axis."""
    return StepLog(**{k.name: torch.stack([getattr(lg, k.name)
                                           for lg in logs])
                      for k in dataclasses.fields(StepLog)})
