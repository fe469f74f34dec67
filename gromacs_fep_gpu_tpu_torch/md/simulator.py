"""The MD step — PyTorch counterpart of gromacs_fep_gpu_tpu/md/simulator.py
(StepLog, degrees_of_freedom, masses_at_lambda, make_pressure_fn,
make_step_fn) for the leapfrog / leapfrog-Langevin (sd) / v-rescale /
constraint (SETTLE + LINCS, with the perturbed lengths' dV/dlambda and
Delta H term) / COM-removal / dhdl / foreign-lambda / MTS branches and
isotropic Berendsen and C-rescale pressure coupling.

The force flavour of each step is chosen by the caller (the runner knows
it on the host, as in the JAX runner's statically-flavoured segments):
'F' force only, 'E' energies and dV/dlambda, 'D' energies plus the
foreign-lambda sweep, 'f' MTS off-step (force only, PME reciprocal
skipped), 'R' energies and the virial (pressure steps), 'S' 'R' plus the
sweep.  State.step is a host integer, so every step % N trigger is decided
on the host without reading the device.

The sd integrator is its own thermostat: the step raises on sd with a
tcoupl, where the JAX step applies both (v-rescale's scale, then SD's
friction and noise); grompp sets tcoupl = no under sd
(readir.cpp), and so does the port's mdp reader.  The constraints act
once, after the whole SD update, as in the JAX step (GROMACS constrains
after the force update and again after the friction and noise).

Pressure coupling differs from the JAX step where the JAX step differs
from the reference: C-rescale scales the velocities by 1/mu
(coupling.cpp crescale_pscale) and draws its noise at kT = BOLTZ ref_t,
and the dispersion tail pressure is taken at the current lambda_vdw.  The
pressure's kinetic term is 1/2 m v(t+dt/2)^2 after COM removal, as in the
JAX step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import pbc as pbc_mod
from ..core.types import (_ENERGY_FIELDS, FepCoupling, IntegratorType,
                          MdParams, PcouplType, State, System, TcouplType)
from ..core.units import BOLTZ
from ..ops.dispcorr import make_dispersion_correction
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
    # (L,) foreign-lambda U(l) - U(cur), NaN off dhdl steps; (0,) without
    # a ladder
    delta_h: torch.Tensor
    # scalar pressure in bar on the pressure-coupling steps, NaN on the
    # others; 0 without pressure coupling
    pres: torch.Tensor
    # (12,) energy decomposition in EnergyTerms field order (lj, coulomb,
    # lj_recip, ..., dispcorr), NaN on force-only steps
    terms: torch.Tensor


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


def diag_pressure(vir, v, mass, box, lam, p_extra_fn=None):
    """(P, P_diag) in bar from the diagonal virial Xi_aa: P_aa = 2/V (K_aa
    - Xi_aa) PRESFAC with K_aa = 1/2 sum m v_a^2 (virial_pressure), plus
    p_extra_fn(box, lam_vdw), the dispersion tail."""
    ekin_diag = 0.5 * torch.sum(mass[:, None] * v * v, 0)
    _, p_tensor = coupling_mod.virial_pressure(
        torch.diag(ekin_diag), torch.diag(vir), pbc_mod.box_volume(box))
    p_diag = torch.diagonal(p_tensor)
    if p_extra_fn is not None:
        p_diag = p_diag + p_extra_fn(box, lam[FepCoupling.VDW])
    return torch.mean(p_diag), p_diag


def make_pressure_fn(energy_epot_fn: Callable,
                     p_extra_fn: Optional[Callable] = None):
    """Diagonal pressure from the strain gradient of the whole potential:
    scale x and box by (1 + eps) along each axis; Xi_aa = 1/2 dU/d eps_a,
    P_aa = 2/V (K_aa - Xi_aa) PRESFAC (+ p_extra_fn(box, lam_vdw), the
    dispersion tail) (JAX make_pressure_fn; reference semantics:
    coupling.cpp calc_pres).  The oracle of the cluster route's in-force
    virial: energy_epot_fn must leave out the dispersion correction, whose
    pressure is p_extra_fn's.

    pressure(x, box, lam, v, mass, extra_virial_diag=None) -> (P, P_diag,
    Xi_diag)."""

    def pressure(x, box, lam, v, mass, extra_virial_diag=None):
        eps = torch.zeros(3, dtype=x.dtype, device=x.device,
                          requires_grad=True)
        with torch.enable_grad():
            s = 1.0 + eps
            e = energy_epot_fn(x.detach() * s, box * s[None, :], lam)
            (dude,) = torch.autograd.grad(e, eps)
        vir = 0.5 * dude
        if extra_virial_diag is not None:
            vir = vir + extra_virial_diag
        return (*diag_pressure(vir, v, mass, box, lam, p_extra_fn), vir)

    return pressure


def make_step_fn(system: System, params: MdParams, force_fn: Callable,
                 generator: Optional[torch.Generator] = None,
                 foreign_delta_fn: Optional[Callable] = None,
                 n_foreign: int = 0,
                 energy_epot_fn: Optional[Callable] = None,
                 all_lambda: Optional[torch.Tensor] = None):
    """step(state, flavor) -> (state, StepLog).

    force_fn(x, box, lam, flavor) -> (f, EnergyTerms); generator drives
    the v-rescale, SD and C-rescale draws.  foreign_delta_fn(x, box, lam) ->
    (n_foreign,) Delta H vector, evaluated on 'D' and 'S' steps at x(t),
    before the update, so that it is frame-consistent with the energies of
    the same step (reference: md.cpp:1323).

    With pressure coupling the pressure of a step % nstpcouple == 0 comes
    from the force pass's terms.vir_diag (flavours 'R' / 'S'), or, when
    energy_epot_fn(x, box, lam) is given (the dense oracle route), from
    make_pressure_fn's strain gradient of it at x(t); plus the constraint
    virial and the dispersion tail.  Box and x are then scaled by mu
    (and, with C-rescale, v by 1/mu).  The JAX dense route takes that
    gradient at x(t+dt) on every step; here both routes read the virial
    of x(t) on the pressure steps only.

    Constraint lengths with a B state (LINCS rows with lenB != lenA, under
    free-energy = yes) add their multipliers' dH/dlambda to dV/dlambda's
    bonded column on energy steps, and on the sweep's steps the linear
    term (all_lambda[:, BONDED] - lambda_bonded) * dvdl_constr to each
    Delta H (reference: lincs.cpp:1257, enerdata_utils.cpp:338-347; JAX
    simulator.py:852-861).  all_lambda: the (L, 7) ladder of the sweep.
    Whether a length is perturbed is read from the system here (a host
    read of the LINCS lengths, once per call)."""
    is_sd = params.integrator == IntegratorType.SD
    if params.integrator not in (IntegratorType.MD, IntegratorType.SD):
        raise NotImplementedError(f"integrator {params.integrator.value} is "
                                  "not ported yet (md, sd)")
    if is_sd and params.tcoupl != TcouplType.NO:
        raise ValueError(f"integrator sd with tcoupl {params.tcoupl.value}: "
                         "sd is the thermostat (grompp sets tcoupl = no)")
    if is_sd and generator is None:
        raise ValueError("sd needs a torch.Generator")
    if params.tcoupl not in (TcouplType.NO, TcouplType.V_RESCALE):
        raise NotImplementedError(f"tcoupl {params.tcoupl.value} is not "
                                  "ported yet")
    if params.pcoupl in (PcouplType.PARRINELLO_RAHMAN, PcouplType.MTTK):
        raise NotImplementedError(f"pcoupl {params.pcoupl.value} is not "
                                  "ported yet (Berendsen, C-rescale)")
    has_pcoupl = params.pcoupl != PcouplType.NO
    if has_pcoupl and params.pcoupltype != "isotropic":
        raise NotImplementedError(f"pcoupltype {params.pcoupltype} is not "
                                  "ported yet (isotropic only)")
    if params.pcoupl == PcouplType.C_RESCALE and generator is None:
        raise ValueError("c-rescale needs a torch.Generator")
    if params.fep.delta_lambda != 0.0:
        raise NotImplementedError("slow growth is not ported yet")
    if params.tcoupl == TcouplType.V_RESCALE and generator is None:
        raise ValueError("v-rescale needs a torch.Generator")
    ndf = degrees_of_freedom(system, params)
    dt = params.dt
    has_constraints = constr_mod.n_constraints(system) > 0
    has_pert_constr = (params.fep.enabled
                       and constr_mod.has_perturbed_lengths(system))
    if has_pert_constr and n_foreign > 0 and all_lambda is None:
        raise ValueError("perturbed constraint lengths with a Delta H "
                         "sweep need all_lambda for its constraint term")
    dlam_bonded = (None if all_lambda is None else
                   torch.as_tensor(all_lambda, device=system.device)[
                       :, int(FepCoupling.BONDED)])
    nan_terms = torch.full((len(_ENERGY_FIELDS),), float("nan"),
                           device=system.device)
    p_tail_fn = (make_dispersion_correction(system, params)[1]
                 if has_pcoupl and params.dispcorr else None)
    pressure_fn = (make_pressure_fn(energy_epot_fn, p_tail_fn)
                   if has_pcoupl and energy_epot_fn is not None else None)

    def step(state: State, flavor: str):
        lam = state.lam
        mass, invmass = masses_at_lambda(system, lam[FepCoupling.MASS])
        f, terms = force_fn(state.x, state.box, lam, flavor)
        do_ener = flavor in ("E", "D", "R", "S")
        do_p = has_pcoupl and state.step % params.nstpcouple == 0
        if do_p and pressure_fn is None and flavor not in ("R", "S"):
            raise ValueError(f"step {state.step}: a pressure step needs "
                             f"the virial flavour, got {flavor!r}")

        delta_h = torch.zeros((0,), dtype=state.x.dtype,
                              device=state.x.device)
        if foreign_delta_fn is not None and n_foreign > 0:
            if flavor in ("D", "S"):
                delta_h = foreign_delta_fn(state.x, state.box, lam)
            else:
                delta_h = torch.full((n_foreign,), float("nan"),
                                     dtype=state.x.dtype,
                                     device=state.x.device)

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

        if is_sd:
            x_new, v_new = integ_mod.langevin_sd(
                state.x, state.v, f, invmass, dt, params.tau_t, params.ref_t,
                integ_mod.sd_draws(state.v.shape, generator, state.v.dtype))
        else:
            x_new, v_new = integ_mod.leapfrog(state.x, state.v, f, invmass,
                                              dt, v_scale)
        constr_rmsd = torch.zeros((), dtype=x_new.dtype, device=x_new.device)
        constr_vir = None
        dvdl = terms.dvdl
        if has_constraints:
            lam_b = lam[FepCoupling.BONDED]
            if has_pert_constr and do_ener:
                x_c, dhdl_dt2 = constr_mod.constrain(
                    state.x, x_new, state.box, system, invmass, lam_b,
                    params.lincs_order, params.lincs_iter, with_dhdl=True)
                dvdl_constr = dhdl_dt2 / (dt * dt)
                dvdl = dvdl.clone()
                dvdl[FepCoupling.BONDED] += dvdl_constr
                if flavor in ("D", "S") and n_foreign > 0:
                    # constraints cannot be evaluated at foreign lambdas:
                    # the linear term, as the reference
                    delta_h = delta_h + (dlam_bonded - lam_b) * dvdl_constr
            else:
                x_c = constr_mod.constrain(
                    state.x, x_new, state.box, system, invmass, lam_b,
                    params.lincs_order, params.lincs_iter)
            v_new = v_new + (x_c - x_new) / dt
            if flavor != "F":
                constr_rmsd = torch.sqrt(torch.mean(torch.sum(
                    (x_c - x_new) ** 2, -1)))
            if do_p:
                # constraint force m dx / dt^2; Xi_aa = -1/2 sum x_a f_c,a
                f_c = mass[:, None] * (x_c - x_new) / (dt * dt)
                constr_vir = -0.5 * torch.sum(x_c * f_c, 0)
            x_new = x_c

        ekin = integ_mod.kinetic_energy_halfstep_avg(state.v, v_new, mass)
        temp = integ_mod.temperature(ekin, ndf)
        if params.nstcomm > 0 and state.step % params.nstcomm == 0:
            v_new = integ_mod.remove_com_motion(v_new, mass)

        nan = torch.full((), float("nan"), dtype=x_new.dtype,
                         device=x_new.device)
        pres = nan if has_pcoupl else torch.zeros_like(nan)
        box_new = state.box
        if do_p:
            vol = pbc_mod.box_volume(state.box)
            if pressure_fn is not None:
                pres = pressure_fn(state.x, state.box, lam, v_new, mass,
                                   constr_vir)[0]
            else:
                vir = terms.vir_diag
                if constr_vir is not None:
                    vir = vir + constr_vir
                pres = diag_pressure(vir, v_new, mass, state.box, lam,
                                     p_tail_fn)[0]
            dt_p = params.nstpcouple * dt
            if params.pcoupl == PcouplType.BERENDSEN:
                mu = coupling_mod.berendsen_pscale(
                    pres, params.ref_p, dt_p, params.tau_p,
                    params.compressibility)
            else:
                xi = torch.randn((), generator=generator, device=vol.device,
                                 dtype=vol.dtype)
                mu = coupling_mod.crescale_pscale(
                    pres, params.ref_p, dt_p, params.tau_p,
                    params.compressibility, vol, params.ref_t, xi)
                v_new = v_new / mu
            box_new = state.box * mu
            x_new = x_new * mu
        log = StepLog(epot=terms.epot if do_ener else nan, ekin=ekin,
                      temp=temp, lam=lam, dvdl=dvdl,
                      constr_rmsd=constr_rmsd, delta_h=delta_h, pres=pres,
                      terms=(torch.stack([getattr(terms, k)
                                          for k in _ENERGY_FIELDS])
                             if do_ener else nan_terms))
        return state.replace(x=x_new, v=v_new, box=box_new, coupling=coupl,
                             step=state.step + 1), log

    return step


def stack_logs(logs) -> StepLog:
    """Stack per-step logs along a leading step axis."""
    return StepLog(**{k.name: torch.stack([getattr(lg, k.name)
                                           for lg in logs])
                      for k in dataclasses.fields(StepLog)})
