"""Energy minimizers — PyTorch counterpart of
gromacs_fep_gpu_tpu/md/minimize.py (MinimizeResult, steepest_descent,
conjugate_gradient, l_bfgs; reference: src/gromacs/mdrun/minimize.cpp
do_steep, do_cg, do_lbfgs).

The JAX functions are lax.while_loop programs; here the loop runs on the
host and every value stays on the run's device: a trial step is accepted
or rejected with torch.where, and the host reads one boolean per iteration,
the loop's stop test (l_bfgs also one per line-search trial, whose count
depends on the energies).  The arithmetic is JAX's, step for step, so the
same force function gives the same accept/reject sequence:
- Fmax is the largest force component, as in JAX (GROMACS, as far as its
  code is remembered, takes the largest per-atom force norm);
- steep grows an accepted step by 1.2 and shrinks a rejected one by 0.2
  (GROMACS's do_steep, as remembered, by 0.5), and stops when the step
  falls below 1e-9 nm;
- cg is Polak-Ribiere with a step that grows 1.3x on acceptance and
  shrinks 0.3x with a restart along the force on rejection;
- l_bfgs keeps an (m, 3N) circular history and backtracks from a first
  trial capped at step0 nm (Armijo, c1 = 1e-4, at most 12 halvings) where
  GROMACS minimizes along the line.

force_fn(x, box, lam) -> (f, terms) with terms.epot; constrain_fn(x_ref,
x_try) -> constrained positions, applied to every trial step as the
reference's do_em_step applies constr->apply (minimize.cpp:431);
valid_fn(x) -> a boolean tensor, whether the constrained trial holds its
constraints.  A trial that does not is rejected with the energy +inf, as
do_steep treats a step whose constraints failed (JAX has no such test and
accepts a trial whose water SETTLE broke if its energy is lower); its
force is taken at the current x instead, so that the pair list never sees
the broken positions, and no host read is added.
normal_modes needs a double backward through the hand kernels and is not
ported (ROADMAP slice 16).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch


class MinimizeResult(NamedTuple):
    x: torch.Tensor
    epot: torch.Tensor
    fmax: torch.Tensor
    n_steps: int
    converged: bool
    # (n_steps + 1,) Epot of the current structure after each iteration
    # (the first entry: the start) and (n_steps,) whether each iteration's
    # trial was accepted, both on the device
    epot_trace: torch.Tensor
    accepted: torch.Tensor


def _identity(x_ref, x_try):
    return x_try


def _trial(force_fn, cons, valid_fn, x, x_try, box, lam):
    """(constrained trial, its force, its energy) from x: the energy +inf
    and the force at x where valid_fn rejects the constrained trial."""
    x_try = cons(x, x_try)
    if valid_fn is None:
        f, terms = force_fn(x_try, box, lam)
        return x_try, f, terms.epot
    ok = valid_fn(x_try)
    f, terms = force_fn(torch.where(ok, x_try, x), box, lam)
    return x_try, f, torch.where(ok, terms.epot,
                                 torch.full_like(terms.epot, float("inf")))


def _result(x, e, f, k, emtol, trace: List, acc: List) -> MinimizeResult:
    fmax = f.abs().max()
    accepted = (torch.stack(acc) if acc else
                torch.zeros((0,), dtype=torch.bool, device=x.device))
    return MinimizeResult(x=x, epot=e, fmax=fmax, n_steps=k,
                          converged=bool(fmax <= emtol),
                          epot_trace=torch.stack(trace), accepted=accepted)


def steepest_descent(x0, box, lam, force_fn: Callable, nsteps: int = 200,
                     emtol: float = 10.0, step0: float = 0.01,
                     constrain_fn: Optional[Callable] = None,
                     valid_fn: Optional[Callable] = None
                     ) -> MinimizeResult:
    """Accept a trial step x + step f / Fmax if the energy decreased (the
    step grows 1.2x), else keep x (the step shrinks 0.2x)."""
    cons = constrain_fn or _identity
    x = cons(x0, x0)
    f, terms = force_fn(x, box, lam)
    e = terms.epot
    step = torch.tensor(step0, dtype=x.dtype, device=x.device)
    trace, acc, k = [e], [], 0
    while k < nsteps:
        fmax = f.abs().max()
        if not bool((fmax > emtol) & (step > 1e-9)):
            break
        x_try, f_try, e_try = _trial(
            force_fn, cons, valid_fn, x,
            x + f * (step / torch.clamp(fmax, min=1e-12)), box, lam)
        ok = e_try < e
        x = torch.where(ok, x_try, x)
        e = torch.where(ok, e_try, e)
        f = torch.where(ok, f_try, f)
        step = torch.where(ok, step * 1.2, step * 0.2)
        trace.append(e)
        acc.append(ok)
        k += 1
    return _result(x, e, f, k, emtol, trace, acc)


def conjugate_gradient(x0, box, lam, force_fn: Callable, nsteps: int = 200,
                       emtol: float = 10.0, step0: float = 0.005,
                       constrain_fn: Optional[Callable] = None,
                       valid_fn: Optional[Callable] = None
                       ) -> MinimizeResult:
    """Polak-Ribiere conjugate gradient with a growing/shrinking trial
    step along the direction scaled to a largest component of 1."""
    cons = constrain_fn or _identity
    x = cons(x0, x0)
    f, terms = force_fn(x, box, lam)
    e, d = terms.epot, f
    step = torch.tensor(step0, dtype=x.dtype, device=x.device)
    trace, acc, k = [e], [], 0
    while k < nsteps:
        if not bool(f.abs().max() > emtol):
            break
        dn = d / torch.clamp(d.abs().max(), min=1e-12)
        x_try, f_try, e_try = _trial(force_fn, cons, valid_fn, x,
                                     x + dn * step, box, lam)
        ok = e_try < e
        beta = torch.where(
            ok, torch.clamp(torch.sum(f_try * (f_try - f))
                            / torch.clamp(torch.sum(f * f), min=1e-20),
                            min=0.0),
            torch.zeros((), dtype=x.dtype, device=x.device))
        d = torch.where(ok, f_try + beta * d, f)
        x = torch.where(ok, x_try, x)
        e = torch.where(ok, e_try, e)
        f = torch.where(ok, f_try, f)
        step = torch.where(ok, step * 1.3, step * 0.3)
        trace.append(e)
        acc.append(ok)
        k += 1
    return _result(x, e, f, k, emtol, trace, acc)


def _two_loop(g, S, Y, rho, k: int, m: int):
    """H g by the two-loop recursion over the min(k, m) newest pairs (slot
    j holds the pair of iteration j modulo m); a pair with rho = 0 (s.y <=
    1e-30) is skipped."""
    n = min(k, m)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    alphas = [zero] * m
    q = g
    for i in range(n):
        j = (k - 1 - i) % m
        a = torch.where(rho[j] > 0, rho[j] * torch.dot(S[j], q), zero)
        q = q - a * Y[j]
        alphas[j] = a
    jn = (k - 1) % m
    yy = torch.dot(Y[jn], Y[jn])
    gamma = torch.where((yy > 0) & (k > 0),
                        torch.dot(S[jn], Y[jn]) / torch.clamp(yy, min=1e-30),
                        torch.ones_like(yy))
    r = q * gamma
    for i in range(n):
        j = (k - n + i) % m
        b = torch.where(rho[j] > 0, rho[j] * torch.dot(Y[j], r), zero)
        r = r + (alphas[j] - b) * S[j]
    return r


def l_bfgs(x0, box, lam, force_fn: Callable, nsteps: int = 200,
           emtol: float = 10.0, m: int = 10, step0: float = 0.01,
           constrain_fn: Optional[Callable] = None,
           valid_fn: Optional[Callable] = None) -> MinimizeResult:
    """Limited-memory BFGS with an m-pair history and a backtracking
    Armijo line search; stops when a line search finds no lower energy."""
    shape = x0.shape
    cons = constrain_fn or _identity

    def epot_g(xr, xt):
        """(energy, gradient) of the trial xt (flat) from xr (flat)."""
        _, f, e_t = _trial(force_fn, cons, valid_fn, xr.reshape(shape),
                           xt.reshape(shape), box, lam)
        return e_t, -f.reshape(-1)

    xf = cons(x0, x0).reshape(-1)
    f0, terms = force_fn(xf.reshape(shape), box, lam)
    e, g = terms.epot, -f0.reshape(-1)
    S = torch.zeros((m, xf.numel()), dtype=xf.dtype, device=xf.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,), dtype=xf.dtype, device=xf.device)
    trace, acc, k = [e], [], 0
    stalled = torch.zeros((), dtype=torch.bool, device=xf.device)
    while k < nsteps:
        if not bool((g.abs().max() > emtol) & ~stalled):
            break
        d = -_two_loop(g, S, Y, rho, k, m)
        d = torch.where(torch.dot(d, g) < 0, d, -g)
        t0 = torch.clamp(step0 / torch.clamp(d.abs().max(), min=1e-12),
                         max=1.0)
        gd = torch.dot(g, d)
        e_t, g_t = epot_g(xf, xf + t0 * d)
        t, tries = t0 * 0.5, 0
        # Armijo on the previous trial (at 2 t); at most 12 halvings
        while tries < 12 and bool(e_t > e + 1e-4 * (2.0 * t) * gd):
            e_t, g_t = epot_g(xf, xf + t * d)
            t, tries = t * 0.5, tries + 1
        t = t * 2.0
        ok = e_t < e
        x_new = torch.where(
            ok, cons(xf.reshape(shape), (xf + t * d).reshape(shape)
                     ).reshape(-1), xf)
        s_vec, y_vec = x_new - xf, g_t - g
        sy = torch.dot(s_vec, y_vec)
        j = k % m
        S[j] = torch.where(ok, s_vec, S[j])
        Y[j] = torch.where(ok, y_vec, Y[j])
        rho[j] = torch.where(
            ok, torch.where(sy > 1e-30, 1.0 / torch.clamp(sy, min=1e-30),
                            torch.zeros_like(sy)), rho[j])
        xf = x_new
        e = torch.where(ok, e_t, e)
        g = torch.where(ok, g_t, g)
        trace.append(e)
        acc.append(ok)
        stalled = ~ok
        k += 1
    return _result(xf.reshape(shape), e, -g, k, emtol, trace, acc)
