"""The port's energy minimizers (gromacs_fep_gpu_tpu_torch/md/minimize.py)
against the JAX package's (gromacs_fep_gpu_tpu/md/minimize.py) in float64
on the same numpy-seeded force: twelve Lennard-Jones particles, each tied
to its lattice site by a harmonic spring, started off the lattice, and
(steep with SETTLE) four rigid waters in a Lennard-Jones field of their
oxygens.  Each side records the energy of every force call, so equal
sequences (rel 1e-6) mean the same trial steps, the same accept/reject
sequence and the same line searches; the final x and Epot agree to rel
1e-6 and n_steps and converged are equal.  jax_enable_x64 is set and
restored inside each test.  None of this goes through a CLI."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core.types import SettleGroups as JSettle
from gromacs_fep_gpu_tpu.md import minimize as jmin
from gromacs_fep_gpu_tpu.md.constraints import settle_positions as jsettle
from gromacs_fep_gpu_tpu_torch.core.types import LincsConstraints as TLincs
from gromacs_fep_gpu_tpu_torch.core.types import SettleGroups as TSettle
from gromacs_fep_gpu_tpu_torch.md import minimize as tmin
from gromacs_fep_gpu_tpu_torch.md.constraints import (
    max_deviation, settle_positions as tsettle)

import torch_bridge  # noqa: F401  (one torch thread per worker)

SIG, EPS, K_TETHER = 0.34, 0.5, 100.0
D_OH, D_HH = 0.09572, 0.15139


def _lattice(seed, shape=(3, 2, 2), a=0.4, noise=0.05):
    rng = np.random.default_rng(seed)
    sites = np.stack(np.meshgrid(*[np.arange(n) * a for n in shape],
                                 indexing="ij"), -1).reshape(-1, 3)
    return sites, sites + rng.normal(scale=noise, size=sites.shape)


def _energy(xp, x, ref, lj_rows):
    """LJ over every pair of the rows lj_rows plus a harmonic tether of
    every atom to ref; xp is jnp or torch."""
    y = x[lj_rows]
    d = y[:, None, :] - y[None, :, :]
    n = y.shape[0]
    off = 1.0 - xp.eye(n, dtype=x.dtype)
    r2 = (d * d).sum(-1) + (1.0 - off)
    s6 = (SIG * SIG / r2) ** 3
    lj = 0.5 * (4.0 * EPS * (s6 * s6 - s6) * off).sum()
    return lj + 0.5 * K_TETHER * ((x - ref) ** 2).sum()


def _jax_force(ref, lj_rows, calls):
    ref = jnp.asarray(ref)
    grad = jax.grad(lambda x: _energy(jnp, x, ref, lj_rows))

    def force(x, box, lam):
        e = _energy(jnp, x, ref, lj_rows)
        jax.debug.callback(lambda v: calls.append(float(v)), e, ordered=True)
        return -grad(x), types.SimpleNamespace(epot=e)
    return force


def _torch_force(ref, lj_rows, calls):
    ref = torch.as_tensor(ref)

    def force(x, box, lam):
        xg = x.detach().requires_grad_(True)
        e = _energy(torch, xg, ref, lj_rows)
        (g,) = torch.autograd.grad(e, xg)
        calls.append(float(e.detach()))
        return -g, types.SimpleNamespace(epot=e.detach())
    return force


def _accepts(calls):
    """The accept/reject sequence of steep and cg from their force calls
    (one per iteration after the first)."""
    cur, out = calls[0], []
    for e in calls[1:]:
        out.append(e < cur)
        cur = e if e < cur else cur
    return out


def _compare(jres, tres, jcalls, tcalls):
    assert len(tcalls) == len(jcalls)
    np.testing.assert_allclose(tcalls, jcalls, rtol=1e-6)
    assert tres.n_steps == int(jres.n_steps)
    assert tres.converged == bool(jres.converged)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tres.epot), float(jres.epot),
                               rtol=1e-6)
    # the trace: the start, then the current energy after each iteration
    assert tres.epot_trace.shape == (tres.n_steps + 1,)
    assert tres.accepted.shape == (tres.n_steps,)


@pytest.mark.parametrize("algo,kw", [
    ("steepest_descent", {"step0": 0.01}),
    ("conjugate_gradient", {"step0": 0.005}),
    ("l_bfgs", {"step0": 0.01, "m": 4})])
def test_minimizer_matches_jax_in_float64(algo, kw):
    ref, x0 = _lattice(5)
    lj_rows = np.arange(ref.shape[0])
    jcalls, tcalls = [], []
    jax.config.update("jax_enable_x64", True)
    try:
        jres = getattr(jmin, algo)(
            jnp.asarray(x0), None, None, _jax_force(ref, lj_rows, jcalls),
            nsteps=40, emtol=1e-3, **kw)
        jax.block_until_ready(jres.x)
        jax.effects_barrier()
    finally:
        jax.config.update("jax_enable_x64", False)
    tres = getattr(tmin, algo)(torch.as_tensor(x0), None, None,
                               _torch_force(ref, lj_rows, tcalls),
                               nsteps=40, emtol=1e-3, **kw)
    assert tres.n_steps >= 10 and float(tres.epot) < tcalls[0]
    _compare(jres, tres, jcalls, tcalls)
    if algo != "l_bfgs":
        assert tres.accepted.tolist() == _accepts(jcalls)
        assert len(tcalls) == tres.n_steps + 1
    drop, acc = np.diff(tres.epot_trace.numpy()), tres.accepted.numpy()
    assert (drop[acc] < 0).all() and (drop[~acc] == 0).all()


def _waters():
    """Four waters (O on a perturbed lattice, the Hs at the SETTLE
    geometry) and their tether sites: (x0, ref, atoms, invmass, box)."""
    sites, o = _lattice(9, shape=(2, 2, 1), a=0.3, noise=0.04)
    h1 = o + np.array([D_OH, 0.0, 0.0])
    ang = np.arccos(1.0 - D_HH ** 2 / (2.0 * D_OH ** 2))
    h2 = o + D_OH * np.array([np.cos(ang), np.sin(ang), 0.0])
    x0 = np.stack([o, h1, h2], 1).reshape(-1, 3)
    ref = np.stack([sites, sites + (h1 - o), sites + (h2 - o)],
                   1).reshape(-1, 3)
    n_w = o.shape[0]
    atoms = np.arange(3 * n_w).reshape(n_w, 3)
    invmass = np.tile([1.0 / 15.9994, 1.0 / 1.008, 1.0 / 1.008], n_w)
    return x0, ref, atoms, invmass, np.eye(3) * 5.0


def _tsettle_groups(atoms):
    n_w = atoms.shape[0]
    return TSettle(atoms=torch.as_tensor(atoms),
                   d_oh=torch.full((n_w,), D_OH, dtype=torch.float64),
                   d_hh=torch.full((n_w,), D_HH, dtype=torch.float64),
                   mask=torch.ones((n_w,), dtype=torch.float64))


def test_steep_with_settle_keeps_the_water_geometry():
    """Four waters, LJ between the oxygens, every atom tethered: steep
    with the port's SETTLE on each trial step against JAX's steep with
    JAX's SETTLE; every O-H and H-H distance stays at its length."""
    x0, ref, atoms, invmass, box = _waters()
    n_w = atoms.shape[0]
    lj_rows = atoms[:, 0]
    jcalls, tcalls = [], []
    jax.config.update("jax_enable_x64", True)
    try:
        js = JSettle(atoms=jnp.asarray(atoms, jnp.int32),
                     d_oh=jnp.full((n_w,), D_OH),
                     d_hh=jnp.full((n_w,), D_HH), mask=jnp.ones((n_w,)))
        jbox, jinv = jnp.asarray(box), jnp.asarray(invmass)
        jres = jmin.steepest_descent(
            jnp.asarray(x0), jbox, None, _jax_force(ref, lj_rows, jcalls),
            nsteps=30, emtol=1e-3, step0=0.01,
            constrain_fn=lambda xr, xt: jsettle(xr, xt, jbox, js, jinv))
        jax.block_until_ready(jres.x)
        jax.effects_barrier()
    finally:
        jax.config.update("jax_enable_x64", False)
    ts = _tsettle_groups(atoms)
    tbox, tinv = torch.as_tensor(box), torch.as_tensor(invmass)
    tres = tmin.steepest_descent(
        torch.as_tensor(x0), tbox, None, _torch_force(ref, lj_rows, tcalls),
        nsteps=30, emtol=1e-3, step0=0.01,
        constrain_fn=lambda xr, xt: tsettle(xr, xt, tbox, ts, tinv))
    _compare(jres, tres, jcalls, tcalls)
    assert int(tres.accepted.sum()) >= 5
    x = tres.x.numpy().reshape(n_w, 3, 3)
    for a, b, d in ((0, 1, D_OH), (0, 2, D_OH), (1, 2, D_HH)):
        r = np.linalg.norm(x[:, a] - x[:, b], axis=-1)
        np.testing.assert_allclose(r, d, rtol=1e-9)


@pytest.mark.parametrize("algo", ["steepest_descent", "conjugate_gradient",
                                  "l_bfgs"])
def test_trial_that_breaks_settle_is_rejected(algo):
    """The four waters with a first trial step of 0.3 nm, past what the
    Newton SETTLE solves (it fails for displacements of a few hundredths
    of a nm): valid_fn (every constraint length within 1e-4) rejects such
    trials (steep and cg reject the iteration, l_bfgs halves its step),
    the force is then taken at the current x, so no force call sees a
    broken water, the energy never rises, and the result keeps the water
    geometry."""
    x0, ref, atoms, invmass, box = _waters()
    ts, tbox = _tsettle_groups(atoms), torch.as_tensor(box)
    system = types.SimpleNamespace(settle=ts, lincs=TLincs.empty())
    calls, verdicts, seen = [], [], []
    force = _torch_force(ref, atoms[:, 0], calls)

    def watched(x, box, lam):
        seen.append(float(max_deviation(x, tbox, system)))
        return force(x, box, lam)

    def valid(x):
        ok = max_deviation(x, tbox, system) <= 1e-4
        verdicts.append(bool(ok))
        return ok

    res = getattr(tmin, algo)(
        torch.as_tensor(x0), tbox, None, watched, nsteps=30, emtol=1e-3,
        step0=0.3, constrain_fn=lambda xr, xt: tsettle(
            xr, xt, tbox, ts, torch.as_tensor(invmass)),
        valid_fn=valid)
    # l_bfgs backtracks from the rejected trial within its iteration
    assert not verdicts[0] and any(verdicts)
    assert bool(res.accepted[0]) == (algo == "l_bfgs")
    assert max(seen) <= 1e-4
    trace = res.epot_trace.numpy()
    assert np.isfinite(trace).all() and (np.diff(trace) <= 0).all()
    assert trace[-1] < trace[0]
    assert float(max_deviation(res.x, tbox, system)) <= 1e-4
