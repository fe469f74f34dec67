"""SETTLE, v-rescale and the slice as a whole: the port against the JAX
package.

Tolerances: SETTLE positions 1e-6 nm (a few fp32 ulps of the coordinates)
and v-rescale scale rel 1e-6 (same draws, same formula).  The 40-step run
compares after twenty pair-list rebuilds with MTS2: positions to 1e-4 nm, and
potential energy and dV/dlambda (coulomb, vdw) to 1e-5 of the largest
energy term (the reciprocal sum), since the total is a sum of large terms
of both signs; the runs differ only in fp32 summation order and the erfc
approximation (the port's plain K1/K2/K3 against the JAX package's XLA
cluster kernel and dense PME, torch.fft against the matmul DFT), which 40
steps of dynamics amplify.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core.types import CoulombType as JCoulomb
from gromacs_fep_gpu_tpu.core.types import FepParams as JFep
from gromacs_fep_gpu_tpu.core.types import MdParams as JMdParams
from gromacs_fep_gpu_tpu.md import constraints as jconstr
from gromacs_fep_gpu_tpu.md import coupling as jcoupling
from gromacs_fep_gpu_tpu.md.runner import MdRunner as JRunner
from gromacs_fep_gpu_tpu.md.runner import RunnerConfig as JConfig
from gromacs_fep_gpu_tpu.md.runner import concat_logs as j_concat
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops.pme import pme_grid_size
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.md import constraints as tconstr
from gromacs_fep_gpu_tpu_torch.md import coupling as tcoupling
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner as TRunner
from gromacs_fep_gpu_tpu_torch.md.runner import RunnerConfig as TConfig
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs as t_concat
from gromacs_fep_gpu_tpu_torch.md.simulator import masses_at_lambda

from torch_bridge import t, to_port


def test_settle_matches_jax():
    js, jst = solvation_system(n_side=5, seed=7)
    rng = np.random.RandomState(1)
    x1 = jst.x + jnp.asarray(rng.normal(0, 0.003, jst.x.shape), jnp.float32)
    invm = 1.0 / js.mass_a
    xc_j = np.asarray(jconstr.settle_positions(jst.x, x1, jst.box, js.settle,
                                               invm))
    ts, tst = to_port(js, jst)
    _, tinvm = masses_at_lambda(ts, torch.tensor(0.0))
    xc_t = tconstr.settle_positions(tst.x, t(x1), tst.box, ts.settle, tinvm)
    np.testing.assert_allclose(xc_t.numpy(), xc_j, rtol=0, atol=1e-6)
    o, h1 = ts.settle.atoms[:, 0], ts.settle.atoms[:, 1]
    d = torch.linalg.norm(xc_t[o] - xc_t[h1], dim=-1)
    np.testing.assert_allclose(d.numpy(), ts.settle.d_oh.numpy(), rtol=1e-5)


def test_velocity_constraint_matches_jax():
    """v' = (SETTLE(x, x + dt v) - x) / dt, the JAX simulator's
    constrain_velocities, on the JAX settle_positions; tolerance 1e-3 nm/ps
    (1e-6 nm of position over dt = 1 fs)."""
    js, jst = solvation_system(n_side=5, seed=4)
    dt = 0.001
    invm = 1.0 / js.mass_a
    xv = jconstr.settle_positions(jst.x, jst.x + dt * jst.v, jst.box,
                                  js.settle, invm)
    v_j = np.asarray((xv - jst.x) / dt)
    ts, tst = to_port(js, jst)
    _, tinvm = masses_at_lambda(ts, torch.tensor(0.0))
    v_t = tconstr.constrain_velocities(tst.x, tst.v, tst.box, ts.settle,
                                       tinvm, dt)
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=0, atol=1e-3)
    # a step along the constrained velocities keeps the O-H bond lengths
    o, h1 = ts.settle.atoms[:, 0], ts.settle.atoms[:, 1]
    x1 = tst.x + dt * v_t
    d = torch.linalg.norm(x1[o] - x1[h1], dim=-1)
    np.testing.assert_allclose(d.numpy(), ts.settle.d_oh.numpy(), rtol=1e-5)


@pytest.mark.parametrize("ekin", [900.0, 1200.0])
def test_vrescale_matches_jax_with_same_draws(ekin):
    ndf, ekin_ref, dt_c, tau = 1500.0, 1000.0, 0.02, 0.1
    key = jax.random.PRNGKey(3)
    s_j, d_j = jcoupling.vrescale_lambda(jnp.float32(ekin), ekin_ref, ndf,
                                         dt_c, tau, key)
    # the JAX function's own draws, replayed from its key
    k1, k2 = jax.random.split(key)
    r1 = float(jax.random.normal(k1, ()))
    r2 = max((ndf - 1.0) + np.sqrt(2.0 * (ndf - 1.0))
             * float(jax.random.normal(k2, ())), 0.0)
    s_t, d_t = tcoupling.vrescale_scale(torch.tensor(ekin), ekin_ref, ndf,
                                        dt_c, tau, torch.tensor(r1),
                                        torch.tensor(r2))
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-5)


def test_runner_matches_jax_40_steps():
    """The slice end to end: Hilbert sort, union lists, v2u pack, K1/K2/K3
    plain versions, soft-core FEP, bonded, SETTLE, MTS2, ten rebuilds.

    The JAX reference runs its XLA route (the XLA cluster kernel on the
    per-cluster list, dense PME): the same physics as its Pallas kernels,
    which tests/test_pallas_nb.py holds to that kernel, at a fraction of
    their interpret-mode cost; the port's plain K1 is held to the Pallas
    kernel itself in tests/test_torch_nb.py.

    nstlist is 2: the JAX runner unrolls one step body per change of force
    flavour, and MTS2 alternates the flavour every step, so its compile
    time grows with nstlist; nstlist 2 also runs twenty rebuilds, and
    energies are compared at every MTS on-step."""
    n_side, nsteps, nst = 6, 40, 2
    js, jst = solvation_system(n_side=n_side, seed=0)
    jst = jst.replace(lam=jst.lam.at[2].set(0.5).at[3].set(0.5))
    grid = pme_grid_size([n_side * 0.31] * 3, 0.12)
    common = dict(dt=0.001, nstlist=nst, rcoulomb=0.6, rvdw=0.6, rlist=0.6,
                  pme_grid=grid, nstcomm=100, nstcalcenergy=nst, mts=True)
    fep = dict(enabled=True, sc_alpha=0.5, sc_coul=True, sc_sigma=0.3,
               nstdhdl=nst)
    jp = JMdParams(coulomb=JCoulomb.PME, fep=JFep(**fep), **common)
    # the box is too small for build-time shifts: the port takes the
    # in-loop minimum-image kernel flavour (the XLA kernel always does).
    # Both are set up front, and the JAX list capacity covers the need, so
    # JAX compiles its chunk once.
    jr = JRunner(js, jp, JConfig(nnbr=128, blocked_pme=False,
                                 fep_max_nbr=128))
    ts, tst = to_port(js, jst)
    jst_out, jlogs = jr.run(jst, nsteps)
    jlog = j_concat(jlogs)

    tp = ttypes.MdParams(coulomb=ttypes.CoulombType.PME,
                         fep=ttypes.FepParams(**fep), **common)
    tr = TRunner(ts, tp, TConfig(super_nnbr=128, fep_max_nbr=128,
                                 baked_shifts=False))
    tst_out, tlogs = tr.run(tst, nsteps)
    tlog = t_concat(tlogs)

    assert tst_out.step == nsteps == int(jst_out.step)
    np.testing.assert_allclose(tst_out.x.numpy(), np.asarray(jst_out.x),
                               rtol=0, atol=1e-4)
    e_j = np.asarray(jlog.epot)
    e_t = tlog.epot.numpy()
    on = np.isfinite(e_j)
    assert on.sum() == nsteps // nst and np.array_equal(
        on, np.isfinite(e_t))
    # epot is a sum of large terms of both signs: gate it on their scale
    scale = np.abs(np.asarray(jlog.terms.coul_recip)[on]).max()
    np.testing.assert_allclose(e_t[on], e_j[on], rtol=0, atol=1e-5 * scale)
    for ch in (2, 3):      # coulomb and vdw lambda channels
        np.testing.assert_allclose(tlog.dvdl.numpy()[on, ch],
                                   np.asarray(jlog.dvdl)[on, ch], rtol=0,
                                   atol=1e-5 * scale)


def test_runner_grows_capacity_and_rolls_back():
    """Capacities that overflow grow by the JAX runner's contract (union
    list: need = max(flag, cap) * 1.25 + 8, 32-aligned; FEP list: cap * 1.5
    + 8) and the chunk restarts from its verified start state, so no step
    runs on an overflowed list: the run matches one at ample capacity to
    1e-5 nm (only the padding of the j streams differs)."""
    from gromacs_fep_gpu_tpu_torch.models.solvation import \
        solvation_system as t_solv
    from gromacs_fep_gpu_tpu_torch.ops import pairlist as tpl
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size as t_grid
    ts, tst = t_solv(n_side=5, seed=2, device="cpu")
    lam = tst.lam.clone()
    lam[2] = lam[3] = 0.5
    tst = tst.replace(lam=lam)
    tp = ttypes.MdParams(
        dt=0.001, nstlist=5, coulomb=ttypes.CoulombType.PME, rcoulomb=0.6,
        rvdw=0.6, rlist=0.6, pme_grid=t_grid((5 * 0.31,) * 3, 0.12),
        nstcalcenergy=10, fep=ttypes.FepParams(enabled=True, sc_alpha=0.5,
                                               sc_coul=True, nstdhdl=10))
    small = TRunner(ts, tp, TConfig(super_nnbr=32, fep_max_nbr=8,
                                    baked_shifts=False))
    out_s, _ = small.run(tst, 10)
    big = TRunner(ts, tp, TConfig(super_nnbr=256, fep_max_nbr=512,
                                  baked_shifts=False))
    out_b, _ = big.run(tst, 10)
    assert big.n_regrow == 0 and small.n_regrow >= 2
    first = tpl.build_cluster_pairlist(
        tst.x, tst.box, ts, small._rlist, cell_size=small.config.cell_size,
        super_nnbr=32, super_block=4)
    assert int(first.super_overflow) > 0
    need = int(max(int(first.super_max_count), 32) * 1.25 + 8)
    assert small.config.super_nnbr == (need + 31) // 32 * 32
    assert small.config.fep_max_nbr > 8
    assert not any(small.last_flags[k] for k in ("fep_ovf", "s_ovf"))
    np.testing.assert_allclose(out_s.x.numpy(), out_b.x.numpy(), rtol=0,
                               atol=1e-5)
