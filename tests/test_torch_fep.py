"""Soft-core FEP pairs and bonded terms: the port against the JAX package
and against finite differences.

Tolerances: energies, forces and dV/dlambda rel 1e-5 (fp32, same
formulas; forces scaled by the largest); the finite-difference check runs
in float64 at rel 1e-6 (central differences, h = 1e-5).
"""
import jax
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core.types import CoulombType as JCoulomb
from gromacs_fep_gpu_tpu.core.types import FepParams as JFep
from gromacs_fep_gpu_tpu.core.types import MdParams as JMdParams
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import bonded as jbonded
from gromacs_fep_gpu_tpu.ops.cluster_nb import fep_pair_energy as j_fep
from gromacs_fep_gpu_tpu.ops.forces import get_beta as j_beta
from gromacs_fep_gpu_tpu.ops.pairlist import build_fep_pairlist
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.ops import bonded as tbonded
from gromacs_fep_gpu_tpu_torch.ops.cluster_nb import fep_pair_energy as t_fep
from gromacs_fep_gpu_tpu_torch.ops.fep import (FepPairData, get_beta,
                                               softcore_pair_energies)
from gromacs_fep_gpu_tpu_torch.ops.pairlist import FepPairlist

from torch_bridge import t, to_port


def _params(coulomb: str, sc_alpha=0.5, sc_coul=True):
    kw = dict(rcoulomb=0.6, rvdw=0.6, rlist=0.65)
    jp = JMdParams(coulomb=JCoulomb(coulomb), **kw,
                   fep=JFep(enabled=True, sc_alpha=sc_alpha, sc_coul=sc_coul,
                            sc_sigma=0.3))
    tp = ttypes.MdParams(coulomb=ttypes.CoulombType(coulomb), **kw,
                         fep=ttypes.FepParams(enabled=True, sc_alpha=sc_alpha,
                                              sc_coul=sc_coul, sc_sigma=0.3))
    return jp, tp


@pytest.fixture(scope="module")
def system():
    js, jst = solvation_system(n_side=6, seed=5)
    pert = np.where(np.asarray(js.perturbed))[0]
    jfl = build_fep_pairlist(jst.x, jst.box, js, 0.65, pert, max_nbr=128)
    assert int(jfl.n_overflow) == 0
    ts, tst = to_port(js, jst)
    tfl = FepPairlist(iidx=t(jfl.iidx, torch.int64),
                      jidx=t(jfl.jidx, torch.int64), included=t(jfl.included),
                      excluded=t(jfl.excluded), n_overflow=t(jfl.n_overflow))
    return js, jst, jfl, ts, tst, tfl


@pytest.mark.parametrize("coulomb,sc_alpha,sc_coul", [
    ("pme", 0.5, True), ("reaction-field", 0.5, True),
    ("reaction-field", 0.0, False)])
def test_softcore_matches_jax(system, coulomb, sc_alpha, sc_coul):
    js, jst, jfl, ts, tst, tfl = system
    jp, tp = _params(coulomb, sc_alpha, sc_coul)
    lam = (0.5, 0.3)

    def jtotal(x, lc, lv):
        ec, ev = j_fep(x, jst.box, lc, lv, jfl, js, jp, j_beta(jp))
        return ec + ev

    e_j = float(jtotal(jst.x, *lam))
    gx_j, gc_j, gv_j = jax.grad(jtotal, argnums=(0, 1, 2))(jst.x, *lam)

    x = tst.x.clone().requires_grad_(True)
    lc = torch.tensor(lam[0], requires_grad=True)
    lv = torch.tensor(lam[1], requires_grad=True)
    ec, ev = t_fep(x, tst.box, lc, lv, tfl, ts, tp, get_beta(tp))
    (ec + ev).backward()
    np.testing.assert_allclose(float((ec + ev).detach()), e_j, rtol=1e-5)
    np.testing.assert_allclose(float(lc.grad), float(gc_j), rtol=1e-5)
    np.testing.assert_allclose(float(lv.grad), float(gv_j), rtol=1e-5)
    gx_j = np.asarray(gx_j)
    np.testing.assert_allclose(x.grad.numpy(), gx_j,
                               atol=1e-5 * np.abs(gx_j).max())


def test_softcore_dvdl_matches_finite_difference(system):
    """dV/dlambda by autograd equals central differences (float64)."""
    js, jst, jfl, ts, tst, tfl = system
    _, tp = _params("pme")
    beta = get_beta(tp)
    ii, jj = tfl.iidx, tfl.jidx
    x = tst.x.double()
    dx = x[ii] - x[jj]
    dx = dx - torch.round(dx / tst.box.diagonal().double()) \
        * tst.box.diagonal().double()
    r2 = torch.sum(dx * dx, -1)
    nbfp = ts.nbfp.double()
    q_a, q_b = ts.charge_a.double(), ts.charge_b.double()
    pair = FepPairData(
        qq_a=138.935458 * q_a[ii] * q_a[jj], qq_b=138.935458 * q_b[ii] * q_b[jj],
        c6_a=nbfp[ts.type_a[ii], ts.type_a[jj], 0],
        c12_a=nbfp[ts.type_a[ii], ts.type_a[jj], 1],
        c6_b=nbfp[ts.type_b[ii], ts.type_b[jj], 0],
        c12_b=nbfp[ts.type_b[ii], ts.type_b[jj], 1])

    def energy(lc, lv):
        vc, vv = softcore_pair_energies(
            r2, pair, lc, lv, tfl.included.double(), tfl.excluded.double(),
            torch.zeros_like(r2), tp.fep, tp, beta)
        return torch.sum(vc) + torch.sum(vv)

    lc = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    lv = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    energy(lc, lv).backward()
    h = 1e-5
    with torch.no_grad():
        fd_c = (energy(lc + h, lv) - energy(lc - h, lv)) / (2 * h)
        fd_v = (energy(lc, lv + h) - energy(lc, lv - h)) / (2 * h)
    np.testing.assert_allclose(float(lc.grad), float(fd_c), rtol=1e-6)
    np.testing.assert_allclose(float(lv.grad), float(fd_v), rtol=1e-6)


@pytest.mark.parametrize("name", ["bonds", "angles"])
def test_bonded_matches_jax(system, name):
    js, jst, _, ts, tst, _ = system
    # distort the ligand so every term is off its minimum
    shift = np.random.RandomState(0).normal(0, 0.01, (5, 3)).astype(np.float32)
    xj = jst.x.at[:5].add(shift)
    fn_j = {"bonds": jbonded.bond_energy, "angles": jbonded.angle_energy}[name]
    e_j, (gx_j, gl_j) = jax.value_and_grad(
        lambda x, l: fn_j(x, jst.box, js.bonded[name], l),
        argnums=(0, 1))(xj, 0.5)
    x = t(xj).requires_grad_(True)
    lam = torch.tensor(0.5, requires_grad=True)
    e_t = tbonded.TERMS[name](x, tst.box, ts.bonded[name], lam)
    e_t.backward()
    np.testing.assert_allclose(float(e_t.detach()), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(float(lam.grad), float(gl_j), rtol=1e-5,
                               atol=1e-6)
    gx_j = np.asarray(gx_j)
    np.testing.assert_allclose(x.grad.numpy(), gx_j,
                               atol=1e-5 * np.abs(gx_j).max())
