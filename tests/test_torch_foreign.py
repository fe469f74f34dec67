"""The foreign-lambda sweep (ops/foreign.py): the port against the JAX
package's make_foreign_delta_fn and against the port's own dense oracle.

Tolerances: against JAX (float32 both) 1e-5 of max |Delta H|, plus, with
PME, 2e-7 of the reciprocal energy: JAX takes each Delta H as the
difference of two float32 reciprocal energies of ~1e4 kJ/mol, the port
multiplies one slope by (lambda_l - lambda_cur); the own window's entry
|.| <= 1e-4 kJ/mol (the port's is exactly 0: the current lambda rides in
the same pass).  Against the dense oracle in float64 (differences of the
whole potential, one dense_energy per window): 1e-8 of max |Delta H|, which
also proves that the reciprocal term is linear in lambda_coul.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import foreign as jforeign
from gromacs_fep_gpu_tpu.ops import pme as jpme
from gromacs_fep_gpu_tpu.ops.pairlist import build_fep_pairlist
from gromacs_fep_gpu_tpu.parallel.ensemble import lambda_schedule as j_sched
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.ops import foreign as tforeign
from gromacs_fep_gpu_tpu_torch.ops import forces as tforces
from gromacs_fep_gpu_tpu_torch.ops import pme as tpme
from gromacs_fep_gpu_tpu_torch.ops.pairlist import FepPairlist
from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule

from torch_bridge import t, to_port

L = 5
RLIST = 0.6


def _params(coulomb):
    common = dict(rcoulomb=0.58, rvdw=0.58, rlist=RLIST)
    fep = dict(enabled=True, sc_alpha=0.5, sc_coul=True, sc_sigma=0.3)
    grid = (12, 12, 12) if coulomb == "pme" else None
    jp = jtypes.MdParams(coulomb=jtypes.CoulombType(coulomb), pme_grid=grid,
                         fep=jtypes.FepParams(**fep), **common)
    tp = ttypes.MdParams(coulomb=ttypes.CoulombType(coulomb), pme_grid=grid,
                         fep=ttypes.FepParams(**fep), **common)
    return jp, tp


@pytest.fixture(scope="module")
def system():
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=13)
    # move the ligand off its lattice site so every term is off its minimum
    rng = np.random.RandomState(3)
    jst = jst.replace(x=jst.x.at[:5].add(
        jnp.asarray(rng.normal(0, 0.02, (5, 3)), jnp.float32)))
    pert = np.where(np.asarray(js.perturbed))[0]
    jfl = build_fep_pairlist(jst.x, jst.box, js, RLIST, pert, max_nbr=128)
    assert int(jfl.n_overflow) == 0
    ts, tst = to_port(js, jst)
    tfl = FepPairlist(iidx=t(jfl.iidx, torch.int64),
                      jidx=t(jfl.jidx, torch.int64), included=t(jfl.included),
                      excluded=t(jfl.excluded), n_overflow=t(jfl.n_overflow))
    return js, jst, jfl, ts, tst, tfl


@pytest.fixture(scope="module")
def jax_delta(system):
    """The JAX sweep, jitted once per Coulomb type."""
    js, jst, jfl = system[:3]
    fns = {}

    def get(coulomb):
        if coulomb not in fns:
            jp, _ = _params(coulomb)
            recip = (jpme.make_pme_recip_fn(js, jp) if coulomb == "pme"
                     else None)
            core = jforeign.make_foreign_delta_fn(js, jp, j_sched(L), recip)
            fns[coulomb] = jax.jit(
                lambda lam: core(jst.x, jst.box, lam, jfl))
        return fns[coulomb]
    return get


def test_lambda_schedule_matches_jax():
    for n in (2, 5, 20):
        np.testing.assert_array_equal(lambda_schedule(n),
                                      np.asarray(j_sched(n)))
    assert lambda_schedule(5).dtype == np.float32


@pytest.mark.parametrize("coulomb", ["pme", "reaction-field"])
@pytest.mark.parametrize("window", [0, 2])
def test_foreign_delta_matches_jax(system, jax_delta, coulomb, window):
    js, jst, jfl, ts, tst, tfl = system
    _, tp = _params(coulomb)
    all_lam = lambda_schedule(L)
    dh_j = np.asarray(jax_delta(coulomb)(jnp.asarray(all_lam[window])))

    slope, e_rec = None, 0.0
    if coulomb == "pme":
        recip, _, slope = tpme.make_pme_recip_fns(ts, tp)
        e_rec = abs(float(recip(tst.x, tst.box, torch.tensor(0.5))))
    delta = tforeign.make_foreign_delta_fn(ts, tp, all_lam, slope)
    dh_t = delta(tst.x, tst.box, t(all_lam[window]), tfl).numpy()
    assert dh_t.shape == (L,) and dh_t.dtype == np.float32
    scale = np.abs(dh_j).max()
    assert scale > 1.0
    np.testing.assert_allclose(dh_t, dh_j, rtol=0,
                               atol=1e-5 * scale + 2e-7 * e_rec)
    assert dh_t[window] == 0.0 and abs(dh_j[window]) <= 1e-4


@pytest.mark.parametrize("coulomb", ["pme", "reaction-field"])
@pytest.mark.parametrize("window", [0, 2])
def test_foreign_delta_matches_dense_oracle_float64(system, coulomb, window):
    """Cluster-route sweep (lambda-dependent terms, FEP pair list, slope of
    the reciprocal term) against dense_energy differences of the whole
    potential, both in float64 on the same coordinates."""
    ts, tst, tfl = system[3:]
    _, tp = _params(coulomb)
    all_lam = lambda_schedule(L)
    recip = slope = None
    if coulomb == "pme":
        recip, _, slope = tpme.make_pme_recip_fns(ts, tp)
    x, box = tst.x.double(), tst.box.double()
    tfl64 = FepPairlist(iidx=tfl.iidx, jidx=tfl.jidx,
                        included=tfl.included.double(),
                        excluded=tfl.excluded.double(),
                        n_overflow=tfl.n_overflow)
    lam_cur = t(all_lam[window]).double()
    dh = tforeign.make_foreign_delta_fn(ts, tp, all_lam, slope)(
        x, box, lam_cur, tfl64)
    beta = tforces.get_beta(tp)
    with torch.no_grad():
        e = [tforces.dense_energy(x, box, lm, ts, tp, beta, recip).epot
             for lm in list(t(all_lam).double()) + [lam_cur]]
    oracle = torch.stack(e[:-1]) - e[-1]
    assert dh.dtype == torch.float64
    scale = float(oracle.abs().max())
    np.testing.assert_allclose(dh.numpy(), oracle.numpy(), rtol=0,
                               atol=1e-8 * scale)


def test_dispersion_correction_raises():
    """Dispersion correction in the sweep and the dense oracle: the
    sweep's lambda-dependent energy carries JAX's per-window tail
    e_tail(box, lambda_vdw), and the dense force its energy, rel 1e-5."""
    from gromacs_fep_gpu_tpu.ops import dispcorr as jdisp
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=13)
    ts, tst = to_port(js, jst)
    jp, tp = (p.replace(dispcorr=True) for p in _params("reaction-field"))
    lams = torch.tensor(lambda_schedule(L))
    tail = (tforeign.make_lambda_energy_fn(ts, tp)(tst.x, tst.box, lams,
                                                   None)
            - tforeign.make_lambda_energy_fn(ts, tp.replace(
                dispcorr=False))(tst.x, tst.box, lams, None))
    je, _ = jdisp.make_dispersion_correction(js, jp)
    want = [float(je(jst.box, lv)[0]) for lv in np.asarray(lams)[:, 3]]
    np.testing.assert_allclose(tail.numpy(), want, rtol=1e-5)
    lam = t(np.array([0, 0, 0.4, 0.7, 0.3, 0, 0], np.float32))
    _, terms = tforces.make_dense_force_fn(ts, tp)(tst.x, tst.box, lam)
    np.testing.assert_allclose(float(terms.dispcorr),
                               float(je(jst.box, 0.7)[0]), rtol=1e-5)
