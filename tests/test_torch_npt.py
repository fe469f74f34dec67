"""The NPT lambda window of the port against the JAX package: dispersion
correction, K1's virial flavour, the in-force virial, the reciprocal
strain derivative, the 1-4 pairs of the production force, the barostats
and the pressure-coupled run.

Tolerances:
- dispersion correction (float64 numpy on both sides): rel 1e-6;
- K1 plain virial against the Pallas kernel in interpret mode: 1e-4 of
  max |Xi_aa| (JAX's own gate, tests/test_virial.py); ~1e5 pair terms of
  both signs are summed in float32 in another order;
- the cluster route's vir_diag against JAX make_cluster_force_fn(
  need_virial=True) and against the port's dense float64 oracle
  (make_pressure_fn): 2e-4 of max |Xi_aa| (tests/test_virial.py:48-50);
  forces 2e-5 of the largest, energy and dV/dlambda 1e-5 of the largest
  energy term;
- the reciprocal strain derivative against jax.grad of the JAX reciprocal
  energy at (x s, box s): 1e-5 of max |Xi_aa| in float32, 1e-9 in float64;
- the 1-4 pairs on the production route: energies and dV/dlambda 1e-5 of
  the largest energy term, forces 1e-5 of the largest force;
- Berendsen and C-rescale scale factors with JAX's own noise draw: rel
  1e-6; the pressure of virial_pressure rel 1e-6;
- 40 steps of Berendsen NPT at lambda = 0 against the JAX runner on its XLA
  cluster path: box rel 1e-5, x 1e-4 nm; the pressure on the pressure
  steps 4e-3 of the virial's own pressure scale 2/V max |Xi| PRESFAC
  (~12,000 bar here; measured up to 2.1e-3).  The potential virials agree
  to ~5e-6 on one frame; the SETTLE virial is built, on both sides, from
  x_c - x_new, a float32 difference of ~1 nm positions for ~1e-4 nm
  displacements: m ulp(x) / dt^2 is ~2 kJ/mol/nm of noise per atom at
  dt = 1 fs, some 10-30 bar summed over the box (the box, which
  integrates P, still agrees to 1e-5).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core import topology as jtop
from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.md import coupling as jcoupling
from gromacs_fep_gpu_tpu.md.runner import MdRunner as JRunner
from gromacs_fep_gpu_tpu.md.runner import RunnerConfig as JConfig
from gromacs_fep_gpu_tpu.md.runner import concat_logs as j_concat
from gromacs_fep_gpu_tpu.models import water as jwater
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import dispcorr as jdisp
from gromacs_fep_gpu_tpu.ops import pairlist as jpl
from gromacs_fep_gpu_tpu.ops import pme as jpme
from gromacs_fep_gpu_tpu.ops.cluster_nb import \
    make_cluster_force_fn as j_cluster_force_fn
from gromacs_fep_gpu_tpu.ops.pallas_nb import pallas_cluster_forces_v2u
from gromacs_fep_gpu_tpu.parallel.ensemble import lambda_schedule as j_sched
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.core.units import PRESFAC
from gromacs_fep_gpu_tpu_torch.md import coupling as tcoupling
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner as TRunner
from gromacs_fep_gpu_tpu_torch.md.runner import RunnerConfig as TConfig
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs as t_concat
from gromacs_fep_gpu_tpu_torch.md.simulator import (make_pressure_fn,
                                                    make_step_fn)
from gromacs_fep_gpu_tpu_torch.ops import dispcorr as tdisp
from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
from gromacs_fep_gpu_tpu_torch.ops import pairlist as tpl
from gromacs_fep_gpu_tpu_torch.ops import pme as tpme
from gromacs_fep_gpu_tpu_torch.ops.cluster_nb import make_cluster_force_fn
from gromacs_fep_gpu_tpu_torch.ops.forces import dense_energy, get_beta
from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule

from torch_bridge import (jax_cluster_list, jax_prepare_v2u, md_params,
                          port_cluster_list, t, to_port)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LAM_HALF = np.array([0, 0, 0.5, 0.5, 0.5, 0, 0], np.float32)
RLIST = 0.6


def _both(**kw):
    """(JAX MdParams, port MdParams) of the same settings."""
    return md_params(jtypes, **kw), md_params(ttypes, **kw)


def _fep_params(**kw):
    fep = dict(enabled=True, sc_alpha=0.5, sc_coul=True, sc_sigma=0.3)
    return _both(rcoulomb=0.58, rvdw=0.58, rlist=RLIST, fep=fep, **kw)


@pytest.fixture(scope="module")
def solvated():
    """The 650-atom solvation box, ligand off its lattice site."""
    js, jst = solvation_system(n_side=6, seed=3)
    rng = np.random.RandomState(5)
    jst = jst.replace(x=jst.x.at[:5].add(
        jnp.asarray(rng.normal(0, 0.02, (5, 3)), jnp.float32)))
    return js, jst, *to_port(js, jst)


# ---------------------------------------------------------------------------
# dispersion correction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modifier", ["potential-shift", "force-switch",
                                      "none"])
def test_dispcorr_integrals_match_jax(solvated, modifier):
    js, _, ts, _ = solvated
    jp, tp = _both(rvdw=0.9, rvdw_switch=0.7, vdw_modifier=modifier)
    np.testing.assert_allclose(tdisp.energy_integrals(tp),
                               jdisp.energy_integrals(jp), rtol=1e-12)
    for side in ("a", "b"):
        np.testing.assert_allclose(tdisp.average_c6_c12(ts, side),
                                   jdisp.average_c6_c12(js, side),
                                   rtol=1e-12)


@pytest.mark.parametrize("lam_v", [0.0, 0.5, 1.0])
def test_dispcorr_tail_matches_jax(solvated, lam_v):
    """e_tail, its dV/dlambda_vdw and p_tail; and an (L,) lambda gives the
    scalar calls' values row by row."""
    js, jst, ts, tst = solvated
    jp, tp = _both(rvdw=0.9, dispcorr=True)
    je, jpt = jdisp.make_dispersion_correction(js, jp)
    te, tpt = tdisp.make_dispersion_correction(ts, tp)
    box64 = tst.box.double()
    e_j, d_j = je(np.asarray(jst.box, np.float64), lam_v)
    e_t, d_t = te(box64, lam_v)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-6)
    assert float(d_t) != 0.0          # the ligand's B state has no LJ
    np.testing.assert_allclose(float(tpt(box64, lam_v)),
                               float(jpt(np.asarray(jst.box, np.float64),
                                         lam_v)), rtol=1e-6)
    e_l, _ = te(box64, torch.tensor([0.0, lam_v, 1.0], dtype=torch.float64))
    np.testing.assert_allclose(float(e_l[1]), float(e_t), rtol=1e-12)


# ---------------------------------------------------------------------------
# K1's virial flavour
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False],
                ids=["baked_shifts", "min_image"])
def water_lists(request):
    system, state = jwater.water_box(8, spacing=0.31, seed=11,
                                     temperature=300.0)
    jl = jax_cluster_list(state.x, state.box, system, 0.7, nnbr=0,
                          super_nnbr=256, super_block=4,
                          compute_shifts=request.param)
    assert int(jl.super_overflow) == 0
    jprep = jax_prepare_v2u(jl, system.nbfp)
    ts, _ = to_port(system, state)
    tl = port_cluster_list(jl, jl.n_clusters)
    return system, state, jl, jprep, tl, nb_v2u.prepare_v2u(tl, ts.nbfp)


@pytest.mark.parametrize("coulomb", ["reaction-field", "pme"])
def test_plain_virial_matches_pallas(water_lists, coulomb):
    system, state, jl, jprep, tl, tprep = water_lists
    jp, tp = _both(rcoulomb=0.55, rvdw=0.55, rlist=0.7, coulomb=coulomb)
    beta = 3.5 if coulomb == "pme" else None
    f_j, ec_j, el_j, vir_j = pallas_cluster_forces_v2u(
        state.x, state.box, jl, system.nbfp, jp, beta, prep=jprep,
        interpret=True, compute_virial=True)
    consts = nb_v2u.NbConstants.from_params(tp, beta)
    f_t, ec_t, el_t, vir_t = nb_v2u.cluster_forces_v2u(
        t(state.x), t(state.box), tl, tprep, consts, compute_virial=True)
    vir_j = np.asarray(vir_j)
    np.testing.assert_allclose(vir_t.numpy(), vir_j, rtol=0,
                               atol=1e-4 * np.abs(vir_j).max())
    np.testing.assert_allclose(float(ec_t), float(ec_j), rtol=1e-5)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=2e-5 * np.abs(np.asarray(f_j)).max())
    with pytest.raises(ValueError, match="energy flavour"):
        nb_v2u.cluster_forces_v2u(t(state.x), t(state.box), tl, tprep,
                                  consts, compute_energy=False,
                                  compute_virial=True)


# ---------------------------------------------------------------------------
# the in-force virial of the cluster route
# ---------------------------------------------------------------------------

def _port_lists(ts, tst):
    nlist = tpl.build_cluster_pairlist(tst.x, tst.box, ts, RLIST,
                                       super_nnbr=256)
    assert int(nlist.super_overflow) == 0
    pert = np.where(ts.perturbed.numpy())[0]
    feplist = tpl.build_fep_pairlist(tst.x, tst.box, ts, RLIST, pert,
                                     max_nbr=256)
    assert int(feplist.n_overflow) == 0
    return nlist, feplist, nb_v2u.prepare_v2u(nlist, ts.nbfp)


@pytest.fixture(scope="module")
def cluster_virial(solvated):
    """The port's cluster force with need_virial at lambda 0.5, PME, FEP
    and dispcorr; and JAX's (XLA cluster kernel, AD reciprocal)."""
    js, jst, ts, tst = solvated
    grid = tpme.pme_grid_size([6 * 0.31] * 3, 0.12)
    jp, tp = _fep_params(coulomb="pme", pme_grid=grid, dispcorr=True)
    recip_j = jpme.make_pme_recip_fn(js, jp)
    jff = j_cluster_force_fn(js, jp, recip_j, has_fep=True, block=16)
    jl = jax_cluster_list(jst.x, jst.box, js, RLIST, nnbr=128)
    assert int(jl.n_overflow) == 0
    pert = np.where(np.asarray(js.perturbed))[0]
    jfl = jpl.build_fep_pairlist(jst.x, jst.box, js, RLIST, pert,
                                 max_nbr=256)
    f_j, terms_j = jax.jit(lambda x: jff(x, jst.box, jnp.asarray(LAM_HALF),
                                         jl, jfl, need_virial=True))(jst.x)
    recip_t = tpme.make_pme_recip_fns(ts, tp)
    tff = make_cluster_force_fn(ts, tp, has_fep=True,
                                pme_recip_force_fn=recip_t[1])
    nlist, feplist, prep = _port_lists(ts, tst)
    f_t, terms_t = tff(tst.x, tst.box, t(LAM_HALF), nlist, feplist, prep,
                       need_virial=True)
    return ts, tst, tp, recip_t[0], (f_j, terms_j), (f_t, terms_t)


def test_cluster_virial_matches_jax(cluster_virial):
    _, _, _, _, (f_j, terms_j), (f_t, terms_t) = cluster_virial
    vir_j = np.asarray(terms_j.vir_diag)
    np.testing.assert_allclose(terms_t.vir_diag.numpy(), vir_j, rtol=0,
                               atol=2e-4 * np.abs(vir_j).max())
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=2e-5 * np.abs(f_j).max())
    scale = abs(float(terms_j.coul_recip))
    np.testing.assert_allclose(float(terms_t.epot), float(terms_j.epot),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(float(terms_t.dispcorr),
                               float(terms_j.dispcorr), rtol=1e-6)
    for ch in (2, 3):
        np.testing.assert_allclose(float(terms_t.dvdl[ch]),
                                   float(terms_j.dvdl[ch]), rtol=0,
                                   atol=1e-5 * scale)


def test_cluster_virial_matches_dense_oracle(cluster_virial):
    """The in-force virial (K1 pair sums + strain gradient of the cheap
    terms + reciprocal strain derivative on fixed grids, float32) against
    the strain gradient of the whole dense potential in float64."""
    ts, tst, tp, recip_fn, _, (_, terms_t) = cluster_virial
    beta = get_beta(tp)

    def epot(x, box, lam):
        return dense_energy(x, box, lam, ts, tp, beta, recip_fn).epot
    mass = ts.mass_a.double()
    _, _, vir = make_pressure_fn(epot)(
        tst.x.double(), tst.box.double(), t(LAM_HALF, torch.float64),
        torch.zeros_like(tst.x, dtype=torch.float64), mass)
    np.testing.assert_allclose(terms_t.vir_diag.double().numpy(),
                               vir.numpy(), rtol=0,
                               atol=2e-4 * vir.abs().max().item())


@pytest.mark.parametrize("double", [False, True])
def test_recip_virial_matches_jax_strain_grad(solvated, double):
    """The reciprocal virial on the force pass's fixed grids against
    jax.grad of the JAX reciprocal energy (spread included) under strain."""
    js, jst, ts, tst = solvated
    grid = tpme.pme_grid_size([6 * 0.31] * 3, 0.12)
    jp, tp = _fep_params(coulomb="pme", pme_grid=grid)
    jax.config.update("jax_enable_x64", double)
    try:
        jdt = jnp.float64 if double else jnp.float32
        recip_j = jpme.make_pme_recip_fn(js, jp)
        x, box = jst.x.astype(jdt), jst.box.astype(jdt)
        lam_c = jnp.asarray(0.5, jdt)
        vir_j = np.asarray(0.5 * jax.jit(jax.grad(lambda e: recip_j(
            x * (1.0 + e)[None, :], box * (1.0 + e)[None, :], lam_c)))(
                jnp.zeros(3, jdt)))
    finally:
        jax.config.update("jax_enable_x64", False)
    tdt = torch.float64 if double else torch.float32
    out = tpme.make_pme_recip_fns(ts, tp)[1](
        tst.x.to(tdt), tst.box.to(tdt), torch.tensor(0.5, dtype=tdt),
        need_virial=True)
    assert len(out) == 4 and out[3].dtype == tdt
    tol = 1e-9 if double else 1e-5
    np.testing.assert_allclose(out[3].numpy(), vir_j, rtol=0,
                               atol=tol * np.abs(vir_j).max())


# ---------------------------------------------------------------------------
# the 1-4 pairs on the production route
# ---------------------------------------------------------------------------

def _chain_in_water():
    """A 4-site perturbed chain with one perturbed and one plain 1-4 pair,
    among TIP3P waters on a 5^3 lattice (JAX System and State)."""
    chain = jtop.MoleculeType(
        name="CH", types_a=[2, 2, 2, 2], charges_a=[0.3, -0.2, 0.1, -0.2],
        masses_a=[12.0] * 4, charges_b=[0.1, -0.2, 0.1, 0.0],
        types_b=[2, 2, 2, 1],
        bonds=[((i, i + 1), (0.15, 2.0e5)) for i in range(3)],
        pairs14=[((0, 3), (-0.06, 2.0e-3, 2.0e-6), (0.0, 0.0, 0.0)),
                 ((0, 2), (0.03, 1.0e-3, 1.0e-6))])
    xc = np.array([[0.62, 0.70, 0.70], [0.76, 0.74, 0.71],
                   [0.86, 0.85, 0.74], [1.00, 0.87, 0.78]])
    n_side, spacing = 5, 0.31
    lattice = (np.mgrid[0:n_side, 0:n_side, 0:n_side].reshape(3, -1).T
               + 0.5) * spacing
    keep = np.linalg.norm(lattice[:, None] - xc[None], axis=-1).min(1) > 0.3
    rng = np.random.RandomState(4)
    rots = jwater._random_rotations(int(keep.sum()), rng)
    xw = (lattice[keep][:, None, :] + np.einsum(
        'nij,kj->nki', rots, jwater.water_template())).reshape(-1, 3)
    nbfp = jtop.lj_table_from_sigma_eps(
        [jwater.O_SIGMA, 0.1, 0.34], [jwater.O_EPS, 0.0, 0.4], comb_rule=3)
    system = jtop.build_system([(chain, 1), (jwater.tip3p_moltype(),
                                             int(keep.sum()))], nbfp,
                               fudge_qq=0.5)
    x = np.concatenate([xc, xw]).astype(np.float32)
    box = np.eye(3, dtype=np.float32) * n_side * spacing
    state = jtypes.make_state(x, np.zeros_like(x), box, seed=0)
    return system, state


def test_pairs14_in_cluster_force_matches_jax():
    """The production force sums the 1-4 pairs: forces, coul14/lj14 and
    dV/dlambda against JAX make_cluster_force_fn."""
    js, jst = _chain_in_water()
    assert js.pairs14.n == 2
    ts, tst = to_port(js, jst)
    jp, tp = _fep_params(coulomb="reaction-field")
    jl = jax_cluster_list(jst.x, jst.box, js, RLIST, nnbr=128)
    pert = np.where(np.asarray(js.perturbed))[0]
    jfl = jpl.build_fep_pairlist(jst.x, jst.box, js, RLIST, pert,
                                 max_nbr=256)
    jff = j_cluster_force_fn(js, jp, has_fep=True, block=16)
    f_j, terms_j = jax.jit(lambda x: jff(x, jst.box, jnp.asarray(LAM_HALF),
                                         jl, jfl))(jst.x)
    tff = make_cluster_force_fn(ts, tp, has_fep=True)
    nlist, feplist, prep = _port_lists(ts, tst)
    f_t, terms_t = tff(tst.x, tst.box, t(LAM_HALF), nlist, feplist, prep)
    names = ("coulomb", "lj", "bonds", "coul14", "lj14")
    scale = max(abs(float(getattr(terms_j, k))) for k in names)
    # the gate below sees the 1-4 energy if it goes missing
    assert abs(float(terms_j.coul14)) > 10 * 1e-5 * scale
    for k in names + ("epot",):
        np.testing.assert_allclose(float(getattr(terms_t, k)),
                                   float(getattr(terms_j, k)), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    np.testing.assert_allclose(terms_t.dvdl.numpy(),
                               np.asarray(terms_j.dvdl), rtol=0,
                               atol=1e-5 * scale)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=1e-5 * np.abs(f_j).max())


# ---------------------------------------------------------------------------
# barostats and the pressure-coupled step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p_cur", [-350.0, 1.0, 820.0])
def test_pscale_matches_jax(p_cur):
    """Berendsen, C-rescale with JAX's own N(0, 1) draw injected (at the
    JAX function's temp = ref_t, where both agree), virial_pressure."""
    dt_p, tau, kappa, vol, ref_t = 0.02, 1.0, 4.5e-5, 27.3, 300.0
    mu_j = jcoupling.berendsen_pscale(jnp.float32(p_cur), 1.0, dt_p, tau,
                                      kappa)
    mu_t = tcoupling.berendsen_pscale(torch.tensor(p_cur), 1.0, dt_p, tau,
                                      kappa)
    np.testing.assert_allclose(float(mu_t), float(mu_j), rtol=1e-6)
    key = jax.random.PRNGKey(int(abs(p_cur)))
    xi = float(jax.random.normal(key, ()))
    mu_j = jcoupling.crescale_pscale(jnp.float32(p_cur), 1.0, dt_p, tau,
                                     kappa, vol, ref_t, key)
    mu_t = tcoupling.crescale_pscale(torch.tensor(p_cur), 1.0, dt_p, tau,
                                     kappa, torch.tensor(vol), ref_t,
                                     torch.tensor(xi))
    np.testing.assert_allclose(float(mu_t), float(mu_j), rtol=1e-6)
    rng = np.random.RandomState(2)
    ek, vir = rng.normal(size=(3, 3)) * 300, rng.normal(size=(3, 3)) * 300
    p_j, pt_j = jcoupling.virial_pressure(ek, vir, vol)
    p_t, pt_t = tcoupling.virial_pressure(t(ek), t(vir), vol)
    np.testing.assert_allclose(float(p_t), float(p_j), rtol=1e-6)
    np.testing.assert_allclose(pt_t.numpy(), np.asarray(pt_j), rtol=1e-6)


@pytest.fixture(scope="module")
def one_step():
    """One pressure step of the port's make_step_fn on the 86-atom
    solvation box with a stub force (zero forces, a fixed virial), at
    lambda = 1 (the ligand's LJ off), C-rescale with and without the tail
    pressure and without pressure coupling: (state in, (state, log) per
    variant, the drawn xi)."""
    ts, tst = to_port(*solvation_system(n_side=3, spacing=0.4, seed=7,
                                        temperature=400.0))
    tst = tst.replace(lam=torch.tensor([0, 0, 1.0, 1.0, 1.0, 0, 0]))
    vir = torch.tensor([150.0, -40.0, 90.0])

    def force(x, box, lam, flavor):
        return torch.zeros_like(x), ttypes.EnergyTerms.zeros(
            x.device).replace(vir_diag=vir)
    out = {}
    for name, kw in (("none", dict(pcoupl="no")),
                     ("c-rescale", dict(pcoupl="c-rescale", dispcorr=True)),
                     ("c-rescale-no-tail", dict(pcoupl="c-rescale"))):
        p = md_params(ttypes, dt=0.001, rvdw=0.58, nstcomm=0, tau_p=1.0,
                      ref_t=300.0, nstpcouple=1, **kw)
        gen = torch.Generator().manual_seed(11)
        out[name] = make_step_fn(ts, p, force, gen)(tst, "R")
    xi = torch.randn((), generator=torch.Generator().manual_seed(11))
    return ts, tst, out, xi


def _crescale_mu(tst, p_bar, xi, ref_t):
    vol = torch.prod(torch.diagonal(tst.box))
    return tcoupling.crescale_pscale(p_bar, 1.0, 0.001, 1.0, 4.5e-5, vol,
                                     ref_t, xi)


def test_crescale_scales_velocities_by_inverse_mu(one_step):
    """Reference coupling.cpp crescale_pscale scales v by 1/mu; the JAX
    step scales only x and the box."""
    _, tst, out, xi = one_step
    (s0, _), (s1, lg1) = out["none"], out["c-rescale"]
    mu = _crescale_mu(tst, lg1.pres, xi, 300.0)
    assert abs(float(mu) - 1.0) > 1e-6
    torch.testing.assert_close(s1.box, tst.box * mu, rtol=1e-6, atol=0)
    torch.testing.assert_close(s1.x, s0.x * mu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s1.v, s0.v / mu, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(s1.v, s0.v, rtol=1e-7, atol=0)


def test_crescale_noise_uses_reference_temperature(one_step):
    """The noise amplitude takes kT at ref_t (300 K), not the instantaneous
    temperature (~400 K) the JAX step passes."""
    _, tst, out, xi = one_step
    s1, lg1 = out["c-rescale"]
    mu_ref = _crescale_mu(tst, lg1.pres, xi, 300.0)
    mu_inst = _crescale_mu(tst, lg1.pres, xi, float(lg1.temp))
    assert abs(float(lg1.temp) - 300.0) > 10.0
    torch.testing.assert_close(s1.box[0, 0], tst.box[0, 0] * mu_ref,
                               rtol=1e-7, atol=0)
    assert abs(float(mu_ref - mu_inst)) > 1e-6


def test_tail_pressure_at_current_lambda(one_step):
    """The step adds p_tail at the current lambda_vdw (1 here), as the
    reference does; the JAX step adds it at lambda_vdw = 0."""
    ts, tst, out, _ = one_step
    p = md_params(ttypes, rvdw=0.58, dispcorr=True)
    _, p_tail = tdisp.make_dispersion_correction(ts, p)
    got = out["c-rescale"][1].pres - out["c-rescale-no-tail"][1].pres
    torch.testing.assert_close(got, p_tail(tst.box, 1.0).float(),
                               rtol=1e-4, atol=1e-4)
    assert abs(float(p_tail(tst.box, 1.0) - p_tail(tst.box, 0.0))) > 1.0


def test_flavor_pattern_matches_jax():
    """'R' on the pressure steps and 'S' where they meet a sweep, with MTS2
    and a ladder; nstpcouple joins the MTS alignment checks."""
    js, jst = solvation_system(n_side=6, seed=0)
    grid = tpme.pme_grid_size([6 * 0.31] * 3, 0.12)
    kw = dict(coulomb="pme", rcoulomb=0.6, rvdw=0.6, rlist=0.6,
              pme_grid=grid, mts=True, nstcalcenergy=20, nstlist=10,
              pcoupl="c-rescale", nstpcouple=10,
              fep=dict(enabled=True, sc_alpha=0.5, nstdhdl=40))
    jr = JRunner(js, md_params(jtypes, **kw), JConfig(),
                 all_lambda=j_sched(4))
    ts, tst = to_port(js, jst)
    tr = TRunner(ts, md_params(ttypes, **kw), TConfig(),
                 all_lambda=lambda_schedule(4))
    for start in (0, 30):
        pat = tr._flavor_pattern(start, 120)
        assert pat == jr._flavor_pattern(start, 120)
        assert pat.count("S") == 3 and pat.count("R") == 9
    bad = TRunner(ts, md_params(ttypes, **dict(kw, nstpcouple=5)), TConfig(),
                  all_lambda=lambda_schedule(4))
    with pytest.raises(ValueError, match="nstpcouple"):
        bad.run(tst, 1)


def test_berendsen_npt_matches_jax_runner():
    """40 steps of Berendsen NPT (nstpcouple 5, PME, dispcorr, SETTLE) at
    lambda = 0 through both runners: the port's v2u route with its plain
    kernels against the JAX runner's XLA cluster route.  A water box: the
    solvation box's ligand, fully coupled at lambda = 0, starts in a clash
    that heats its lattice start past 10^4 K within ten steps."""
    n_side, nsteps = 5, 40
    js, jst = jwater.water_box(n_side, spacing=0.31, seed=0,
                               temperature=300.0)
    grid = tpme.pme_grid_size([n_side * 0.31] * 3, 0.12)
    # nstlist = nstcalcenergy = nstpcouple: one flavour pattern "RFFFF" per
    # chunk, so the JAX runner traces two step bodies
    kw = dict(dt=0.001, nstlist=5, coulomb="pme", rcoulomb=0.6, rvdw=0.6,
              rlist=0.6, pme_grid=grid, nstcomm=10, nstcalcenergy=5,
              dispcorr=True, pcoupl="berendsen", tau_p=0.5, nstpcouple=5)
    jr = JRunner(js, md_params(jtypes, **kw), JConfig(nnbr=128))
    j_out, jlogs = jr.run(jst, nsteps)
    jlog = j_concat(jlogs)
    ts, tst = to_port(js, jst)
    tr = TRunner(ts, md_params(ttypes, **kw),
                 TConfig(super_nnbr=128, baked_shifts=False))
    t_out, tlogs = tr.run(tst, nsteps)
    tlog = t_concat(tlogs)

    box_j = np.asarray(j_out.box)
    assert abs(box_j[0, 0] / float(jst.box[0, 0]) - 1.0) > 1e-4
    np.testing.assert_allclose(t_out.box.numpy(), box_j, rtol=1e-5, atol=0)
    np.testing.assert_allclose(t_out.x.numpy(), np.asarray(j_out.x), rtol=0,
                               atol=1e-4)
    p_j, p_t = np.asarray(jlog.pres), tlog.pres.numpy()
    on = np.arange(nsteps) % 5 == 0
    assert np.isfinite(p_t[on]).all() and np.isnan(p_t[~on]).all()
    assert np.array_equal(np.isfinite(p_j), np.isfinite(p_t))
    vol = float(np.prod(np.diag(np.asarray(jst.box))))
    vir_scale = 2.0 / vol * PRESFAC * np.abs(
        np.asarray(jlog.terms.vir_diag)[on]).max()
    np.testing.assert_allclose(p_t[on], p_j[on], rtol=0,
                               atol=4e-3 * vir_scale)


# ---------------------------------------------------------------------------
# Parrinello-Rahman, semiisotropic coupling and the constraint virial
# ---------------------------------------------------------------------------

def _pr_inputs(seed):
    """A cubic box, a pressure tensor and a box velocity from a seed."""
    rng = np.random.RandomState(seed)
    box = np.eye(3, dtype=np.float32) * np.float32(rng.uniform(1.5, 3.0))
    p = rng.normal(0.0, 400.0, (3, 3)).astype(np.float32)
    boxv = np.diag(rng.normal(0.0, 1e-3, 3)).astype(np.float32)
    vol = float(np.prod(np.diag(box)))
    return box, p, boxv, vol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parrinello_rahman_step_matches_jax(seed):
    """The port's parrinello_rahman_step against JAX's on seeded inputs,
    rel 1e-6: the JAX function divides W^-1 by PRESFAC, which the reference
    does not (coupling.cpp: the pressure unit drops out of kappa P), so it
    is called with compressibility * PRESFAC.  pr_boxv_step on the cubic
    box: isotropic is JAX's function fed the scalar pressure times I;
    semiisotropic takes x and y from (P_xx + P_yy) / 2 and z from P_zz with
    its own ref_p_z and compressibility_z."""
    box, p, boxv, vol = _pr_inputs(seed)
    kw = dict(dt=0.02, tau_p=2.0, volume=vol)
    kappa, kappa_z, ref, ref_z = 4.5e-5, 3.0e-5, 1.0, 250.0

    def jax_pr(p_t, ref_p, k):
        return np.asarray(jcoupling.parrinello_rahman_step(
            jnp.asarray(boxv), jnp.asarray(box), jnp.asarray(p_t), ref_p,
            compressibility=k * PRESFAC, **kw))
    got = tcoupling.parrinello_rahman_step(t(boxv), t(box), t(p), ref,
                                           compressibility=kappa, **kw)
    np.testing.assert_allclose(got.numpy(), jax_pr(p, ref, kappa),
                               rtol=1e-6, atol=0)
    pd = np.diag(p)
    iso = tcoupling.pr_boxv_step(t(boxv), t(box), t(pd), ref, None,
                                 kw["dt"], kw["tau_p"], kappa, None, vol,
                                 "isotropic")
    np.testing.assert_allclose(
        iso.numpy(), jax_pr(np.eye(3) * pd.mean(), ref, kappa), rtol=1e-6)
    semi = tcoupling.pr_boxv_step(t(boxv), t(box), t(pd), ref, ref_z,
                                  kw["dt"], kw["tau_p"], kappa, kappa_z, vol,
                                  "semiisotropic")
    xy = jax_pr(np.eye(3) * 0.5 * (pd[0] + pd[1]), ref, kappa)
    z = jax_pr(np.diag(pd), ref_z, kappa_z)
    np.testing.assert_allclose(np.diag(semi.numpy()),
                               [xy[0, 0], xy[1, 1], z[2, 2]], rtol=1e-6)
    inc = np.diag(semi.numpy()) - np.diag(boxv)
    np.testing.assert_allclose(inc[0], inc[1], rtol=1e-6)
    assert semi[0, 1] == 0.0


@pytest.mark.parametrize("p_xx,p_yy,p_zz", [(-350.0, 120.0, 820.0),
                                            (40.0, 40.0, -600.0)])
def test_semiiso_berendsen_pscale_matches_jax(p_xx, p_yy, p_zz):
    """The semiisotropic Berendsen scale factors against JAX's branch
    (berendsen_pscale of (P_xx + P_yy) / 2 and of P_zz with ref_p_z and
    compressibility_z), rel 1e-6; z without them takes the xy values."""
    dt_p, tau = 0.02, 1.0
    p_diag = np.array([p_xx, p_yy, p_zz], np.float32)
    for ref_z, k_z in ((250.0, 3.0e-5), (None, None)):
        mu_xy = jcoupling.berendsen_pscale(
            jnp.float32(0.5 * (p_xx + p_yy)), 1.0, dt_p, tau, 4.5e-5)
        mu_z = jcoupling.berendsen_pscale(
            jnp.float32(p_zz), 1.0 if ref_z is None else ref_z, dt_p, tau,
            4.5e-5 if k_z is None else k_z)
        got = tcoupling.berendsen_pscale_semiiso(
            t(p_diag), 1.0, ref_z, dt_p, tau, 4.5e-5, k_z)
        np.testing.assert_allclose(
            got.numpy(), [float(mu_xy), float(mu_xy), float(mu_z)],
            rtol=1e-6)


@pytest.fixture(scope="module")
def stub_box():
    """The 86-atom solvation box of one_step at lambda = 1 and a stub force
    (zero forces, an anisotropic fixed virial)."""
    ts, tst = to_port(*solvation_system(n_side=3, spacing=0.4, seed=7,
                                        temperature=400.0))
    tst = tst.replace(lam=torch.tensor([0, 0, 1.0, 1.0, 1.0, 0, 0]))
    vir = torch.tensor([150.0, -40.0, 90.0])

    def force(x, box, lam, flavor):
        return torch.zeros_like(x), ttypes.EnergyTerms.zeros(
            x.device).replace(vir_diag=vir.to(x.dtype))
    return ts, tst, force


def test_isotropic_pr_step_on_cubic_box(stub_box):
    """One isotropic Parrinello-Rahman step (nstpcouple 1) on the cubic box
    equals JAX's parrinello_rahman_step fed P I (compressibility * PRESFAC,
    see above) with the box and x scaled by 1 + dt boxv / L and v scaled by
    1 - dt boxv / L, the equations of motion's M v term with M = b^-1 boxv
    (computed in numpy): box and x rel 1e-6, v 1e-6 of its largest.  Over
    five steps with P_xx, P_yy and P_zz thousands of bar apart the box stays
    cubic (rel 1e-6), where JAX's step integrates each edge from its own
    P_aa."""
    ts, tst, force = stub_box
    kw = dict(dt=0.001, rvdw=0.58, nstcomm=0, tau_p=0.05, ref_t=300.0,
              nstpcouple=1, compressibility=4.5e-5)
    s0, _ = make_step_fn(ts, md_params(ttypes, pcoupl="no", **kw), force,
                         torch.Generator().manual_seed(1))(tst, "R")
    pr = make_step_fn(ts, md_params(ttypes, pcoupl="parrinello-rahman",
                                    **kw), force,
                      torch.Generator().manual_seed(1))
    s1, lg = pr(tst, "R")
    L = float(tst.box[0, 0])
    vol = L ** 3
    boxv = np.asarray(jcoupling.parrinello_rahman_step(
        jnp.zeros((3, 3)), jnp.asarray(tst.box.numpy()),
        jnp.eye(3) * float(lg.pres), 1.0, kw["dt"], kw["tau_p"],
        kw["compressibility"] * PRESFAC, vol))
    np.testing.assert_allclose(s1.coupling.boxv.numpy(), boxv, rtol=1e-6,
                               atol=0)
    bv = np.diag(boxv)
    assert abs(bv[0]) > 1e-4 and np.all(bv == bv[0])
    mu = (L + kw["dt"] * bv) / L
    np.testing.assert_allclose(s1.box.numpy(), tst.box.numpy() * mu,
                               rtol=1e-6)
    np.testing.assert_allclose(s1.x.numpy(), s0.x.numpy() * mu, rtol=1e-6,
                               atol=1e-6)
    v_want = s0.v.numpy() * (1.0 - kw["dt"] * bv / L)
    np.testing.assert_allclose(s1.v.numpy(), v_want, rtol=0,
                               atol=1e-6 * np.abs(v_want).max())
    assert np.abs(s1.v.numpy() - s0.v.numpy()).max() \
        > 10 * 1e-6 * np.abs(v_want).max()
    s = tst
    for _ in range(5):
        s, lg = pr(s, "R")
    b = torch.diagonal(s.box).numpy()
    np.testing.assert_allclose(b, b[0], rtol=1e-6)
    assert abs(b[0] / L - 1.0) > 1e-4


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-5),
                                        (torch.float32, 1e-4)],
                         ids=["float64", "float32"])
def test_split_molecules_give_the_whole_pressure(dtype, rtol):
    """One C-rescale pressure step (stub force, nstpcouple 1) of the
    solvation box whose ligand has four LINCS rows (chip_smoke._lb_system):
    a water's H1 moved one box up in x and a ligand H one box down in y
    give the pressure of the molecules made whole.  float64 rel 1e-5 (the
    step in float64: 1.5e-14 measured); float32 rel 1e-4: the split atoms'
    float32 coordinates round differently near L than near 0, which moves
    their SETTLE and LINCS corrections by ~1e-7 nm (2.1e-5 measured).  Not
    held against JAX, whose virial over raw positions changes with the
    images: that formula, -1/2 sum x_c m (x_c - x_new) / dt^2, moves by
    more than 100 times the gate between the two frames."""
    ts = chip_smoke._lb_system(3, "cpu")
    _, tst = to_port(*solvation_system(n_side=3, spacing=0.4, seed=7,
                                       temperature=400.0))
    assert ts.lincs.atoms.shape[0] == 4 and ts.settle.atoms.shape[0] == 26
    tst = tst.replace(x=tst.x.to(dtype), v=tst.v.to(dtype),
                      box=tst.box.to(dtype), lam=tst.lam.to(dtype))
    vir = torch.tensor([150.0, -40.0, 90.0], dtype=dtype)

    def force(x, box, lam, flavor):
        return torch.zeros_like(x), ttypes.EnergyTerms.zeros(
            x.device).replace(vir_diag=vir)
    p = md_params(ttypes, dt=0.002, nstcomm=0, tau_p=1.0, ref_t=300.0,
                  nstpcouple=1, pcoupl="c-rescale")
    L = torch.diagonal(tst.box)
    h_w, h_l = 5 + 3 * 4 + 1, 1
    split = tst.x.clone()
    split[h_w, 0] += L[0]
    split[h_l, 1] -= L[1]
    out = {}
    for name, x in (("whole", tst.x), ("split", split)):
        gen = torch.Generator().manual_seed(3)
        out[name] = make_step_fn(ts, p, force, gen)(tst.replace(x=x), "R")
    p_w, p_s = float(out["whole"][1].pres), float(out["split"][1].pres)
    assert abs(p_s - p_w) <= rtol * abs(p_w)
    # the raw-position formula on the same step
    dt = p.dt
    x_new = {k: (x + dt * tst.v) for k, x in (("whole", tst.x),
                                              ("split", split))}
    raw = {}
    for k in x_new:
        x_c = out[k][0].x / ((out[k][0].box / tst.box).diagonal())
        f_c = ts.mass_a.to(dtype)[:, None] * (x_c - x_new[k]) / dt ** 2
        raw[k] = -0.5 * torch.sum(x_c * f_c, 0)
    vol = float(torch.prod(L))
    dp_raw = float((raw["split"] - raw["whole"]).abs().max()) \
        * 2.0 / (3.0 * vol) * PRESFAC
    assert dp_raw > 100 * rtol * abs(p_w)


def test_semiiso_berendsen_npt_matches_jax_runner():
    """40 steps of semiisotropic Berendsen (ref_p_z 300 bar,
    compressibility_z 3e-5 /bar against ref_p 1 bar and 4.5e-5 /bar in
    xy) through both runners, as test_berendsen_npt_matches_jax_runner:
    box rel 1e-5, x 1e-4 nm, the pressure on the pressure steps 4e-3 of the
    virial's pressure scale; x and y scale together, z on its own."""
    n_side, nsteps = 5, 40
    js, jst = jwater.water_box(n_side, spacing=0.31, seed=0,
                               temperature=300.0)
    grid = tpme.pme_grid_size([n_side * 0.31] * 3, 0.12)
    kw = dict(dt=0.001, nstlist=5, coulomb="pme", rcoulomb=0.6, rvdw=0.6,
              rlist=0.6, pme_grid=grid, nstcomm=10, nstcalcenergy=5,
              dispcorr=True, pcoupl="berendsen", pcoupltype="semiisotropic",
              ref_p_z=300.0, compressibility_z=3.0e-5, tau_p=0.5,
              nstpcouple=5)
    jr = JRunner(js, md_params(jtypes, **kw), JConfig(nnbr=128))
    j_out, jlogs = jr.run(jst, nsteps)
    jlog = j_concat(jlogs)
    ts, tst = to_port(js, jst)
    tr = TRunner(ts, md_params(ttypes, **kw),
                 TConfig(super_nnbr=128, baked_shifts=False))
    t_out, tlogs = tr.run(tst, nsteps)
    tlog = t_concat(tlogs)

    box_j = np.asarray(j_out.box)
    b0 = float(jst.box[0, 0])
    assert abs(box_j[0, 0] / b0 - 1.0) > 1e-4
    assert abs(box_j[2, 2] / box_j[0, 0] - 1.0) > 1e-4
    np.testing.assert_allclose(t_out.box.numpy(), box_j, rtol=1e-5, atol=0)
    assert t_out.box[0, 0] == t_out.box[1, 1]
    np.testing.assert_allclose(t_out.x.numpy(), np.asarray(j_out.x), rtol=0,
                               atol=1e-4)
    p_j, p_t = np.asarray(jlog.pres), tlog.pres.numpy()
    on = np.arange(nsteps) % 5 == 0
    assert np.isfinite(p_t[on]).all() and np.isnan(p_t[~on]).all()
    vol = float(np.prod(np.diag(np.asarray(jst.box))))
    vir_scale = 2.0 / vol * PRESFAC * np.abs(
        np.asarray(jlog.terms.vir_diag)[on]).max()
    np.testing.assert_allclose(p_t[on], p_j[on], rtol=0,
                               atol=4e-3 * vir_scale)


def _pr_cli_inputs(pcoupltype):
    """grompp inputs of the published example's window 0 (rule 3, ~190
    atoms at 1.24 nm, reaction field) with Parrinello-Rahman, nstpcouple
    2, in the current directory."""
    from gromacs_fep_gpu_tpu_torch import cli as tcli
    lig, top, mdp, _ = chip_smoke.example_inputs()
    Path("lig.gro").write_text(lig)
    tcli.main(["solvate", "-cp", "lig.gro", "-box",
               str(chip_smoke.EXAMPLE_BOX), "-o", "conf.gro"], device="cpu")
    n_atoms = int(Path("conf.gro").read_text().splitlines()[1])
    Path("topol.top").write_text(chip_smoke.geometric_top(top).format(
        nsol=(n_atoms - 1) // 3))
    keys = {"tcoupl": "no", "gen-seed": 7, "pcoupl": "parrinello-rahman",
            "pcoupltype": pcoupltype, "tau-p": 0.5, "nstpcouple": 2,
            "nstcalcenergy": 2}
    if pcoupltype == "semiisotropic":
        keys.update({"ref-p": "1.0 400.0", "compressibility": "4.5e-5 3e-5"})
    else:
        keys.update({"ref-p": "1.0", "compressibility": "4.5e-5"})
    Path("pr.mdp").write_text(chip_smoke.mdp_with(
        mdp.format(nsteps=10, window=0), keys))
    tcli.main(["grompp", "-f", "pr.mdp", "-p", "topol.top", "-c", "conf.gro",
               "-o", "pr.tpz"], device="cpu")


@pytest.mark.parametrize("pcoupltype", ["isotropic", "semiisotropic"])
def test_pr_cli_restart_equals_one_run(tmp_path, monkeypatch, pcoupltype):
    """grompp -> mdrun with Parrinello-Rahman on the CPU: 20 steps equal 10
    steps, the port's .cpt, then 10 more (x, v, box, boxv bitwise: the
    checkpoint carries the box velocity); boxv moved, the .gmx.cpt holds
    it; semiisotropic keeps L_x = L_y and moves L_z on its own."""
    from gromacs_fep_gpu_tpu_torch import cli as tcli
    from gromacs_fep_gpu_tpu_torch.io.cptio import read_gmx_cpt
    monkeypatch.chdir(tmp_path)
    _pr_cli_inputs(pcoupltype)

    def mdrun(*argv):
        return tcli.main(["mdrun", "-s", "pr.tpz", "-fep", "gpu", *argv],
                         device="cpu")[1]
    whole = mdrun("-deffnm", "whole", "-nsteps", "20")
    mdrun("-deffnm", "half")
    rest = mdrun("-deffnm", "rest", "-cpi", "half.cpt")
    assert rest.step == whole.step == 20
    for k in ("x", "v", "box"):
        assert torch.equal(getattr(rest, k), getattr(whole, k)), k
    assert torch.equal(rest.coupling.boxv, whole.coupling.boxv)
    bv = torch.diagonal(whole.coupling.boxv)
    assert bool((bv != 0).all())
    np.testing.assert_array_equal(
        np.asarray(read_gmx_cpt("whole.gmx.cpt").state["boxv"]).reshape(
            3, 3), whole.coupling.boxv.numpy())
    b = torch.diagonal(whole.box)
    if pcoupltype == "semiisotropic":
        assert b[0] == b[1] and abs(float(b[2] / b[0]) - 1.0) > 1e-5
    else:
        np.testing.assert_allclose(b.numpy(), float(b[0]), rtol=1e-6)
    pres = np.loadtxt("whole.ener.csv")[:, 4]
    assert np.isfinite(pres[::2]).all() and np.isnan(pres[1::2]).all()


@pytest.mark.parametrize("lines,item", [
    ("pcoupl = mttk", "item 5"),
    ("pcoupl = parrinello-rahman\npcoupltype = anisotropic", "item 5"),
    ("pcoupl = berendsen\npcoupltype = surface-tension", "item 5"),
    ("pcoupl = c-rescale\npcoupltype = semiisotropic", "item 6")])
def test_pressure_mdp_raises_name_their_item(lines, item):
    """The pressure settings the port does not run raise, naming the ROADMAP
    item that lifts them (the JAX reader accepts them, and its step runs
    semiisotropic C-rescale as isotropic)."""
    from gromacs_fep_gpu_tpu.io import mdpio as jmdp
    from gromacs_fep_gpu_tpu_torch.io import mdpio as tmdp
    text = "integrator = md\n" + lines + "\n"
    jmdp.mdp_to_params(text)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tmdp.mdp_to_params(text)
