"""LINCS bond constraints: the port against the JAX package on the same
inputs, from the user's mdp and topology to the step.

The systems are OPLS-AA ethanol (chip_smoke.ETH_TOP) with constraints =
h-bonds (a coupled CH3 star: three rows share C1) or all-bonds (coupled
chains), alone or solvated in a 1.3 nm TIP3P box (186 atoms), its O-HO row
given a B length of 0.1 nm where a perturbed length is tested; and the
two-atom perturbed constraint of tests/test_constr_dvdl.py.

Tolerances: LINCS positions 2e-6 nm, its dV/dlambda rel 1e-5 (float32,
the same formulas; the scatters sum in another order); the two-atom
dV/dlambda within 2 % of the analytic tension (the JAX test's gate) and
rel 1e-5 of JAX's step; 20 steps of sd + LINCS on JAX's draws: x 1e-4 nm,
dV/dlambda (the constraint term in the bonded column) and the Delta H
columns 1e-5 of the largest energy term (the soft-core sums of ~1e4
pair terms round in another order), the bonded column on the first two
steps 1e-5 of its own largest value; one C-rescale step's pressure with the
constraint virial 1e-4 of 2/V max |Xi_aa| PRESFAC against JAX's step in
float64 (JAX's constraint virial is built from x_c - x_new, a float32
difference of ~1 nm positions, which moves its own float32 pressure past
that gate);
System arrays and the Verlet-buffer rlist exactly; the DD runner against
the single-domain one x 2e-3 nm (tests/test_torch_dd.py's gate) and the
constraint rmsd rel 1e-2, the LINCS lengths rel 1e-4; the CLI window
(tests/test_torch_cli.py's shared ethanol run in 1.6 nm of water, on the
JAX CLI's sd draws) ener.csv rows rel 1e-4, dhdl.xvg 1e-4 of its largest
entry (as tests/test_torch_cli.py), md.log's Constr. rmsd rel 1e-3.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu import cli as jcli
from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.io import topio as jtopio
from gromacs_fep_gpu_tpu.io.xvgio import read_xvg as jread_xvg
from gromacs_fep_gpu_tpu.md import constraints as jconstr
from gromacs_fep_gpu_tpu.md import verletbuf as jvbuf
from gromacs_fep_gpu_tpu.md.simulator import make_step_fn as j_step_fn
from gromacs_fep_gpu_tpu.ops.forces import dense_energy as j_dense_energy
from gromacs_fep_gpu_tpu.ops.forces import make_dense_force_fn as j_dense
from gromacs_fep_gpu_tpu_torch import cli as tcli
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.core.topology import build_system
from gromacs_fep_gpu_tpu_torch.core.units import BOLTZ, PRESFAC
from gromacs_fep_gpu_tpu_torch.io import mdpio as tmdp
from gromacs_fep_gpu_tpu_torch.io import topio as ttopio
from gromacs_fep_gpu_tpu_torch.io.buildtools import solvate
from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg
from gromacs_fep_gpu_tpu_torch.md import constraints as tconstr
from gromacs_fep_gpu_tpu_torch.md import integrators as tinteg
from gromacs_fep_gpu_tpu_torch.md import verletbuf as tvbuf
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs
from gromacs_fep_gpu_tpu_torch.md.simulator import masses_at_lambda
from gromacs_fep_gpu_tpu_torch.md.simulator import make_step_fn as t_step_fn
from gromacs_fep_gpu_tpu_torch.models import solvation as tsolv
from gromacs_fep_gpu_tpu_torch.models import water as twater
from gromacs_fep_gpu_tpu_torch.ops.forces import dense_energy
from gromacs_fep_gpu_tpu_torch.ops.forces import make_dense_force_fn as t_dense
from gromacs_fep_gpu_tpu_torch.parallel import mesh as tmesh

import test_torch_cli as cli_tests
from test_constr_dvdl import _two_atom_system
from torch_bridge import md_params, t, to_port

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BOX = 1.3
OHO = 5                 # the O-HO row of the h-bonds list
LEN_B_OHO = 0.1
LADDER = np.array([[0.0, 0.5, 1.0, 1.0, 1.0],        # coul
                   [0.0, 0.0, 0.0, 0.5, 1.0],        # vdw
                   [0.0, 0.25, 0.5, 0.75, 1.0],      # bonded
                   [0.0, 0.25, 0.5, 0.75, 1.0]],     # restraint
                  np.float32)


def _ladder():
    """(L, 7) lambda rows of chip_smoke.ETH_MDP's five states."""
    out = np.zeros((LADDER.shape[1], int(ttypes.FepCoupling.COUNT)),
                   np.float32)
    for row, c in zip(LADDER, (ttypes.FepCoupling.COUL,
                               ttypes.FepCoupling.VDW,
                               ttypes.FepCoupling.BONDED,
                               ttypes.FepCoupling.RESTRAINT)):
        out[:, int(c)] = row
    return out


def _eth_x():
    rows = chip_smoke.ETH_GRO.splitlines()[2:11]
    return np.array([[float(r[20 + 8 * k:28 + 8 * k]) for k in range(3)]
                     for r in rows], np.float32)


@functools.lru_cache(maxsize=None)
def _inputs(solvated: bool):
    """(top text, x, box): ethanol alone in a 1.8 nm box, or solvated at
    BOX by the port's solvate."""
    xe = _eth_x()
    if not solvated:
        return chip_smoke.ETH_TOP.format(nsol=0), xe, np.eye(
            3, dtype=np.float32) * 1.8
    box = np.eye(3, dtype=np.float32) * BOX
    xw, nw = solvate(xe, box)
    return (chip_smoke.ETH_TOP.format(nsol=nw), np.concatenate([xe, xw]),
            box)


def _jax_system(constraints, solvated, pert_oho=False):
    """JAX System and State (velocities from a seeded Maxwell draw at
    300 K) of the ethanol inputs, ETH decoupled (couple-intramol = no)."""
    top, x, box = _inputs(solvated)
    js = jtopio.system_from_top(top, couple_moltype="ETH",
                                couple_intramol=False,
                                constraints=constraints)
    if pert_oho:
        lb = np.asarray(js.lincs.length_b).copy()
        lb[OHO] = LEN_B_OHO
        js = js.replace(lincs=js.lincs.replace(length_b=jnp.asarray(lb)))
    m = np.asarray(js.mass_a, np.float64)
    v = np.random.default_rng(3).normal(size=x.shape) * np.sqrt(
        BOLTZ * 300.0 / m)[:, None]
    jst = jtypes.make_state(x, v.astype(np.float32), box)
    # a strongly typed ekinh_prev, as the step returns it: one trace
    return js, jst.replace(coupling=jst.coupling.replace(
        ekinh_prev=jnp.asarray(-1.0, jnp.float32)))


# -- (a) lincs_positions ---------------------------------------------------

@pytest.mark.parametrize("constraints", ["h-bonds", "all-bonds"])
def test_lincs_positions_match_jax(constraints):
    """The CH3 star (h-bonds) and the coupled chains (all-bonds) of ethanol
    after a 0.004 nm random step, at lambda_bonded 0.3 with the O-HO
    length perturbed: positions without and with dV/dlambda, and the
    lengths reached."""
    js, jst = _jax_system(constraints, False, pert_oho=True)
    x1 = np.asarray(jst.x) + np.random.default_rng(5).normal(
        0, 0.004, jst.x.shape).astype(np.float32)
    invm = 1.0 / js.mass_a
    lam = 0.3

    @jax.jit
    def jlincs(x1):
        return (jconstr.lincs_positions(jst.x, x1, jst.box, js.lincs, invm,
                                        lam),
                jconstr.lincs_positions(jst.x, x1, jst.box, js.lincs, invm,
                                        lam, with_dhdl=True))
    xj, (xj2, dj) = jlincs(jnp.asarray(x1))
    ts, tst = to_port(js, jst)
    _, tinvm = masses_at_lambda(ts, torch.tensor(0.0))
    xt = tconstr.lincs_positions(tst.x, t(x1), tst.box, ts.lincs, tinvm,
                                 torch.tensor(lam))
    xt2, dt_ = tconstr.lincs_positions(tst.x, t(x1), tst.box, ts.lincs,
                                       tinvm, torch.tensor(lam),
                                       with_dhdl=True)
    for a, b in ((xt, xj), (xt2, xj2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)
    assert abs(float(dj)) > 1e-6
    np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)
    ai, aj = ts.lincs.atoms[:, 0], ts.lincs.atoms[:, 1]
    d = (1 - lam) * ts.lincs.length_a + lam * ts.lincs.length_b
    r = torch.linalg.norm(xt[ai] - xt[aj], dim=-1)
    np.testing.assert_allclose(r.numpy(), d.numpy(), rtol=1e-4)


# -- (b) the two-atom perturbed constraint --------------------------------

def test_two_atom_constraint_dvdl_matches_tension_and_jax():
    """Two LJ atoms joined by a constraint whose length goes 0.30 -> 0.36
    nm, at rest at lambda_bonded 0.25: the step's bonded dV/dlambda is the
    tension's dU/dr (lenB - lenA), in the port as in JAX's step."""
    len_a, len_b, lam_b = 0.30, 0.36, 0.25
    d = (1 - lam_b) * len_a + lam_b * len_b
    js, c6, c12 = _two_atom_system(len_a, len_b)
    kw = dict(dt=2e-3, coulomb="cutoff", rcoulomb=1.2, rvdw=1.2, rlist=1.3,
              nstcomm=0, fep=dict(enabled=True))
    jp, tp = md_params(jtypes, **kw), md_params(ttypes, **kw)
    x = np.array([[1.0, 1.0, 1.0], [1.0 + d, 1.0, 1.0]], np.float32)
    lam = np.zeros(7, np.float32)
    lam[int(jtypes.FepCoupling.BONDED)] = lam_b
    jst = jtypes.make_state(x, np.zeros_like(x), np.eye(3) * 3.0, lam=lam)
    _, jlog = jax.jit(j_step_fn(js, jp, j_dense(js, jp)))(jst)
    ts, tst = to_port(js, jst)
    dense = t_dense(ts, tp)
    _, tlog = t_step_fn(ts, tp, lambda x, box, lam, fl: dense(x, box, lam))(
        tst, "E")
    b = int(ttypes.FepCoupling.BONDED)
    got, want = float(tlog.dvdl[b]), float(np.asarray(jlog.dvdl)[b])
    expected = (-12 * c12 * d ** -13 + 6 * c6 * d ** -7) * (len_b - len_a)
    assert abs(got - expected) < 0.02 * abs(expected), (got, expected)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # without free-energy the term is not added
    tp0 = tp.replace(fep=ttypes.FepParams(enabled=False))
    _, tlog0 = t_step_fn(ts, tp0, lambda x, box, lam, fl: dense(x, box,
                                                               lam))(
        tst, "E")
    assert abs(float(tlog0.dvdl[b])) < 1e-6 * abs(expected)


# -- (c) 20 steps of sd + LINCS --------------------------------------------

def _sd_kw():
    return dict(dt=0.002, integrator="sd", tau_t=1.0, ref_t=300.0,
                coulomb="reaction-field", rcoulomb=0.6, rvdw=0.6, rlist=0.6,
                nstcomm=10, fep=dict(enabled=True, sc_alpha=0.5,
                                     sc_sigma=0.3, nstdhdl=5))


def test_sd_lincs_steps_match_jax(monkeypatch):
    """Ethanol (h-bonds, O-HO perturbed) in 1.3 nm of water at window 2 of
    the 5-state ladder: 20 steps of JAX's step function (dense forces, sd
    on its own keys, SETTLE + LINCS, the Delta H sweep every 5 steps) and
    of the port's on the same draws."""
    js, jst = _jax_system("h-bonds", True, pert_oho=True)
    lad = _ladder()
    jst = jst.replace(lam=jnp.asarray(lad[2]))
    jp, tp = md_params(jtypes, **_sd_kw()), md_params(ttypes, **_sd_kw())
    jlad = jnp.asarray(lad)

    def jdelta(x, box, lam):
        def e_at(lm):
            return j_dense_energy(x, box, lm, js, jp).epot
        return jax.vmap(e_at)(jlad) - e_at(lam)
    jstep = jax.jit(j_step_fn(js, jp, j_dense(js, jp), foreign_delta_fn=jdelta,
                              n_foreign=len(lad), all_lambda=jlad.T))
    n = 20
    draws = [np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(jst.rng, k), 3)[1],
        jst.v.shape, jnp.float32)) for k in range(n)]
    jlogs = []
    st = jst
    for _ in range(n):
        st, lg = jstep(st)
        jlogs.append(lg)

    ts, tst = to_port(js, jst)
    dense = t_dense(ts, tp)
    tlad = t(lad)

    def tdelta(x, box, lam):
        def e_at(lm):
            return dense_energy(x, box, lm, ts, tp).epot
        with torch.no_grad():
            return torch.stack([e_at(lm) for lm in tlad]) - e_at(lam)
    it = iter(draws)
    monkeypatch.setattr(tinteg, "sd_draws",
                        lambda shape, gen, dtype: t(next(it)))
    tstep = t_step_fn(ts, tp, lambda x, box, lam, fl: dense(x, box, lam),
                      torch.Generator(), foreign_delta_fn=tdelta,
                      n_foreign=len(lad), all_lambda=tlad)
    tlogs, s = [], tst
    for k in range(n):
        s, lg = tstep(s, "D" if k % 5 == 0 else "E")
        tlogs.append(lg)

    np.testing.assert_allclose(s.x.numpy(), np.asarray(st.x), rtol=0,
                               atol=1e-4)
    b = int(ttypes.FepCoupling.BONDED)
    e_max = max(float(np.abs(np.stack([getattr(lg.terms, k) for k in (
        "lj", "coulomb", "angles", "dihedrals", "lj14", "coul14")])).max())
        for lg in jlogs)
    dv_t = np.stack([lg.dvdl.numpy() for lg in tlogs])
    dv_j = np.stack([np.asarray(lg.dvdl) for lg in jlogs])
    np.testing.assert_allclose(dv_t, dv_j, rtol=0, atol=1e-5 * e_max)
    # the bonded column (listed terms + the constraint term) is a sum of a
    # few terms: 1e-5 of its own largest value on the first two steps;
    # later the multipliers follow the trajectories' float32 divergence
    # (~1e-4 of the column by step 10), /dt^2
    np.testing.assert_allclose(dv_t[:2, b], dv_j[:2, b], rtol=0,
                               atol=1e-5 * np.abs(dv_j[:, b]).max())
    dh_t = np.stack([lg.delta_h.numpy() for lg in tlogs])
    dh_j = np.stack([np.asarray(lg.delta_h) for lg in jlogs])
    np.testing.assert_array_equal(np.isfinite(dh_t), np.isfinite(dh_j))
    on = np.isfinite(dh_j[:, 0])
    assert on.sum() == 4
    np.testing.assert_allclose(dh_t[on], dh_j[on], rtol=0, atol=1e-5 * e_max)
    # the constraint term is in the bonded column, and well above the gate
    dvdl_c = float(dv_t[0, b]) - float(
        dense(tst.x, tst.box, tst.lam)[1].dvdl[b])
    assert abs(dvdl_c) > 100 * 1e-5 * np.abs(dv_j[:, b]).max()
    rmsd = np.array([float(lg.constr_rmsd) for lg in tlogs])
    assert (rmsd > 0).all() and np.isfinite(rmsd).all()
    ai, aj = ts.lincs.atoms[:, 0], ts.lincs.atoms[:, 1]
    lam_b = float(lad[2, b])
    d = (1 - lam_b) * ts.lincs.length_a + lam_b * ts.lincs.length_b
    r = torch.linalg.norm(s.x[ai] - s.x[aj], dim=-1)
    np.testing.assert_allclose(r.numpy(), d.numpy(), rtol=1e-4)


# -- (d) the constraint virial in a C-rescale step -------------------------

def test_crescale_pressure_with_lincs_virial_matches_jax():
    """One C-rescale pressure step (leapfrog, nstpcouple 1) of solvated
    ethanol with all-bonds: the dense forces with a fixed potential
    virial, so the pressure's difference from that virial's is the kinetic
    and the constraint virial (SETTLE + LINCS) of each step; the port's
    (float32) against JAX's pressure_from_terms in float64.  On whole
    molecules JAX's constraint virial over raw positions equals the port's
    over the constraint pairs; in float32 JAX's x_c - x_new rounding moves
    its pressure by 0.245 bar from its float64 value here (above the
    gate), the port's by 0.111 bar."""
    js, jst = _jax_system("all-bonds", True)
    kw = dict(dt=0.002, coulomb="reaction-field", rcoulomb=0.6, rvdw=0.6,
              rlist=0.6, nstcomm=1, pcoupl="c-rescale", tau_p=1.0,
              nstpcouple=1)
    jp, tp = md_params(jtypes, **kw), md_params(ttypes, **kw)
    vir = np.array([150.0, -40.0, 90.0], np.float32)
    jax.config.update("jax_enable_x64", True)
    try:
        jforce = j_dense(js, jp)
        f64 = {k: getattr(jst, k).astype(jnp.float64)
               for k in ("x", "v", "box", "lam")}

        def jfvir(x, box, lam):
            f, terms = jforce(x, box, lam)
            return f, terms.replace(vir_diag=jnp.asarray(vir, jnp.float64))
        _, jlog = jax.jit(j_step_fn(js, jp, jforce, compute_pressure=True,
                                    force_vir_fn=jfvir,
                                    static_flavor="R"))(jst.replace(**f64))
        assert jlog.pres.dtype == jnp.float64
    finally:
        jax.config.update("jax_enable_x64", False)
    ts, tst = to_port(js, jst)
    dense = t_dense(ts, tp)

    def tforce(x, box, lam, flavor):
        f, terms = dense(x, box, lam)
        return f, terms.replace(vir_diag=t(vir))
    out = {}
    for name, sys_ in (("lincs", ts), ("settle only", dataclasses.replace(
            ts, lincs=ttypes.LincsConstraints.empty()))):
        _, out[name] = t_step_fn(sys_, tp, tforce,
                                 torch.Generator().manual_seed(1))(tst, "R")
    vol = float(np.prod(np.diag(np.asarray(jst.box))))
    scale = 2.0 / vol * np.abs(vir).max() * PRESFAC
    np.testing.assert_allclose(float(out["lincs"].pres), float(jlog.pres),
                               rtol=0, atol=1e-4 * scale)
    assert abs(float(out["lincs"].pres - out["settle only"].pres)) \
        > 100 * 1e-4 * scale


# -- (e) the topology: h-bonds, all-bonds, [ constraints ] -----------------

DIRECTIVE_TOP = (chip_smoke.ETH_TOP
                 .replace("[ angletypes ]",
                          "[ constrainttypes ]\nCT  CT  1  0.15290\n\n"
                          "[ angletypes ]")
                 .replace("\n1 5 1\n", "\n").replace("\n8 9 1\n", "\n")
                 .replace("[ pairs ]",
                          "[ constraints ]\n8 9 1 0.09450 0.10000\n"
                          "1 5 2\n\n[ pairs ]"))
# the O-HO constraint from [ constrainttypes ] alone, HO perturbed to an
# HC atom type: its B length comes from the B types' entry
B_TYPES_TOP = (chip_smoke.ETH_TOP
               .replace("[ angletypes ]",
                        "[ constrainttypes ]\nHO  OH  1  0.09450\n"
                        "HC  OH  1  0.10000\n\n[ angletypes ]")
               .replace("\n8 9 1\n", "\n")
               .replace("9 opls_155 1 ETH HO  1  0.418  1.008",
                        "9 opls_155 1 ETH HO  1  0.418  1.008 opls_140")
               .replace("[ pairs ]", "[ constraints ]\n8 9 1\n\n[ pairs ]"))
TOP_CASES = {
    # name: (topology template, mdp constraints, couple ETH, LINCS rows)
    "h-bonds": (chip_smoke.ETH_TOP, "h-bonds", False, 6),
    "all-bonds": (chip_smoke.ETH_TOP, "all-bonds", False, 8),
    "directive": (DIRECTIVE_TOP, "none", False, 2),
    "h-bonds-coupled": (chip_smoke.ETH_TOP, "h-bonds", True, 6),
    "all-bonds-coupled": (chip_smoke.ETH_TOP, "all-bonds", True, 8),
    "directive-coupled": (DIRECTIVE_TOP, "none", True, 2),
    "directive-and-h-bonds": (DIRECTIVE_TOP, "h-bonds", False, 7),
    "b-types": (B_TYPES_TOP, "none", False, 1),
}


def _top_case(case):
    template, constraints, coupled, n_rows = TOP_CASES[case]
    kw = dict(constraints=constraints)
    if coupled:
        kw.update(couple_moltype="ETH", couple_intramol=False)
    return template.format(nsol=3), kw, n_rows


@pytest.mark.parametrize("case", list(TOP_CASES))
def test_system_from_top_matches_jax(case):
    """The port's System of ethanol in three waters equals JAX's: the
    LINCS rows with their A and B lengths, the remaining bonds, the
    exclusions (a funct-2 constraint adds none) and the Verlet buffer's
    rlist."""
    top, kw, n_rows = _top_case(case)
    js = jtopio.system_from_top(top, **kw)
    ts = ttopio.system_from_top(top, device="cpu", **kw)
    assert ts.lincs.atoms.shape == (n_rows, 2)
    for k in ("atoms", "length_a", "length_b", "mask"):
        np.testing.assert_array_equal(getattr(ts.lincs, k).numpy(),
                                      np.asarray(getattr(js.lincs, k)))
    np.testing.assert_array_equal(ts.exclusions.numpy(),
                                  np.asarray(js.exclusions.idx))
    assert sorted(ts.bonded) == sorted(js.bonded)
    if "bonds" in ts.bonded:
        np.testing.assert_array_equal(ts.bonded["bonds"].atoms.numpy(),
                                      np.asarray(js.bonded["bonds"].atoms))
    if case == "directive":
        assert ts.lincs.length_b[0] == pytest.approx(0.1)
        # the funct-2 row C1-C2 leaves C1 and O unexcluded, as in JAX
        assert 7 not in ts.exclusions[0].tolist()
    if case == "b-types":
        np.testing.assert_allclose(ts.lincs.length_b.numpy(), [0.1])
    kw = dict(rcoulomb=0.7, rvdw=0.7, rlist=0.7, dt=0.002, nstlist=10,
              tcoupl="v-rescale", ref_t=300.0)
    r_t = tvbuf.effective_rlist(md_params(ttypes, **kw), system=ts,
                                volume=8.0)
    r_j = jvbuf.effective_rlist(md_params(jtypes, **kw), system=js,
                                volume=8.0)
    assert r_t == r_j and r_t > 0.7


@pytest.mark.parametrize("all_bonds", [False, True])
def test_make_hbond_constraints_matches_jax(all_bonds):
    """The grompp transform on the parsed ethanol template: the same
    constraint rows (lengths from the A/B bond parameters) and the same
    bonds left, in each package; hydrogens by atom name."""
    top = chip_smoke.ETH_TOP.format(nsol=0)
    jm = jtopio.parse_top(top).moltypes["ETH"]
    tm = ttopio.parse_top(top).moltypes["ETH"]
    assert tm.atom_names == jm.atom_names
    jtopio.make_hbond_constraints(jm, all_bonds=all_bonds)
    ttopio.make_hbond_constraints(tm, all_bonds=all_bonds)
    assert len(tm.constraints) == (8 if all_bonds else 6)
    np.testing.assert_allclose(np.array(tm.constraints, np.float64),
                               np.array(jm.constraints, np.float64))
    assert [b[0] for b in tm.bonds] == [b[0] for b in jm.bonds]


@pytest.mark.parametrize("case", ["h-bonds", "all-bonds"])
def test_constraint_counts_match_jax(case):
    """n_constraints (3 per SETTLE water + the LINCS rows) and the degrees
    of freedom of the step, against JAX's."""
    from gromacs_fep_gpu_tpu.md.simulator import degrees_of_freedom as jdof
    from gromacs_fep_gpu_tpu_torch.md.simulator import degrees_of_freedom
    top, kw, n_rows = _top_case(case)
    js = jtopio.system_from_top(top, **kw)
    ts = ttopio.system_from_top(top, device="cpu", **kw)
    assert tconstr.n_constraints(ts) == jconstr.n_constraints(js) \
        == 9 + n_rows
    for nstcomm in (0, 10):
        assert degrees_of_freedom(ts, md_params(ttypes, nstcomm=nstcomm)) \
            == jdof(js, md_params(jtypes, nstcomm=nstcomm))


@pytest.mark.parametrize("order,n_rounds", [(1, 1), (2, 1), (8, 2), (4, 4)])
def test_lincs_order_and_rounds_match_jax(order, n_rounds):
    """lincs-order and lincs-iter reach JAX's LINCS: all-bonds ethanol
    after a 0.004 nm random step, positions 2e-6 nm."""
    js, jst = _jax_system("all-bonds", False)
    x1 = np.asarray(jst.x) + np.random.default_rng(9).normal(
        0, 0.004, jst.x.shape).astype(np.float32)
    xj = jconstr.lincs_positions(jst.x, jnp.asarray(x1), jst.box, js.lincs,
                                 1.0 / js.mass_a, 0.0, order, n_rounds)
    ts, tst = to_port(js, jst)
    _, tinvm = masses_at_lambda(ts, torch.tensor(0.0))
    xt = tconstr.lincs_positions(tst.x, t(x1), tst.box, ts.lincs, tinvm,
                                 torch.tensor(0.0), order, n_rounds)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=2e-6)


def test_constrain_velocities_with_lincs_matches_jax():
    """v' = (constrain(x, x + dt v) - x) / dt with SETTLE and LINCS, the
    JAX simulator's constrain_velocities; 1e-3 nm/ps (1e-6 nm over dt =
    1 fs, as tests/test_torch_md.py)."""
    js, jst = _jax_system("h-bonds", True)
    dt = 0.001
    invm = 1.0 / js.mass_a
    xv = jax.jit(lambda x, v: jconstr.constrain(x, x + dt * v, jst.box, js,
                                                invm))(jst.x, jst.v)
    v_j = np.asarray((xv - jst.x) / dt)
    ts, tst = to_port(js, jst)
    _, tinvm = masses_at_lambda(ts, torch.tensor(0.0))
    v_t = tconstr.constrain_velocities(tst.x, tst.v, tst.box, ts, tinvm, dt)
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=0, atol=1e-3)
    # a step along them puts every LINCS row on its length
    ai, aj = ts.lincs.atoms[:, 0], ts.lincs.atoms[:, 1]
    x1 = tst.x + dt * v_t
    r = torch.linalg.norm(x1[ai] - x1[aj], dim=-1)
    np.testing.assert_allclose(r.numpy(), ts.lincs.length_a.numpy(),
                               rtol=1e-4)


def test_from_numpy_round_trips_lincs():
    """to_numpy -> from_numpy keeps the LINCS rows (the parameter bridge's
    lincs_* keys, the JAX package's names)."""
    top, kw, _ = _top_case("directive-and-h-bonds")
    ts = ttopio.system_from_top(top, device="cpu", **kw)
    arrays = ttypes.to_numpy(ts)
    back, _ = ttypes.from_numpy(arrays, dict(
        x=np.zeros((ts.n_atoms, 3)), v=None, box=np.eye(3)), "cpu")
    for k in ("atoms", "length_a", "length_b", "mask"):
        assert torch.equal(getattr(back.lincs, k), getattr(ts.lincs, k))
    assert back.lincs.atoms.dtype == torch.int64


# -- the step's constraint term --------------------------------------------

def _two_atom_port():
    js, _, _ = _two_atom_system(0.30, 0.36)
    x = np.array([[1.0, 1.0, 1.0], [1.32, 1.0, 1.0]], np.float32)
    ts, tst = to_port(js, jtypes.make_state(x, np.zeros_like(x),
                                            np.eye(3) * 3.0))
    lam = torch.zeros(7)
    lam[int(ttypes.FepCoupling.BONDED)] = 0.25
    return ts, tst.replace(lam=lam)


@pytest.mark.parametrize("flavor", ["F", "E"])
def test_constraint_dvdl_only_on_energy_steps(flavor):
    """The multipliers' dV/dlambda joins the bonded column on energy
    steps; a force-only step's dV/dlambda stays NaN, as the force pass
    leaves it."""
    ts, tst = _two_atom_port()
    tp = md_params(ttypes, dt=0.002, nstcomm=0, fep=dict(enabled=True))
    nan7 = torch.full((7,), float("nan"))

    def force(x, box, lam, fl):
        terms = ttypes.EnergyTerms.zeros("cpu")
        return torch.zeros_like(x), (terms.replace(dvdl=nan7)
                                     if fl == "F" else terms)
    _, log = t_step_fn(ts, tp, force)(tst, flavor)
    b = int(ttypes.FepCoupling.BONDED)
    if flavor == "F":
        assert bool(torch.isnan(log.dvdl).all())
    else:
        assert abs(float(log.dvdl[b])) > 0.0
        assert float(log.dvdl.abs().sum() - log.dvdl[b].abs()) == 0.0


def test_constraint_term_in_delta_h():
    """On a sweep step each Delta H gains (lambda_bonded of the window -
    the current one) * the constraint dV/dlambda, the reference's linear
    term (enerdata_utils.cpp:338-347), here over a zero sweep."""
    ts, tst = _two_atom_port()
    tp = md_params(ttypes, dt=0.002, nstcomm=0, fep=dict(enabled=True))
    ladder = torch.zeros((3, 7))
    ladder[:, int(ttypes.FepCoupling.BONDED)] = torch.tensor([0.0, 0.25,
                                                              1.0])

    def force(x, box, lam, fl):
        return torch.zeros_like(x), ttypes.EnergyTerms.zeros("cpu")
    step = t_step_fn(ts, tp, force, foreign_delta_fn=lambda x, box, lam:
                     torch.zeros(3), n_foreign=3, all_lambda=ladder)
    _, log = step(tst, "D")
    dvdl_c = float(log.dvdl[int(ttypes.FepCoupling.BONDED)])
    np.testing.assert_allclose(log.delta_h.numpy(),
                               [-0.25 * dvdl_c, 0.0, 0.75 * dvdl_c],
                               rtol=1e-6)
    assert abs(dvdl_c) > 0.0
    with pytest.raises(ValueError, match="all_lambda"):
        t_step_fn(ts, tp, force, foreign_delta_fn=lambda x, box, lam:
                  torch.zeros(3), n_foreign=3)


# -- (f) the mdp reader ----------------------------------------------------

@pytest.mark.parametrize("text", [
    "constraints = h-bonds\nlincs-order = 6\nlincs_iter = 1",
    "constraints = All-Bonds\nlincs-iter = 3",
    "constraints = none", ""])
def test_mdp_constraint_keys_match_jax(text):
    """constraints, lincs-order and lincs-iter read as the JAX reader
    reads them."""
    from gromacs_fep_gpu_tpu.io import mdpio as jmdp
    p, _ = tmdp.mdp_to_params(text)
    q, _ = jmdp.mdp_to_params(text)
    assert (p.lincs_order, p.lincs_iter) == (q.lincs_order, q.lincs_iter)
    assert tmdp.mdp_extras(text)["constraints"] == \
        jmdp.mdp_extras(text)["constraints"]


@pytest.mark.parametrize("text,key", [
    ("constraints = h-angles", "constraints"),
    ("constraints = all-angles", "constraints"),
    ("constraints = h-bonds\nconstraint-algorithm = shake",
     "constraint-algorithm")])
def test_angle_constraints_and_shake_raise(text, key):
    """Angle constraints (which the JAX reader treats as none) and SHAKE
    raise NotImplementedError naming their key, in the mdp reader and in
    system_from_top."""
    with pytest.raises(NotImplementedError, match=f"mdp: {key} = "):
        tmdp.mdp_to_params(text)
    if key == "constraints":
        with pytest.raises(NotImplementedError, match=text.split()[-1]):
            ttopio.system_from_top(chip_smoke.ETH_TOP.format(nsol=0),
                                   constraints=text.split()[-1],
                                   device="cpu")


# -- domain decomposition: LINCS on the global arrays ----------------------

def test_dd_runner_constrains_on_global_arrays():
    """The solvation box with the 5-site ligand's four C-H bonds as LINCS
    rows (make_hbond_constraints(all_bonds=True), as chip_smoke's CHARMM
    path): the runner on a (2, 2, 2) grid of CPU domains keeps the
    constraints as the single-domain runner does (LINCS runs on the home
    device's global arrays, as SETTLE)."""
    lig = tsolv.methane_like_ligand(True)
    ttopio.make_hbond_constraints(lig, all_bonds=True)
    assert not lig.bonds and len(lig.constraints) == 4
    _, state = tsolv.solvation_system(n_side=8, seed=4, device="cpu")
    ref, _ = tsolv.solvation_system(n_side=8, seed=4, device="cpu")
    system = build_system([(lig, 1), (twater.tip3p_moltype(), 8 ** 3 - 1)],
                          ref.nbfp.numpy(), device="cpu")
    params = ttypes.MdParams(
        dt=0.002, nstlist=10, coulomb=ttypes.CoulombType.REACTION_FIELD,
        rcoulomb=0.28, rvdw=0.28, rlist=0.3, nstcomm=0,
        fep=ttypes.FepParams(enabled=True, sc_alpha=0.5, sc_coul=True))
    state = state.replace(lam=torch.full((7,), 0.5))
    s1, l1 = MdRunner(system, params, RunnerConfig(
        layout="table", nnbr=96)).run(state, 10)
    mesh = tmesh.make_mesh(n_ens=1, n_spatial=8, devices=["cpu"] * 8)
    dd = MdRunner(system, params, RunnerConfig(
        mesh=mesh, dd_block=4, dd_grid=(2, 2, 2), super_nnbr=128))
    assert dd.mesh is not None
    s2, l2 = dd.run(state, 10)
    np.testing.assert_allclose(s2.x.numpy(), s1.x.numpy(), atol=2e-3)
    ai, aj = system.lincs.atoms[:, 0], system.lincs.atoms[:, 1]
    for s in (s1, s2):
        r = torch.linalg.norm(s.x[ai] - s.x[aj], dim=-1)
        np.testing.assert_allclose(r.numpy(), 0.109, rtol=1e-4)
    rm1 = concat_logs(l1).constr_rmsd.numpy()
    np.testing.assert_allclose(concat_logs(l2).constr_rmsd.numpy(), rm1,
                               rtol=1e-2)


# -- (g) the CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def ethanol_cli(tmp_path_factory):
    """tests/test_torch_cli.py's shared ethanol directory: chip_smoke's
    ETH_MDP (sd, constraints = h-bonds, dt 2 fs) at window 2 in 1.6 nm of
    water, the port's t.tpz and the JAX CLI's 10-step run (jax.*), made
    once per test run for both files."""
    return cli_tests._once(tmp_path_factory, "torch_cli_ethanol",
                           cli_tests._make_ethanol)


def test_cli_hbonds_window_matches_jax_cli(ethanol_cli, monkeypatch):
    """The port's mdrun of the h-bonds ethanol window on the JAX CLI's sd
    draws (its key PRNGKey(1993) folded with the step): ener.csv and
    dhdl.xvg of all 10 steps and md.log's Constr. rmsd agree with the JAX
    CLI's; check -s counts the six LINCS rows, and each package's .tpz
    builds the other's six."""
    monkeypatch.chdir(ethanol_cli)
    n = cli_tests.NSTEPS
    key = jax.random.PRNGKey(1993)
    steps = iter(range(n))

    def jax_draws(shape, gen, dtype):
        k = jax.random.split(jax.random.fold_in(key, next(steps)), 3)[1]
        return t(jax.random.normal(k, shape, jnp.float32))
    monkeypatch.setattr(tinteg, "sd_draws", jax_draws)
    runner, state = tcli.main(["mdrun", "-s", "t.tpz", "-deffnm", "lincs",
                               "-fep", "gpu", "-nsteps", str(n)],
                              device="cpu")
    assert runner.system.lincs.atoms.shape[0] == 6 and state.step == n
    assert runner.params.dt == 0.002
    t_e, j_e = np.loadtxt("lincs.ener.csv"), np.loadtxt("jax.ener.csv")
    assert t_e.shape == j_e.shape == (n, 5)
    np.testing.assert_array_equal(np.isfinite(t_e), np.isfinite(j_e))
    on = np.isfinite(j_e)
    np.testing.assert_allclose(t_e[on], j_e[on], rtol=1e-4)
    (tg, tl), (jg, jl) = read_xvg("lincs.dhdl.xvg"), jread_xvg("jax.dhdl.xvg")
    assert tl[:3] == jl[:3] and tg.shape[0] == jg.shape[0] == 2
    for a, b in ((tg[:, 1:4], jg[:, 1:4]), (tg[:, 5:], jg[:, 4:])):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    (tn, tv), (jn, jv) = (cli_tests._log_block(Path(f).read_text())
                          for f in ("lincs.log", "jax.log"))
    assert tn == jn and "Constr. rmsd" in tn
    k = tn.index("Constr. rmsd")
    assert tv[k] > 0
    np.testing.assert_allclose(tv[k], jv[k], rtol=1e-3)
    pp = tcli.main(["check", "-s", "t.tpz"], device="cpu")
    assert pp.system.lincs.atoms.shape[0] == 6
    assert tcli._load_tpz("j.tpz", "cpu")[0].system.lincs.atoms.shape[0] == 6
    assert jcli._load_tpz("t.tpz")[0].system.lincs.atoms.shape[0] == 6
