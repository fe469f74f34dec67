"""The listed (bonded) terms of ops/bonded.py against the JAX package's,
and their lambda routing on the port's three force routes.

Each of the twelve terms gets a list of rows built with numpy from a seed
(random A and B parameters, a B multiplicity that differs from A's where
the term has one) on a frame whose dihedrals sit 0.1 degree from planar
(phi near 0 and near +-180, on both sides) besides random ones.  Energy,
the autograd force and dV/dlambda are held against jax.value_and_grad at
a scalar lambda and, over an (L,) ladder, against jax.vmap of it.

Tolerances (float32 on both sides, the same formulas): energies and
dV/dlambda rel 1e-5 (of the largest entry of a ladder; angres's
dV/dlambda at lambda 0.3 reads 4e-6), forces 2e-5 of max |F| per lambda,
tightened from the usual 1e-4 (the worst, angres, reads 1.6e-6).  The
routing tests hold dvdl[BONDED] and dvdl[RESTRAINT] of the dense route
against JAX's dense force at rel 1e-5, the port's cluster route against
its dense route at rel 1e-5 (energies) and 1e-4 of max |F|, and the
foreign sweep over a ladder with bonded and restraint columns against
JAX's at 1e-5 of max |Delta H|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import bonded as jbonded
from gromacs_fep_gpu_tpu.ops import foreign as jforeign
from gromacs_fep_gpu_tpu.ops import forces as jforces
from gromacs_fep_gpu_tpu.ops.pairlist import build_fep_pairlist
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.core.types import FepCoupling as FC
from gromacs_fep_gpu_tpu_torch.ops import bonded as tbonded
from gromacs_fep_gpu_tpu_torch.ops import forces as tforces
from gromacs_fep_gpu_tpu_torch.ops import foreign as tforeign
from gromacs_fep_gpu_tpu_torch.ops.cluster_nb import make_cluster_force_fn
from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import prepare_v2u
from gromacs_fep_gpu_tpu_torch.ops.pairlist import (FepPairlist,
                                                    build_cluster_pairlist)

from torch_bridge import t, to_port

BOX = 2.0
LADDER = np.array([0.0, 0.3, 0.55, 1.0], np.float32)
PHIS = (0.1, -0.1, 179.9, -179.9, 60.0, -120.0)     # degrees
E_REL, F_REL = 1e-5, 2e-5


def _dihedral_quad(rng, phi_deg):
    """Four positions whose dihedral is phi_deg, rotated and placed at
    random inside the box."""
    phi = np.radians(phi_deg)
    b, c = np.zeros(3), np.array([0.15, 0.0, 0.0])
    a = b + 0.11 * np.array([-np.cos(0.4), np.sin(0.4), 0.0])
    d = c + 0.12 * np.array([np.cos(0.5), np.sin(0.5) * np.cos(phi),
                             np.sin(0.5) * np.sin(phi)])
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return np.stack([a, b, c, d]) @ q.T + rng.uniform(0.3, BOX - 0.3, 3)


def _frame(rng):
    """(x (N, 3), quads (len(PHIS) + 2, 4)): PHIS's near-planar and random
    quads, then loose atoms."""
    quads = [_dihedral_quad(rng, p) for p in PHIS]
    quads += [_dihedral_quad(rng, p) for p in rng.uniform(-180, 180, 2)]
    x = np.concatenate(quads + [rng.uniform(0.0, BOX, (12, 3))])
    idx = np.arange(4 * len(quads)).reshape(-1, 4)
    return x.astype(np.float32), idx


def _rows(name, rng, x, quads):
    """(atoms, params_a, params_b, mask) of term `name`, one masked row
    last."""
    n_at = x.shape[0]
    u = rng.uniform
    if name in ("pdihs", "rbdihs", "idihs", "dihres", "angres"):
        atoms = quads
    elif name in ("angles", "ub"):
        atoms = np.concatenate([quads[:, :3], quads[:, 1:]])
    elif name in ("bonds", "restrbonds", "disres"):
        atoms = np.stack([rng.permutation(n_at)[:2] for _ in range(10)])
    else:   # posres, fbposres: one atom per row
        atoms = rng.permutation(n_at)[:10, None]
    n = atoms.shape[0]

    def both(fn):
        return fn(), fn()
    if name == "bonds":
        pa, pb = both(lambda: np.stack([u(0.1, 1.2, n), u(1e3, 5e3, n)], 1))
    elif name == "angles":
        pa, pb = both(lambda: np.stack([u(80, 130, n), u(200, 500, n)], 1))
    elif name == "ub":
        pa, pb = both(lambda: np.stack([u(80, 130, n), u(200, 500, n),
                                        u(0.15, 0.3, n), u(1e3, 2e4, n)], 1))
    elif name == "pdihs":
        pa, pb = both(lambda: np.stack([u(-180, 180, n), u(1, 10, n),
                                        rng.integers(1, 5, n)], 1))
    elif name == "rbdihs":
        pa, pb = both(lambda: u(-5, 5, (n, 6)))
    elif name == "idihs":
        pa, pb = both(lambda: np.stack([u(-180, 180, n), u(5, 50, n)], 1))
    elif name == "dihres":
        pa, pb = both(lambda: np.stack([u(-180, 180, n), u(0, 40, n),
                                        u(5, 50, n)], 1))
    elif name == "angres":
        pa, pb = both(lambda: np.stack([u(0, 180, n), u(5, 50, n),
                                        rng.integers(1, 4, n)], 1))
    elif name == "restrbonds":
        def rb():
            low = u(0.2, 0.9, n)
            up1 = low + u(0.0, 0.4, n)
            return np.stack([low, up1, up1 + u(0.05, 0.4, n),
                             u(1e2, 1e3, n)], 1)
        pa, pb = both(rb)
    elif name == "posres":
        pa, pb = both(lambda: np.concatenate(
            [x[atoms[:, 0]] + u(-0.2, 0.2, (n, 3)), u(100, 2000, (n, 3))],
            1))
    elif name == "fbposres":
        geom = np.array([1, 3, 4, 5, 6, 7, 8, 1, 6, 3])[:n]
        r = u(0.02, 0.15, n) * np.where(np.arange(n) % 3 == 2, -1, 1)
        pa = np.concatenate([geom[:, None], x[atoms[:, 0]]
                             + u(-0.2, 0.2, (n, 3)), r[:, None],
                             u(100, 2000, (n, 1))], 1)
        pb = pa
    elif name == "disres":
        label = np.array([0, 0, 1, 2, 2, 2, 3, 4, 4, 1])[:n]

        def dr():
            b = u(0.0, 1.2, (5, 3))
            b.sort(1)                       # lo <= up1 <= up2 per label
            return np.concatenate([b[label], u(0.5, 2.0, (n, 1)),
                                   label[:, None]], 1)
        pa, pb = both(dr)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return (atoms.astype(np.int32), pa.astype(np.float32),
            pb.astype(np.float32), mask)


NAMES = sorted(tbonded.TERMS)


@pytest.mark.parametrize("name", NAMES)
def test_term_matches_jax(name):
    assert set(NAMES) == set(jbonded.TERMS)
    rng = np.random.default_rng(NAMES.index(name) + 11)
    x, quads = _frame(rng)
    atoms, pa, pb, mask = _rows(name, rng, x, quads)
    box = np.eye(3, dtype=np.float32) * BOX
    jil = jtypes.InteractionList(atoms=jnp.asarray(atoms),
                                 params_a=jnp.asarray(pa),
                                 params_b=jnp.asarray(pb),
                                 mask=jnp.asarray(mask))
    til = ttypes.InteractionList(atoms=t(atoms, torch.int64), params_a=t(pa),
                                 params_b=t(pb), mask=t(mask))
    fc = 800.0
    jfn = jbonded.TERMS[name][2]

    def e_j(xx, lam):
        if name == "disres":
            return jfn(xx, jnp.asarray(box), jil, lam, fc)
        return jfn(xx, jnp.asarray(box), jil, lam)

    @jax.jit
    def jax_all(xx):
        e, (gx, gl) = jax.value_and_grad(e_j, argnums=(0, 1))(xx, 0.3)
        lad = jnp.asarray(LADDER)
        el = jax.vmap(lambda l: e_j(xx, l))(lad)
        gxl, gll = jax.vmap(lambda l: jax.grad(e_j, argnums=(0, 1))(xx, l)
                            )(lad)
        return e, gx, gl, el, gxl, gll

    e, gx, gl, el, gxl, gll = (np.asarray(a) for a in
                               jax_all(jnp.asarray(x)))

    def e_t(xx, lam):
        if name == "disres":
            return tbonded.disres_energy(xx, t(box), til, lam, fc)
        return tbonded.TERMS[name](xx, t(box), til, lam)

    # scalar lambda
    xt = t(x).requires_grad_(True)
    lt = torch.tensor(0.3, requires_grad=True)
    et = e_t(xt, lt)
    assert et.shape == ()
    gxt, glt = torch.autograd.grad(et, [xt, lt], allow_unused=True)
    glt = torch.zeros(()) if glt is None else glt
    assert abs(float(e)) > 0.0
    np.testing.assert_allclose(float(et.detach()), e, rtol=E_REL,
                               atol=E_REL * abs(float(e)))
    np.testing.assert_allclose(gxt.numpy(), gx, rtol=0,
                               atol=F_REL * np.abs(gx).max())
    np.testing.assert_allclose(float(glt), gl, rtol=0,
                               atol=E_REL * max(abs(float(gl)),
                                                abs(float(e))))
    # the (L,) ladder in one pass
    lt = t(LADDER).requires_grad_(True)
    elt = e_t(xt, lt)
    assert elt.shape == LADDER.shape
    np.testing.assert_allclose(elt.detach().numpy(), el, rtol=0,
                               atol=E_REL * np.abs(el).max())
    (gll_t,) = torch.autograd.grad(elt.sum(), [lt], retain_graph=True,
                                   allow_unused=True)
    gll_t = torch.zeros(len(LADDER)) if gll_t is None else gll_t
    np.testing.assert_allclose(gll_t.numpy(), gll, rtol=0,
                               atol=E_REL * max(np.abs(gll).max(),
                                                np.abs(el).max()))
    for k in range(len(LADDER)):
        (gxk,) = torch.autograd.grad(elt[k], [xt], retain_graph=True)
        np.testing.assert_allclose(gxk.numpy(), gxl[k], rtol=0,
                                   atol=F_REL * np.abs(gxl[k]).max())
    if name == "fbposres":
        assert np.all(gll == 0.0) and float(gll_t.abs().max()) == 0.0


def test_dihedral_sign_near_planar_matches_jax():
    """The sign of phi (r_ij . n < 0) 0.1 degree either side of 0 and 180
    degrees, as JAX gives it."""
    rng = np.random.default_rng(5)
    x, quads = _frame(rng)
    box = np.eye(3, dtype=np.float32) * BOX
    phi_t = tbonded.dihedral_angle(t(x), t(box), t(quads, torch.int64))
    phi_j = jbonded.dihedral_angle(jnp.asarray(x), jnp.asarray(box),
                                   jnp.asarray(quads))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(np.degrees(phi_t.numpy()[:len(PHIS)]), PHIS,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# lambda routing: restraints at lambda_restraint, the rest at lambda_bonded
# ---------------------------------------------------------------------------

RLIST = 0.6
L = 5


def _ladder():
    """(L, 7) ladder with distinct bonded and restraint columns."""
    lam = np.zeros((L, int(FC.COUNT)), np.float32)
    lam[:, FC.COUL] = np.linspace(0, 1, L)
    lam[:, FC.VDW] = np.linspace(0, 1, L) ** 2
    lam[:, FC.BONDED] = [0.0, 0.4, 0.4, 0.8, 1.0]
    lam[:, FC.RESTRAINT] = [1.0, 0.9, 0.25, 0.25, 0.0]
    return lam


def _ligand_terms():
    """A pdih, an RB dihedral, an improper, a posres, a dihres and a
    restraint bond on the 5-site ligand (atoms 0-4), A != B."""
    rows = {
        "pdihs": ([[1, 0, 2, 3]], [[30.0, 4.0, 3]], [[50.0, 1.0, 2]]),
        "rbdihs": ([[3, 0, 2, 4]], [[1.0, -2.0, 0.5, 1.5, 0.0, 0.0]],
                   [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]),
        "idihs": ([[0, 1, 2, 4]], [[10.0, 20.0]], [[-5.0, 40.0]]),
        "posres": ([[0], [3]], [[0.2, 0.3, 0.4, 500.0, 600.0, 700.0],
                                [0.5, 0.5, 0.5, 100.0, 100.0, 100.0]],
                   [[0.25, 0.3, 0.35, 900.0, 600.0, 100.0],
                    [0.5, 0.5, 0.5, 0.0, 0.0, 0.0]]),
        "dihres": ([[1, 0, 2, 3]], [[0.0, 10.0, 30.0]],
                   [[90.0, 5.0, 80.0]]),
        "restrbonds": ([[1, 4]], [[0.05, 0.08, 0.12, 900.0]],
                       [[0.05, 0.07, 0.09, 1500.0]]),
    }
    out = {}
    for name, (a, pa, pb) in rows.items():
        out[name] = jtypes.InteractionList(
            atoms=jnp.asarray(a, jnp.int32),
            params_a=jnp.asarray(pa, jnp.float32),
            params_b=jnp.asarray(pb, jnp.float32),
            mask=jnp.ones((len(a),), jnp.float32))
    return out


@pytest.fixture(scope="module")
def restrained():
    """JAX's 5-site solvation ligand in a small water box, with the
    ligand's bonds and angles and the terms of _ligand_terms; the port's
    copy, its FEP list, and the reaction-field parameters of both."""
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=13)
    rng = np.random.RandomState(4)
    jst = jst.replace(x=jst.x.at[:5].add(
        jnp.asarray(rng.normal(0, 0.02, (5, 3)), jnp.float32)))
    js = js.replace(bonded=dict(js.bonded, **_ligand_terms()))
    common = dict(rcoulomb=0.58, rvdw=0.58, rlist=RLIST)
    fep = dict(enabled=True, sc_alpha=0.5, sc_coul=True, sc_sigma=0.3)
    jp = jtypes.MdParams(coulomb=jtypes.CoulombType.REACTION_FIELD,
                         fep=jtypes.FepParams(**fep), **common)
    tp = ttypes.MdParams(coulomb=ttypes.CoulombType.REACTION_FIELD,
                         fep=ttypes.FepParams(**fep), **common)
    pert = np.where(np.asarray(js.perturbed))[0]
    jfl = build_fep_pairlist(jst.x, jst.box, js, RLIST, pert, max_nbr=128)
    ts, tst = to_port(js, jst)
    tfl = FepPairlist(iidx=t(jfl.iidx, torch.int64),
                      jidx=t(jfl.jidx, torch.int64), included=t(jfl.included),
                      excluded=t(jfl.excluded), n_overflow=t(jfl.n_overflow))
    return js, jst, jp, jfl, ts, tst, tp, tfl


@pytest.mark.parametrize("window", [1, 3])
def test_restraint_routing_dense_matches_jax(restrained, window):
    js, jst, jp, _, ts, tst, tp, _ = restrained
    lam = _ladder()[window]
    f_j, terms_j = jax.jit(jforces.make_dense_force_fn(js, jp))(
        jst.x, jst.box, jnp.asarray(lam))
    f_t, terms_t = tforces.make_dense_force_fn(ts, tp)(tst.x, tst.box,
                                                       t(lam))
    dv_j, dv_t = np.asarray(terms_j.dvdl), terms_t.dvdl.numpy()
    for c in (FC.BONDED, FC.RESTRAINT):
        assert abs(dv_j[c]) > 1.0, c
        np.testing.assert_allclose(dv_t[c], dv_j[c], rtol=1e-5)
    for ch in ("dihedrals", "impropers", "restraints", "bonds", "angles"):
        np.testing.assert_allclose(float(getattr(terms_t, ch)),
                                   float(getattr(terms_j, ch)), rtol=1e-5)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=1e-4 * np.abs(f_j).max())


def test_restraint_routing_foreign_matches_jax(restrained):
    js, jst, jp, jfl, ts, tst, tp, tfl = restrained
    lad = _ladder()
    core = jforeign.make_foreign_delta_fn(js, jp, jnp.asarray(lad))
    dh_j = np.asarray(jax.jit(lambda lam: core(jst.x, jst.box, lam, jfl))(
        jnp.asarray(lad[2])))
    dh_t = tforeign.make_foreign_delta_fn(ts, tp, lad)(
        tst.x, tst.box, t(lad[2]), tfl).numpy()
    np.testing.assert_allclose(dh_t, dh_j, rtol=0,
                               atol=1e-5 * np.abs(dh_j).max())
    # the sweep's restraint part moves with lambda_restraint alone
    e_lam = tforeign.make_lambda_energy_fn(ts, tp)
    only_r = lad[[2, 2]].copy()
    only_r[1, FC.RESTRAINT] = 0.9
    e = e_lam(tst.x, tst.box, t(only_r), tfl)
    r = ts.bonded
    want = sum(tbonded.listed_energy(n, tst.x, tst.box, r[n], t(only_r))
               for n in ("posres", "dihres", "restrbonds"))
    np.testing.assert_allclose(float(e[1] - e[0]), float(want[1] - want[0]),
                               rtol=1e-5)


def test_restraint_routing_cluster_matches_dense(restrained):
    """The port's cluster route (the table layout, the v2u layout) against
    its dense route on the same system and lambda vector."""
    *_, ts, tst, tp, tfl = restrained
    lam = t(_ladder()[3])
    f_d, terms_d = tforces.make_dense_force_fn(ts, tp)(tst.x, tst.box, lam)
    nl = build_cluster_pairlist(tst.x, tst.box, ts, RLIST, nnbr=0,
                                super_nnbr=128)
    ff = make_cluster_force_fn(ts, tp, layout="v2u")
    f_c, terms_c = ff(tst.x, tst.box, lam, nl, tfl,
                      prepare_v2u(nl, ts.nbfp))
    np.testing.assert_allclose(terms_c.dvdl.numpy(), terms_d.dvdl.numpy(),
                               rtol=1e-5, atol=1e-5 * float(
                                   terms_d.dvdl.abs().max()))
    for ch in ("dihedrals", "impropers", "restraints"):
        np.testing.assert_allclose(float(getattr(terms_c, ch)),
                                   float(getattr(terms_d, ch)), rtol=1e-5)
    np.testing.assert_allclose(f_c.numpy(), f_d.numpy(), rtol=0,
                               atol=1e-4 * float(f_d.abs().max()))
