"""The dense O(N^2) oracle of the port (ops/nonbonded_ref.py, ops/forces.py)
against the JAX package's.

Tolerances: float32 energies rel 1e-5 and forces 2e-5 of the largest force
(same formulas; the sums over N^2 pairs run in another order, and with PME
torch.fft stands in for the matmul DFT); dV/dlambda rel 1e-5, plus 1e-6 of
the largest energy term: with PME dV/dlambda_coul (-2.16) is a derivative of
the -10,959 kJ/mol reciprocal term, and either side's float32 value lies
2.5e-3 from the float64 one.  float64: 1e-10 (with PME 1e-9: the two
transforms differ in rounding only).  The JAX side is jitted: its eager
dispatch of the same function takes seven times as long.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core import topology as jtop
from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import forces as jforces
from gromacs_fep_gpu_tpu.ops import nonbonded_ref as jnb
from gromacs_fep_gpu_tpu.ops import pme as jpme
from gromacs_fep_gpu_tpu_torch.core import topology as ttop
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.ops import forces as tforces
from gromacs_fep_gpu_tpu_torch.ops import nonbonded_ref as tnb
from gromacs_fep_gpu_tpu_torch.ops import pme as tpme

from torch_bridge import t, to_port

LAM = np.array([0, 0, 0.4, 0.7, 0.3, 0, 0], np.float32)
ENERGY_FIELDS = ("lj", "coulomb", "coul_recip", "bonds", "angles")


def _params(coulomb, **kw):
    common = dict(rcoulomb=0.58, rvdw=0.58, **kw)
    fep = dict(enabled=True, sc_alpha=0.5, sc_coul=True, sc_sigma=0.3)
    grid = (12, 12, 12) if coulomb == "pme" else None
    jp = jtypes.MdParams(coulomb=jtypes.CoulombType(coulomb), pme_grid=grid,
                         fep=jtypes.FepParams(**fep), **common)
    tp = ttypes.MdParams(coulomb=ttypes.CoulombType(coulomb), pme_grid=grid,
                         fep=ttypes.FepParams(**fep), **common)
    return jp, tp


@pytest.mark.parametrize("coulomb", ["reaction-field", "pme"])
@pytest.mark.parametrize("double", [False, True])
def test_dense_force_fn_matches_jax(coulomb, double):
    """dense_energy's decomposition and make_dense_force_fn's forces and
    dV/dlambda on the 86-atom solvation box."""
    jax.config.update("jax_enable_x64", double)
    try:
        js, jst = solvation_system(n_side=3, spacing=0.4, seed=13)
        jp, tp = _params(coulomb)
        jdt = jnp.float64 if double else jnp.float32
        recip_j = (jpme.make_pme_recip_fn(js, jp) if coulomb == "pme"
                   else None)
        f_j, terms_j = jax.jit(jforces.make_dense_force_fn(js, jp, recip_j))(
            jst.x.astype(jdt), jst.box.astype(jdt), jnp.asarray(LAM, jdt))
        f_j = np.asarray(f_j)
        terms_j = {k: float(getattr(terms_j, k)) for k in ENERGY_FIELDS} | {
            "epot": float(terms_j.epot), "dvdl": np.asarray(terms_j.dvdl)}
    finally:
        jax.config.update("jax_enable_x64", False)

    ts, tst = to_port(js, jst)
    tdt = torch.float64 if double else torch.float32
    recip_t = (tpme.make_pme_recip_pair(ts, tp)[0] if coulomb == "pme"
               else None)
    f_t, terms_t = tforces.make_dense_force_fn(ts, tp, recip_t)(
        tst.x.to(tdt), tst.box.to(tdt), t(LAM, tdt))
    assert f_t.dtype == tdt and terms_t.epot.dtype == tdt
    if double:
        e_tol = f_tol = 1e-9 if coulomb == "pme" else 1e-10
        d_tol = e_tol
    else:
        e_tol, f_tol, d_tol = 1e-5, 2e-5, 1e-6
    scale = max(abs(terms_j[k]) for k in ENERGY_FIELDS)
    for k in ENERGY_FIELDS + ("epot",):
        np.testing.assert_allclose(float(getattr(terms_t, k)), terms_j[k],
                                   rtol=e_tol, atol=e_tol * scale, err_msg=k)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=f_tol * np.abs(f_j).max())
    dv_j = terms_j["dvdl"]
    np.testing.assert_allclose(terms_t.dvdl.numpy(), dv_j, rtol=e_tol,
                               atol=d_tol * scale)
    assert np.abs(dv_j[[2, 3]]).min() > 0


@pytest.mark.parametrize("modifier", ["none", "potential-shift",
                                      "force-switch", "potential-switch"])
def test_dense_nonbonded_modifiers_match_jax(modifier):
    """dense_nonbonded_energy under every vdW modifier (cut-off Coulomb),
    and the modifier's constants."""
    rng = np.random.RandomState(4)
    n, L = 40, 1.6
    x = rng.uniform(0, L, (n, 3)).astype(np.float32)
    box = (np.eye(3) * L).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    c6 = rng.uniform(1e-3, 3e-3, (n, n)).astype(np.float32)
    c6 = c6 + c6.T
    c12 = rng.uniform(1e-6, 3e-6, (n, n)).astype(np.float32)
    c12 = c12 + c12.T
    excl_idx = np.full((n, 2), -1, np.int64)
    excl_idx[::2, 0] = np.arange(1, n, 2)
    excl_idx[1::2, 0] = np.arange(0, n, 2)
    mask = 1.0 - np.eye(n, dtype=np.float32)
    kw = dict(rcoulomb=0.7, rvdw=0.7, rvdw_switch=0.55)
    jp = jtypes.MdParams(coulomb=jtypes.CoulombType.CUTOFF,
                         vdw_modifier=jtypes.VdwModifier(modifier), **kw)
    tp = ttypes.MdParams(coulomb=ttypes.CoulombType.CUTOFF,
                         vdw_modifier=ttypes.VdwModifier(modifier), **kw)
    ex_j = jnb.exclusion_matrix(jnp.asarray(excl_idx, jnp.int32), n)
    ex_t = tnb.exclusion_matrix(t(excl_idx), n)
    np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_j))
    ec_j, el_j = jnb.dense_nonbonded_energy(
        jnp.asarray(x), jnp.asarray(box), jnp.asarray(q), jnp.asarray(c6),
        jnp.asarray(c12), ex_j, jnp.asarray(mask), jp)
    ec_t, el_t = tnb.dense_nonbonded_energy(
        t(x), t(box), t(q), t(c6), t(c12), ex_t, t(mask), tp)
    np.testing.assert_allclose(float(ec_t), float(ec_j), rtol=1e-5)
    np.testing.assert_allclose(float(el_t), float(el_j), rtol=1e-5)
    np.testing.assert_allclose(tnb.vdw_shift_constants(tp),
                               jnb.vdw_shift_constants(jp), rtol=1e-12)
    np.testing.assert_allclose(tnb.rf_constants(tp), jnb.rf_constants(jp),
                               rtol=1e-12)
    assert tnb.forceswitch_constants(6.0, 0.55, 0.7) == \
        jnb.forceswitch_constants(6.0, 0.55, 0.7)


def _chain(top, device=None):
    """4-site chain with three bonds, one perturbed 1-4 pair and one plain
    pair (atoms 0-2, for the unperturbed branch)."""
    kw = {} if device is None else {"device": device}
    mol = top.MoleculeType(
        name="CH", types_a=[0, 0, 0, 0], charges_a=[0.3, -0.2, 0.1, -0.2],
        masses_a=[12.0] * 4, charges_b=[0.1, -0.2, 0.1, 0.0],
        bonds=[((i, i + 1), (0.15, 2.0e5)) for i in range(3)],
        pairs14=[((0, 3), (-0.06, 2.0e-3, 2.0e-6), (0.0, 0.0, 0.0)),
                 ((0, 2), (0.03, 1.0e-3, 1.0e-6))])
    nbfp = np.array([[[2.0e-3, 2.0e-6]]], np.float32)
    return top.build_system([(mol, 1)], nbfp, fudge_qq=0.5, **kw)


@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.35, 0.8)])
def test_pairs14_energy_matches_jax(lam):
    js, ts = _chain(jtop), _chain(ttop, "cpu")
    for k in ("atoms", "params_a", "params_b", "mask"):
        np.testing.assert_array_equal(getattr(ts.pairs14, k).numpy(),
                                      np.asarray(getattr(js.pairs14, k)))
    x = np.array([[0.5, 0.5, 0.5], [0.62, 0.55, 0.5], [0.7, 0.66, 0.55],
                  [0.82, 0.7, 0.62]], np.float32)
    box = (np.eye(3) * 2.0).astype(np.float32)
    jp, tp = _params("reaction-field")
    e_j = jforces.pairs14_energy(jnp.asarray(x), jnp.asarray(box), js,
                                 lam[0], lam[1], jp)
    e_t = tforces.pairs14_energy(t(x), t(box), ts, torch.tensor(lam[0]),
                                 torch.tensor(lam[1]), tp)
    for a, b in zip(e_t, e_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_pairs14_lambda_axis_matches_scalar_calls():
    """An (L,) lambda vector gives, row by row, the scalar calls' values."""
    ts = _chain(ttop, "cpu")
    x = t(np.array([[0.5, 0.5, 0.5], [0.62, 0.55, 0.5], [0.7, 0.66, 0.55],
                    [0.82, 0.7, 0.62]], np.float32))
    box = torch.eye(3) * 2.0
    _, tp = _params("reaction-field")
    lc, lv = torch.tensor([0.0, 0.35, 1.0]), torch.tensor([0.0, 0.8, 1.0])
    e_b = tforces.pairs14_energy(x, box, ts, lc, lv, tp)
    for i in range(3):
        e_i = tforces.pairs14_energy(x, box, ts, lc[i], lv[i], tp)
        for a, b in zip(e_b, e_i):
            assert a.shape == (3,)
            torch.testing.assert_close(a[i], b, rtol=1e-6, atol=1e-7)


def test_dense_group_energies_sum_to_dense_energy():
    """The (G, G) energy-group matrices of two groups covering all atoms
    add up to dense_energy's short-range terms, and match the JAX
    package's."""
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=2)
    jp, tp = _params("reaction-field")
    groups = [np.arange(5), np.arange(5, js.n_atoms)]
    ec_j, el_j = jax.jit(lambda x, box, lam: jforces.dense_group_energies(
        x, box, lam, js, jp, groups))(jst.x, jst.box, jnp.asarray(LAM))
    ts, tst = to_port(js, jst)
    ec_t, el_t = tforces.dense_group_energies(tst.x, tst.box, t(LAM), ts,
                                              tp, groups)
    for a, b in ((ec_t, ec_j), (el_t, el_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    terms = tforces.dense_energy(tst.x, tst.box, t(LAM), ts, tp)
    np.testing.assert_allclose(float(ec_t.sum()), float(terms.coulomb),
                               rtol=1e-5)
    np.testing.assert_allclose(float(el_t.sum()), float(terms.lj), rtol=1e-5)
