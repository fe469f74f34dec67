"""The per-cluster pair-list route: the per-cluster list and its baked
shifts, the table route (the XLA cluster_nb_kernel's counterpart), the
K7a/K7b/K7c plain versions and the layout demotion, the port against the
JAX package on identical inputs.

Tolerances: energies rel 1e-5, forces 2e-5 of the largest force and the
virial 2e-5 of its largest component, as tests/test_torch_nb.py holds K1:
both sides run the same fp32 formulas and differ in summation order (K7a/b/c
also in the erfc polynomial and the pmecorrF fit, which the TPU kernels use
and the XLA reference does not).  The per-cluster list must agree exactly:
the neighbour order, the shifts of each entry and every flag.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core import topology as jtop
from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.md import verletbuf as jverletbuf
from gromacs_fep_gpu_tpu.md.runner import MdRunner as JRunner
from gromacs_fep_gpu_tpu.md.runner import RunnerConfig as JConfig
from gromacs_fep_gpu_tpu.md.runner import concat_logs as j_concat
from gromacs_fep_gpu_tpu.models import solvation as jsolv
from gromacs_fep_gpu_tpu.models import water as jwater
from gromacs_fep_gpu_tpu.ops.cluster_nb import cluster_nb_kernel as j_kernel
from gromacs_fep_gpu_tpu_torch.core import topology as ttop
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.md import verletbuf as tverletbuf
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs as t_concat
from gromacs_fep_gpu_tpu_torch.models import solvation as tsolv
from gromacs_fep_gpu_tpu_torch.models import water as twater
from gromacs_fep_gpu_tpu_torch.ops import cluster_nb as tcnb
from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
from gromacs_fep_gpu_tpu_torch.ops import pairlist as tpl
from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants

from torch_bridge import (jax_cluster_list, md_params, port_cluster_list,
                          t, to_port)

RLIST = 0.55
CUT = dict(rcoulomb=0.5, rvdw=0.5, rlist=RLIST, rvdw_switch=0.4)
MODIFIERS = ("none", "potential-shift", "force-switch", "potential-switch")


def lb_table(top, solv, water):
    """The solvation model's sigma/epsilon under Lorentz-Berthelot, with
    the model's zeroed rows (water H, dummy type)."""
    sigma = [water.O_SIGMA, 0.1, solv.LIG_C_SIGMA, solv.LIG_H_SIGMA, 0.1]
    eps = [water.O_EPS, 0.0, solv.LIG_C_EPS, solv.LIG_H_EPS, 0.0]
    nbfp = top.lj_table_from_sigma_eps(sigma, eps, comb_rule=2)
    for k in (1, 4):
        nbfp[k, :, :] = 0.0
        nbfp[:, k, :] = 0.0
    return nbfp


def lb_system(n_side, decouple=True):
    """The JAX solvation system with the Lorentz-Berthelot table, built
    from the public builders, and its state.  decouple=False keeps the
    ligand unperturbed, so that its mixed C/H-water pairs reach the
    non-bonded kernel's table."""
    _, state = jsolv.solvation_system(n_side=n_side, seed=3)
    system = jtop.build_system(
        [(jsolv.methane_like_ligand(decouple), 1),
         (jwater.tip3p_moltype(), n_side ** 3 - 1)],
        lb_table(jtop, jsolv, jwater))
    return system, state


@pytest.fixture(scope="module")
def lists():
    """n_side 8 (2.48 nm: at rlist 0.55 every per-cluster shift is
    valid), the ligand
    unperturbed: the per-cluster list with shifts and the union list of
    8-cluster blocks, both sides."""
    js, jst = lb_system(8, decouple=False)
    ts, tst = to_port(js, jst)
    jl = jax_cluster_list(jst.x, jst.box, js, RLIST, nnbr=96,
                          compute_shifts=True)
    tl = tpl.build_cluster_pairlist(tst.x, tst.box, ts, RLIST, nnbr=96,
                                    compute_shifts=True)
    jl8 = jax_cluster_list(jst.x, jst.box, js, RLIST, nnbr=0,
                           super_nnbr=320, super_block=8)
    tl8 = tpl.build_cluster_pairlist(tst.x, tst.box, ts, RLIST,
                                     super_nnbr=320, super_block=8)
    return js, jst, ts, tst, jl, tl, jl8, tl8


def test_lb_table_is_table_mode(lists):
    js = lists[0]
    assert tcnb.lj_table_mode(np.asarray(js.nbfp)) == "table"


def test_per_cluster_list_matches_jax(lists):
    _, _, _, _, jl, tl, _, _ = lists
    np.testing.assert_array_equal(tl.nbr.numpy(), np.asarray(jl.nbr))
    np.testing.assert_array_equal(tl.nbr_mask.numpy(),
                                  np.asarray(jl.nbr_mask))
    valid = tl.nbr.numpy() < tl.n_clusters
    np.testing.assert_array_equal(tl.nbr_shift.numpy()[valid],
                                  np.asarray(jl.nbr_shift)[valid])
    np.testing.assert_array_equal(tl.img.numpy(), np.asarray(jl.img))
    for k in ("n_overflow", "max_count", "shift_overflow"):
        assert int(getattr(tl, k)) == int(getattr(jl, k)), k
    assert int(tl.shift_overflow) == 0 and int(tl.n_overflow) == 0


def test_union8_list_matches_jax(lists):
    _, _, _, _, _, _, jl8, tl8 = lists
    C = tl8.n_clusters

    def sets(nbr):
        return [{int(j) for j in row if j < C} for row in nbr]
    assert sets(tl8.nbr_super.numpy()) == sets(np.asarray(jl8.nbr_super))
    for k in ("super_overflow", "super_max_count"):
        assert int(getattr(tl8, k)) == int(getattr(jl8, k)), k


def test_per_cluster_overflow_and_shift_flags(lists):
    """Capacity short and a list reaching past what per-entry shifts can
    hold at this box (rlist 0.65 on 2.48 nm): the same overflow count,
    largest need and shift_overflow count."""
    js, jst, ts, tst = lists[:4]
    jl = jax_cluster_list(jst.x, jst.box, js, 0.65, nnbr=80,
                          compute_shifts=True)
    tl = tpl.build_cluster_pairlist(tst.x, tst.box, ts, 0.65, nnbr=80,
                                    compute_shifts=True)
    for k in ("n_overflow", "max_count", "shift_overflow"):
        assert int(getattr(tl, k)) == int(getattr(jl, k)) > 0, k


@pytest.mark.parametrize("coulomb", ["pme", "reaction-field"])
@pytest.mark.parametrize("modifier", MODIFIERS)
@pytest.mark.parametrize("lj_mode", ["table", "geometric"])
def test_cluster_nb_kernel_matches_jax(lists, lj_mode, modifier, coulomb):
    """The table route's plain version (cluster_nb_kernel) against the XLA
    kernel, forces, energies and the diagonal virial.  Geometric mode runs
    on the solvation model's own (geometric) table."""
    js, jst, ts, tst, jl, _, _, _ = lists
    nbfp = js.nbfp if lj_mode == "table" else jsolv.solvation_system(
        n_side=3)[0].nbfp
    jp = md_params(jtypes, coulomb=coulomb, vdw_modifier=modifier, **CUT)
    tp = md_params(ttypes, coulomb=coulomb, vdw_modifier=modifier, **CUT)
    beta = 5.0 if coulomb == "pme" else None
    f_j, ec_j, el_j, v_j = j_kernel(jst.x, jst.box, jl, nbfp, jp, beta,
                                    lj_mode=lj_mode, compute_virial=True)
    f_t, ec_t, el_t, v_t = tcnb.cluster_nb_kernel(
        tst.x, tst.box, port_cluster_list(jl, jl.n_clusters), t(nbfp), tp,
        beta, lj_mode=lj_mode, compute_virial=True)
    f_j, v_j = np.asarray(f_j), np.asarray(v_j)
    np.testing.assert_allclose(f_t.numpy(), f_j,
                               atol=2e-5 * np.abs(f_j).max())
    np.testing.assert_allclose(float(ec_t), float(ec_j), rtol=1e-5)
    np.testing.assert_allclose(float(el_t), float(el_j), rtol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), v_j,
                               atol=2e-5 * np.abs(v_j).max())


@pytest.fixture(scope="module")
def geometric_reference(lists):
    """JAX's XLA kernel on the geometric table, potential shift, for each
    Coulomb type: the reference JAX's own tests hold the Pallas kernels
    to."""
    _, jst, _, _, jl, _, _, _ = lists
    nbfp = jsolv.solvation_system(n_side=3)[0].nbfp
    out = {}
    for coulomb in ("pme", "reaction-field"):
        jp = md_params(jtypes, coulomb=coulomb, **CUT)
        f, ec, el = j_kernel(jst.x, jst.box, jl, nbfp, jp,
                             5.0 if coulomb == "pme" else None,
                             lj_mode="geometric")
        out[coulomb] = (np.asarray(f), float(ec), float(el))
    return nbfp, out


@pytest.mark.parametrize("coulomb", ["pme", "reaction-field"])
@pytest.mark.parametrize("energy", [True, False], ids=["VF", "F"])
@pytest.mark.parametrize("layout", ["super", "cluster", "v2"])
def test_k7_plain_matches_jax(lists, geometric_reference, layout, energy,
                              coulomb):
    """K7a (union of 8), K7b (per-cluster, minimum image) and K7c
    (per-cluster, baked shifts, lane masks) in their force and energy
    flavours against the XLA kernel."""
    _, _, ts, tst, _, tl, _, tl8 = lists
    nbfp, ref = geometric_reference
    f_j, ec_j, el_j = ref[coulomb]
    nlist = tl8 if layout == "super" else tl
    prep = nb_cluster.PREPARE[layout](nlist, t(nbfp))
    tp = md_params(ttypes, coulomb=coulomb, **CUT)
    consts = NbConstants.from_params(tp, 5.0 if coulomb == "pme" else None)
    f_t, ec_t, el_t = nb_cluster.cluster_forces(tst.x, tst.box, nlist, prep,
                                                consts, compute_energy=energy)
    np.testing.assert_allclose(f_t.numpy(), f_j,
                               atol=2e-5 * np.abs(f_j).max())
    if energy:
        np.testing.assert_allclose(float(ec_t), ec_j, rtol=1e-5)
        np.testing.assert_allclose(float(el_t), el_j, rtol=1e-5)


def test_cuda_tensor_never_takes_plain_path(lists, monkeypatch):
    """A non-CPU tensor reaches the kernel wrapper (which builds and
    launches, or raises), never a plain version."""
    _, _, ts, _, _, tl, _, _ = lists
    prep = nb_cluster.prepare_cluster(tl, ts.nbfp)
    called = []
    for name in ("k7_plain", "table_plain"):
        monkeypatch.setattr(nb_cluster, name,
                            lambda *a, **k: called.append(1))
    monkeypatch.setattr(nb_cluster, "nb_cluster_cuda",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("cuda path")))
    fake = torch.empty((8,), device="meta")
    with pytest.raises(RuntimeError, match="cuda path"):
        nb_cluster.nb_cluster_forces([fake] * 3, None, prep, None, True)
    assert not called


def _port_params(**kw):
    base = dict(dt=0.001, nstlist=5, coulomb="pme", nstcalcenergy=5,
                fep=dict(enabled=True, sc_alpha=0.5, sc_coul=True,
                         nstdhdl=5))
    base.update(kw)
    return md_params(ttypes, **base)


def test_layout_demotion_matches_jax_rule():
    """Geometric LJ with potential shift stays on the chosen layout; a
    Lorentz-Berthelot table or force-switch demotes to the table route
    (JAX drops use_pallas there); LJ-PME raises; pressure coupling on a K7
    layout raises."""
    ts, tst = tsolv.solvation_system(n_side=4, device="cpu")
    grid = (16, 16, 16)
    lb = torch.as_tensor(lb_table(ttop, tsolv, twater))
    ts_lb = dataclasses.replace(ts, nbfp=lb)
    geo = ts.nbfp.numpy()
    for layout in ("v2u", "super", "cluster", "v2", "table"):
        p = _port_params(pme_grid=grid, rcoulomb=0.5, rvdw=0.5, rlist=0.5)
        assert tcnb.effective_layout(geo, p, layout) == layout
        assert tcnb.effective_layout(lb.numpy(), p, layout) == "table"
        fsw = p.replace(vdw_modifier=ttypes.VdwModifier.FORCE_SWITCH,
                        rvdw_switch=0.4)
        assert tcnb.effective_layout(geo, fsw, layout) == "table"
        with pytest.raises(NotImplementedError):
            tcnb.effective_layout(geo, p.replace(vdw_type="pme"), layout)
        runner = MdRunner(ts_lb, p, RunnerConfig(layout=layout))
        assert runner.layout == "table"
        assert runner.config.layout == layout
    npt = _port_params(pme_grid=grid, rcoulomb=0.5, rvdw=0.5, rlist=0.5,
                       pcoupl="c-rescale")
    for layout in ("super", "cluster", "v2"):
        with pytest.raises(NotImplementedError):
            MdRunner(ts, npt, RunnerConfig(layout=layout))
    # the table route and v2u carry the virial flavour: 'R' steps
    for layout in ("v2u", "table"):
        runner = MdRunner(ts, npt, RunnerConfig(layout=layout))
        assert runner._flavor_pattern(0, 10).count("R") == 1


def test_v2_layout_raises_where_shifts_do_not_hold():
    """A box too small for per-entry shifts: the v2 layout fails hard, as
    the JAX runner does (the v2u layout falls back to the in-loop minimum
    image instead)."""
    ts, tst = tsolv.solvation_system(n_side=4, device="cpu")
    p = _port_params(pme_grid=(16, 16, 16), rcoulomb=0.5, rvdw=0.5,
                     rlist=0.5)
    with pytest.raises(RuntimeError, match="build-time periodic shifts"):
        MdRunner(ts, p, RunnerConfig(layout="v2")).run(tst, 1)


def test_dense_potential_switch_forces_match_table_route():
    """The dense oracle's forces under potential-switch are finite and
    agree with the table route's (rel 1e-4 of max |F|, float64 oracle
    against the float32 route).  The JAX oracle takes sqrt(r^2) at the
    dense matrix's zero diagonal, whose infinite derivative makes every
    force NaN there; the port floors r^2 first."""
    from gromacs_fep_gpu_tpu_torch.ops.forces import make_dense_force_fn
    ts, tst = tsolv.solvation_system(n_side=5, device="cpu")
    ts = dataclasses.replace(ts, nbfp=torch.as_tensor(
        lb_table(ttop, tsolv, twater)))
    p = md_params(ttypes, coulomb="reaction-field", rcoulomb=0.6, rvdw=0.6,
                  rlist=0.6, rvdw_switch=0.45, vdw_modifier="potential-switch",
                  fep=dict(enabled=True, sc_alpha=0.5, sc_coul=True))
    runner = MdRunner(ts, p, RunnerConfig(nnbr=128, fep_max_nbr=128))
    nlist, feplist, prep, _ = runner.rebuild(tst)
    f_c, t_c = runner._force_fn(tst.x, tst.box, tst.lam, nlist, feplist,
                                prep)
    f_d, t_d = make_dense_force_fn(ts, p)(tst.x.double(), tst.box.double(),
                                          tst.lam.double())
    assert bool(torch.isfinite(f_d).all())
    np.testing.assert_allclose(f_c.numpy(), f_d.numpy(), rtol=0,
                               atol=1e-4 * float(f_d.abs().max()))
    np.testing.assert_allclose(float(t_c.lj), float(t_d.lj), rtol=1e-4)


def test_effective_rlist_under_force_switch_matches_jax():
    kw = dict(rcoulomb=1.2, rvdw=1.2, rlist=1.2, rvdw_switch=1.0,
              coulomb="pme", vdw_modifier="force-switch", dt=0.002,
              nstlist=20)
    js, _ = jsolv.solvation_system(n_side=4)
    ts, _ = tsolv.solvation_system(n_side=4, device="cpu")
    vol = (4 * 0.31) ** 3
    r_j = jverletbuf.effective_rlist(md_params(jtypes, **kw), system=js,
                                     volume=vol)
    r_t = tverletbuf.effective_rlist(md_params(ttypes, **kw), system=ts,
                                     volume=vol)
    assert r_t == pytest.approx(r_j, rel=1e-12)
    assert r_t > 1.2


def test_lb_force_switch_runner_matches_jax():
    """Ten steps of the CHARMM-style route at a small size: a
    Lorentz-Berthelot table with force-switch under the DEFAULT runner
    configuration, which demotes to the table route on both sides (the
    JAX RunnerConfig's default is its XLA kernel), two rebuilds, the
    ligand at lambda 0.5, energies every step (one JAX step body).
    Reaction field keeps the JAX compile short; PME on this route is held
    by test_cluster_nb_kernel_matches_jax and on the card.  Positions to
    1e-4 nm, potential energy and dV/dlambda to 1e-5 of the Coulomb
    energy's magnitude (the 40-step test's gates, on the largest term)."""
    n_side, nsteps = 6, 10
    js, jst = lb_system(n_side)
    jst = jst.replace(lam=jst.lam.at[2].set(0.5).at[3].set(0.5))
    kw = dict(dt=0.001, nstlist=5, coulomb="reaction-field",
              vdw_modifier="force-switch", rcoulomb=0.6, rvdw=0.6,
              rvdw_switch=0.45, rlist=0.6, nstcalcenergy=1, nstcomm=100,
              fep=dict(enabled=True, sc_alpha=0.5, sc_coul=True,
                       sc_sigma=0.3, nstdhdl=5))
    jr = JRunner(js, md_params(jtypes, **kw),
                 JConfig(nnbr=128, fep_max_nbr=128))
    assert not jr.config.use_pallas
    jst_out, jlogs = jr.run(jst, nsteps)
    jlog = j_concat(jlogs)
    ts, tst = to_port(js, jst)
    tr = MdRunner(ts, md_params(ttypes, **kw),
                  RunnerConfig(nnbr=128, fep_max_nbr=128))
    assert tr.layout == "table"
    tst_out, tlogs = tr.run(tst, nsteps)
    tlog = t_concat(tlogs)
    np.testing.assert_allclose(tst_out.x.numpy(), np.asarray(jst_out.x),
                               rtol=0, atol=1e-4)
    e_j = np.asarray(jlog.epot)
    assert np.isfinite(e_j).all() and np.isfinite(tlog.epot.numpy()).all()
    scale = np.abs(np.asarray(jlog.terms.coulomb)).max()
    np.testing.assert_allclose(tlog.epot.numpy(), e_j, rtol=0,
                               atol=1e-5 * scale)
    for ch in (2, 3):
        np.testing.assert_allclose(tlog.dvdl.numpy()[:, ch],
                                   np.asarray(jlog.dvdl)[:, ch], rtol=0,
                                   atol=1e-5 * scale)
