"""The lambda-window run end to end on the CPU: MdRunner with a ladder,
StepLog.delta_h, dhdl.xvg and BAR/MBAR, the port against the JAX package.

Tolerances: delta_h of an 8-step run against the JAX runner 1e-4 of max
|Delta H| (float32 dynamics on both sides) plus 1e-6 of the reciprocal
energy: the JAX runner and the port's dense route take each Delta H as a
difference of float32 reciprocal energies of ~1e4 kJ/mol, whose last bit
is 1e-3 kJ/mol, so their values come in steps of that size; NaN pattern
identical; own-window entry <= 1e-3 kJ/mol (the cluster route's is 0);
dhdl.xvg byte-identical for the same arrays; bar, bar_profile and mbar to
1e-12 on seeded synthetic Delta H (the port's copies are the same numpy
code).
"""
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest

from gromacs_fep_gpu_tpu.analysis import bar as jbar
from gromacs_fep_gpu_tpu.analysis import mbar as jmbar
from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.io import xvgio as jxvg
from gromacs_fep_gpu_tpu.md.runner import MdRunner as JRunner
from gromacs_fep_gpu_tpu.md.runner import RunnerConfig as JConfig
from gromacs_fep_gpu_tpu.md.runner import concat_logs as j_concat
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.parallel.ensemble import lambda_schedule as j_sched
from gromacs_fep_gpu_tpu_torch.analysis import bar as tbar
from gromacs_fep_gpu_tpu_torch.analysis import mbar as tmbar
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.io import xvgio as txvg
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner as TRunner
from gromacs_fep_gpu_tpu_torch.md.runner import RunnerConfig as TConfig
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs as t_concat
from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule

from torch_bridge import to_port

L, WINDOW, NSTEPS = 4, 1, 8


def _params(mod, nstlist=4):
    return mod.MdParams(
        dt=0.001, nstlist=nstlist, coulomb=mod.CoulombType.PME,
        rcoulomb=0.5, rvdw=0.5, rlist=0.5, pme_grid=(12, 12, 12), nstcomm=0,
        fep=mod.FepParams(enabled=True, sc_alpha=0.5, sc_coul=True,
                          sc_sigma=0.3, nstdhdl=2))


@pytest.fixture(scope="module")
def jax_window():
    """One window of a 4-window ladder on the JAX runner's cluster route
    (XLA cluster kernel, FEP list, a reciprocal energy per window): nstdhdl
    2, 8 steps.  One run is the reference for both routes of the port.
    nstlist is 1 there: the JAX runner traces one step body per flavour
    and chunk, and that tracing is nearly all of this test's time."""
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=13)
    jst = jst.replace(lam=j_sched(L)[WINDOW],
                      fep_state=jnp.asarray(WINDOW, jnp.int32))
    jr = JRunner(js, _params(jtypes, 1), JConfig(fep_max_nbr=128),
                 all_lambda=j_sched(L))
    _, jlogs = jr.run(jst, NSTEPS)
    jlog = j_concat(jlogs)
    return js, jst, np.asarray(jlog.delta_h), np.abs(
        np.asarray(jlog.terms.coul_recip)).max()


@pytest.mark.parametrize("route", ["cluster", "dense"])
def test_runner_delta_h_matches_jax(jax_window, route):
    """The port's cluster route (pair lists, FEP list, lambda-dependent
    terms, reciprocal slope) and its dense route against the JAX runner."""
    js, jst, dh_j, e_rec = jax_window
    ts, tst = to_port(js, jst)
    assert tst.fep_state == WINDOW
    tr = TRunner(ts, _params(ttypes),
                 TConfig(use_dense=route == "dense", super_nnbr=128,
                         fep_max_nbr=128, baked_shifts=False),
                 all_lambda=lambda_schedule(L))
    assert tr._flavor_pattern(0, 4) == "DEDE"
    tst_out, tlogs = tr.run(tst, NSTEPS)
    tlog = t_concat(tlogs)
    dh_t = tlog.delta_h.numpy()

    assert dh_t.shape == dh_j.shape == (NSTEPS, L)
    on = np.isfinite(dh_j[:, 0])
    assert on.tolist() == [True, False] * (NSTEPS // 2)
    np.testing.assert_array_equal(np.isfinite(dh_t), np.isfinite(dh_j))
    scale = np.abs(dh_j[on]).max()
    assert scale > 1.0
    np.testing.assert_allclose(dh_t[on], dh_j[on], rtol=0,
                               atol=1e-4 * scale + 1e-6 * e_rec)
    assert np.abs(dh_t[on][:, WINDOW]).max() <= 1e-3
    assert tst_out.fep_state == WINDOW and tst_out.step == NSTEPS
    assert np.isfinite(tlog.dvdl.numpy()).all()


def test_no_ladder_gives_empty_delta_h_and_old_flavours():
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=13)
    ts, tst = to_port(js, jst)
    p = _params(ttypes).replace(nstcalcenergy=2, mts=True)
    tr = TRunner(ts, p, TConfig(super_nnbr=128, fep_max_nbr=128,
                                baked_shifts=False))
    assert tr._flavor_pattern(0, 4) == "EfEf"
    _, logs = tr.run(tst, 2)
    assert logs[0].delta_h.shape == (2, 0)
    # with a ladder the dhdl steps become 'D'; dense has no 'F' steps and
    # refuses multiple time stepping
    lad = TRunner(ts, p, TConfig(), all_lambda=lambda_schedule(L))
    assert lad._flavor_pattern(2, 4) == "DfDf"
    assert TRunner(ts, p.replace(mts=False), TConfig(use_dense=True)
                   )._flavor_pattern(1, 3) == "EEE"
    with pytest.raises(ValueError, match="use_dense"):
        TRunner(ts, p, TConfig(use_dense=True)).run(tst, 2)
    with pytest.raises(ValueError, match="nstdhdl"):
        TRunner(ts, p.replace(mts_factor=4, nstcalcenergy=4), TConfig(),
                all_lambda=lambda_schedule(L)).run(tst, 2)


def _synthetic(seed=0, n=60, nl=5):
    """Delta H rows of overlapping harmonic windows, window by window."""
    rng = np.random.RandomState(seed)
    centers = np.linspace(0.0, 2.0, nl)
    rows, idx = [], []
    for i, c in enumerate(centers):
        x = rng.normal(c, 0.6, n)
        u = 2.0 * (x[:, None] - centers[None, :]) ** 2 + 0.7 * centers
        rows.append(u - u[:, i:i + 1])
        idx.append(np.full(n, i))
    return np.concatenate(rows), np.concatenate(idx)


def test_dhdl_xvg_bytes_match_jax(tmp_path):
    dh, _ = _synthetic(1, n=12, nl=4)
    dh = dh[:12]
    dh[1::2] = np.nan
    dvdl = np.random.RandomState(2).normal(size=(12, 7))
    times = np.arange(12) * 0.002
    lams = lambda_schedule(4)
    for name, delta in (("with", dh), ("without", None)):
        pj, pt = tmp_path / f"j_{name}.xvg", tmp_path / f"t_{name}.xvg"
        jxvg.write_dhdl_xvg(str(pj), times, dvdl, delta,
                            np.asarray(j_sched(4)), 2, temperature=298.0)
        txvg.write_dhdl_xvg(str(pt), times, dvdl, delta, lams, 2,
                            temperature=298.0)
        assert filecmp.cmp(pj, pt, shallow=False)
    data, legends = txvg.read_xvg(str(tmp_path / "t_with.xvg"))
    data_j, legends_j = jxvg.read_xvg(str(tmp_path / "j_with.xvg"))
    assert legends == legends_j and len(legends) == 3 + 4
    np.testing.assert_array_equal(data, data_j)
    txvg.write_xvg(str(tmp_path / "t.xvg"), "t", "x", "y", ["a"], data[:, :2])
    jxvg.write_xvg(str(tmp_path / "j.xvg"), "t", "x", "y", ["a"], data[:, :2])
    assert filecmp.cmp(tmp_path / "t.xvg", tmp_path / "j.xvg", shallow=False)


@pytest.mark.parametrize("seed", [0, 7])
def test_bar_and_mbar_match_jax(seed):
    dh, idx = _synthetic(seed)
    kt = 2.494
    fwd, rev = dh[idx == 1][:, 2], dh[idx == 2][:, 1]
    np.testing.assert_allclose(tbar.bar(fwd, rev, kt), jbar.bar(fwd, rev, kt),
                               rtol=1e-12)
    np.testing.assert_allclose(tbar.exp_average(fwd, kt),
                               jbar.exp_average(fwd, kt), rtol=1e-12)
    legs_t, tot_t, err_t = tbar.bar_profile(dh, idx, 300.0)
    legs_j, tot_j, err_j = jbar.bar_profile(dh, idx, 300.0)
    np.testing.assert_allclose(legs_t, legs_j, rtol=1e-12)
    np.testing.assert_allclose([tot_t, err_t], [tot_j, err_j], rtol=1e-12)
    # the windows are harmonic wells of equal width offset by 0.7 c_i
    np.testing.assert_allclose(tot_t, 1.4, atol=0.4)
    f_t, e_t = tmbar.mbar(dh, idx, kt)
    f_j, e_j = jmbar.mbar(dh, idx, kt)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(f_t[-1], 1.4, atol=0.4)
