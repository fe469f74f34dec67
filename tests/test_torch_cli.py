"""The port's CLI end to end on the CPU (device="cpu", the kernels' plain
versions) against the JAX package's CLI on the same files: the example's
solvate -> grompp -> mdrun window -> bar, on examples/solvation_fep.sh's
1.24 nm box and topology (~190 atoms, reaction field, couple-moltype LIG,
vdW ladder of 5) with combination rule 3, so that -fep gpu runs K1's
layout (the published rule 2 demotes every layout to the table route, in
both packages), tcoupl = no, gen-vel with a fixed gen-seed, nsteps 10,
nstlist 10, nstdhdl 5.  The JAX CLI runs once (-fep cpu, its XLA route),
in a fixture whose directory the xdist workers share.

Tolerances: dhdl.xvg Delta H and dH/dlambda 1e-4 of their largest
magnitude (as tests/test_torch_dhdl.py; float32 dynamics on both sides),
ener.csv rows rel 1e-4, the same edr names, frame count and Delta H frames;
bar on the port's dhdl.xvg files equal to JAX's bar_profile on them at
1e-12.  Restarts: from the JAX CLI's md.gmx.cpt (x, v, box, step, lambda
state restored exactly), and 10 + 10 steps from the port's own .cpt
(v-rescale, its generator restored) equal to 20 steps in one run.

The OPLS-AA ethanol of chip_smoke.py (RB dihedrals from [ dihedraltypes ],
a perturbed dihedral, a dihedral restraint, a flat-bottomed position
restraint from grompp -r) decoupled in a 1.6 nm water box under sd: the
JAX CLI runs its window 2 once (a second shared directory).  Step 0 is
held to JAX's (the SD draws differ from there on): Epot rel 1e-5, the
md.log energy block's names and potential terms (rel 1e-5), the first
dhdl.xvg row at 1e-4 of its largest entry; 20 + 20 steps from the port's
.cpt equal 40 in one run bitwise (the SD stream continues).
"""
import fcntl
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu import cli as jcli
from gromacs_fep_gpu_tpu.analysis.bar import bar_profile as jbar_profile
from gromacs_fep_gpu_tpu.io.cptio import read_gmx_cpt as jread_gmx_cpt
from gromacs_fep_gpu_tpu.io.xvgio import read_xvg as jread_xvg
from gromacs_fep_gpu_tpu_torch import cli as tcli
from gromacs_fep_gpu_tpu_torch.io.checkpoint import load_checkpoint
from gromacs_fep_gpu_tpu_torch.io.edrio import ENX_DH, read_edr
from gromacs_fep_gpu_tpu_torch.io.pdbio import read_structure
from gromacs_fep_gpu_tpu_torch.io.trrio import read_trr_frame, scan_trr
from gromacs_fep_gpu_tpu_torch.io.xtcio import read_xtc_frame, scan_xtc
from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg
from gromacs_fep_gpu_tpu_torch.md.constraints import max_deviation

import torch_bridge  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

LIG, EX_TOP, EX_MDP, N_WIN = chip_smoke.example_inputs()
NSTEPS, NSTDHDL = 10, 5
ETH_BOX = 1.6


def _mdp(window, **keys):
    return chip_smoke.mdp_with(
        EX_MDP.format(nsteps=NSTEPS, window=window),
        dict({"tcoupl": "no", "gen-seed": 7, "nstdhdl": NSTDHDL}, **keys))


def _port(*argv):
    return tcli.main(list(argv), device="cpu")


def _once(tmp_path_factory, name, make):
    """A directory `name` that make() fills, run inside it, once per session:
    under xdist the workers share it (the session's base directory) and
    the first to take the lock fills it, so the JAX CLI runs once."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        d = tmp_path_factory.getbasetemp().parent / name
    else:
        d = tmp_path_factory.getbasetemp() / name
    d.mkdir(exist_ok=True)
    with open(d.parent / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (d / "done").exists():
                cwd = os.getcwd()
                os.chdir(d)
                try:
                    make()
                finally:
                    os.chdir(cwd)
                (d / "done").write_text("")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return d


def _make_inputs():
    """The example's inputs (rule 3) and the port's run inputs of windows 0
    and 1."""
    Path("lig.gro").write_text(LIG)
    _port("solvate", "-cp", "lig.gro", "-box", str(chip_smoke.EXAMPLE_BOX),
          "-o", "conf.gro")
    n_atoms = int(Path("conf.gro").read_text().splitlines()[1])
    Path("topol.top").write_text(chip_smoke.geometric_top(EX_TOP).format(
        nsol=(n_atoms - 1) // 3))
    for w in (0, 1):
        Path(f"md{w}.mdp").write_text(_mdp(w))
        _port("grompp", "-f", f"md{w}.mdp", "-p", "topol.top", "-c",
              "conf.gro", "-o", f"t{w}.tpz")
    # the JAX CLI's window-1 run, the reference ("jax.*")
    jcli.main(["grompp", "-f", "md1.mdp", "-p", "topol.top", "-c",
               "conf.gro", "-o", "j1.tpz"])
    jcli.main(["mdrun", "-s", "j1.tpz", "-deffnm", "jax", "-fep", "cpu"])


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """A directory with the example's inputs, the port's run inputs and
    the JAX CLI's window-1 run, made once per session."""
    return _once(tmp_path_factory, "torch_cli_example", _make_inputs)


def _make_ethanol():
    """The ethanol box (chip_smoke.ETH_*) at 1.6 nm, the port's run input
    of window 2 and the JAX CLI's window-2 run ("jax.*")."""
    Path("eth.gro").write_text(chip_smoke.ETH_GRO)
    _port("solvate", "-cp", "eth.gro", "-box", str(ETH_BOX), "-o",
          "conf.gro")
    n_atoms = int(Path("conf.gro").read_text().splitlines()[1])
    Path("topol.top").write_text(chip_smoke.ETH_TOP.format(
        nsol=(n_atoms - 9) // 3))
    Path("md.mdp").write_text(chip_smoke.mdp_with(
        chip_smoke.ETH_MDP.format(nsteps=2 * NSTEPS, window=2),
        {"nstcalcenergy": NSTDHDL, "nstdhdl": NSTDHDL}))
    grompp = ["grompp", "-f", "md.mdp", "-p", "topol.top", "-c", "conf.gro",
              "-r", "conf.gro", "-o"]
    _port(*grompp, "t.tpz")
    jcli.main(grompp + ["j.tpz"])
    jcli.main(["mdrun", "-s", "j.tpz", "-deffnm", "jax", "-fep", "cpu",
               "-nsteps", str(NSTEPS)])


@pytest.fixture(scope="module")
def ethanol(tmp_path_factory):
    return _once(tmp_path_factory, "torch_cli_ethanol", _make_ethanol)


def _log_block(text):
    """(names, values) of md.log's first energy block."""
    lines = text.split("   Energies (kJ/mol)\n", 1)[1].split("\n\n", 1)[0]
    rows = lines.splitlines()
    names = [n for r in rows[0::2] for n in
             (r[i:i + 15].strip() for i in range(0, len(r), 15))]
    values = [float(v) for r in rows[1::2] for v in r.split()]
    return names, values


def _dhdl_close(got, want):
    (tg, lg), (tw, lw) = got, want
    assert lg == lw and tg.shape == tw.shape
    np.testing.assert_array_equal(tg[:, 0], tw[:, 0])
    for cols in (slice(1, 4), slice(4, None)):
        a, b = tg[:, cols], tw[:, cols]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("fep,layout", [("cpu", "table"), ("gpu", "v2u")])
def test_window_matches_jax_cli(example, monkeypatch, fep, layout):
    monkeypatch.chdir(example)
    runner, state = _port("mdrun", "-s", "t1.tpz", "-deffnm", f"t_{fep}",
                          "-fep", fep)
    assert runner.layout == layout and state.step == NSTEPS
    got = read_xvg(f"t_{fep}.dhdl.xvg")
    assert got[0].shape[0] == NSTEPS // NSTDHDL
    assert np.isfinite(got[0]).all()
    _dhdl_close(got, jread_xvg("jax.dhdl.xvg"))
    t, j = np.loadtxt(f"t_{fep}.ener.csv"), np.loadtxt("jax.ener.csv")
    assert t.shape == j.shape == (NSTEPS, 5) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-4)
    (tn, _, tf), (jn, _, jf) = (read_edr(f"t_{fep}.edr"),
                                read_edr("jax.edr"))
    assert tn == jn and len(tf) == len(jf) == NSTEPS

    def dh_steps(frames):
        return [f.step for f in frames if any(b.id == ENX_DH
                                              for b in f.blocks)]
    assert dh_steps(tf) == dh_steps(jf) == list(range(0, NSTEPS, NSTDHDL))


def test_bar_matches_jax_bar_profile(example, monkeypatch, capsys):
    monkeypatch.chdir(example)
    files = []
    for w in (0, 1):
        _port("mdrun", "-s", f"t{w}.tpz", "-deffnm", f"bar{w}", "-fep",
              "cpu")
        files.append(f"bar{w}.dhdl.xvg")
    total, err = _port("bar", "-f", *files)
    rows, idx = [], []
    for i, f in enumerate(files):
        data, legends = jread_xvg(f)
        ndvdl = sum(1 for lg in legends if lg.startswith("dH/d"))
        rows.append(data[:, 1 + ndvdl:])
        idx.append(np.full(len(data), i))
    legs, want, want_err = jbar_profile(np.concatenate(rows),
                                        np.concatenate(idx), 300.0,
                                        skip_frac=0.1)
    assert np.isfinite(total)
    np.testing.assert_allclose([total, err], [want, want_err], rtol=1e-12,
                               atol=1e-12)
    assert "total" in capsys.readouterr().out


def test_restart_from_jax_gmx_cpt(example, monkeypatch):
    monkeypatch.chdir(example)
    cp = jread_gmx_cpt("jax.gmx.cpt")
    pp, _ = tcli._load_tpz("t1.tpz", "cpu")
    runner = types.SimpleNamespace(generator=None)
    st = tcli._restore(types.SimpleNamespace(cpi="jax.gmx.cpt"), pp.state,
                       runner, pp.params, "cpu")
    for k in ("x", "v", "box"):
        assert np.array_equal(getattr(st, k).numpy(),
                              cp.state[k].astype(np.float32)), k
    assert st.step == cp.step == NSTEPS and st.fep_state == 1
    with pytest.raises(ValueError, match="gmx.cpt"):   # JAX's own .cpt
        load_checkpoint("jax.cpt", "cpu")
    runner, state = _port("mdrun", "-s", "t1.tpz", "-cpi", "jax.gmx.cpt",
                          "-deffnm", "from_jax", "-fep", "cpu")
    assert state.step == 2 * NSTEPS
    _, _, frames = read_edr("from_jax.edr")
    assert [f.step for f in frames] == list(range(NSTEPS, 2 * NSTEPS))
    ener = np.loadtxt("from_jax.ener.csv")
    assert np.isfinite(ener).all()
    np.testing.assert_allclose(ener[0, 0], NSTEPS * 0.002)


def test_restart_from_own_cpt_equals_one_run(example, monkeypatch):
    """v-rescale: the restart restores the thermostat's generator."""
    monkeypatch.chdir(example)
    Path("vr.mdp").write_text(_mdp(1, **{"tcoupl": "v-rescale",
                                         "nsttcouple": 5}))
    _port("grompp", "-f", "vr.mdp", "-p", "topol.top", "-c", "conf.gro",
          "-o", "vr.tpz")
    _, whole = _port("mdrun", "-s", "vr.tpz", "-deffnm", "whole",
                     "-nsteps", str(2 * NSTEPS), "-fep", "gpu")
    _port("mdrun", "-s", "vr.tpz", "-deffnm", "half", "-fep", "gpu")
    _, rest = _port("mdrun", "-s", "vr.tpz", "-deffnm", "rest", "-cpi",
                    "half.cpt", "-fep", "gpu")
    assert rest.step == whole.step == 2 * NSTEPS
    for k in ("x", "v"):
        assert torch.equal(getattr(rest, k), getattr(whole, k)), k
    assert torch.equal(rest.coupling.therm_integral,
                       whole.coupling.therm_integral)
    assert float(whole.coupling.therm_integral) != 0.0
    # -maxh: a clean stop at the first verified chunk, outputs written
    runner, st = _port("mdrun", "-s", "vr.tpz", "-deffnm", "stopped",
                       "-nsteps", str(2 * NSTEPS), "-maxh", "1e-12")
    assert runner.stopped_at == st.step == NSTEPS
    assert np.loadtxt("stopped.ener.csv").shape[0] == NSTEPS


@pytest.mark.parametrize("fep,device,box,layout", [
    ("gpu", "cpu", np.eye(3), "v2u"), ("cpu", "cuda", np.eye(3), "table"),
    ("auto", "cuda", np.eye(3), "v2u"), ("auto", "cpu", np.eye(3), "table"),
    ("auto", "cuda", np.array([[1.0, 0, 0], [0.5, 1, 0], [0, 0, 1]]),
     "table")])
def test_fep_flag_maps_to_layout(fep, device, box, layout):
    assert tcli.fep_layout(fep, box, device) == layout


@pytest.mark.parametrize("argv,what", [
    (["mdrun", "-s", "t1.tpz", "-rerun", "x.gro"], "rerun"),
    (["mdrun", "-s", "t1.tpz", "-tunepme"], "tunepme"),
    (["mdrun", "-s", "t1.tpz", "-dd", "2x2x2"], "-dd"),
    (["mdrun", "-s", "x.tpr", "-mdp", "md1.mdp"], "tpr"),
    (["grompp", "-f", "md1.mdp", "-p", "topol.top", "-c", "conf.gro",
      "-o", "x.tpr"], "tpr"),
    (["check", "-f", "x.gro"], "xtc")])
def test_unported_cli_options_raise(argv, what):
    with pytest.raises(NotImplementedError, match=what):
        _port(*argv)


@pytest.mark.parametrize("mdp,rerun,what", [
    ({"energygrps": "Water"}, True, "energygrps"),
    ({"integrator": "cg"}, False, "SETTLE")])
def test_rerun_energygrps_and_cg_with_settle_raise(example, monkeypatch, mdp,
                                                   rerun, what):
    """-rerun with energy groups raises at mdrun, cg with SETTLE waters at
    grompp."""
    monkeypatch.chdir(example)
    tag = "raise_" + "_".join(mdp)
    Path(f"{tag}.mdp").write_text(_mdp(1, **mdp))
    with pytest.raises(NotImplementedError, match=what):
        _port("grompp", "-f", f"{tag}.mdp", "-p", "topol.top", "-c",
              "conf.gro", "-o", f"{tag}.tpz")
        if rerun:
            _port("mdrun", "-s", f"{tag}.tpz", "-rerun", "x.trr")


def _steps(path):
    scan, read = ((scan_trr, read_trr_frame) if path.endswith(".trr")
                  else (scan_xtc, read_xtc_frame))
    na, nf = scan(path)
    return [read(path, i, na) for i in range(nf)]


def test_em_window_frames_rerun_bar_chain(example, monkeypatch):
    """grompp em.mdp -> mdrun (steep) -> em.gro -> grompp of windows 0 and
    1 with nstxout = nstvout = nstxout-compressed = 5 -> mdrun -> frames
    at steps 0, 5, 10 (the last one the final state) -> mdrun -rerun of
    each .trr reproduces the window's dhdl.xvg rows at 1e-4 of the largest
    entry -> bar over the runs and over the reruns; -rerun of an .xtc and
    check -f of both formats."""
    monkeypatch.chdir(example)
    Path("chain_em.mdp").write_text(_mdp(1, integrator="steep", emtol=10))
    _port("grompp", "-f", "chain_em.mdp", "-p", "topol.top", "-c",
          "conf.gro", "-o", "chain_em.tpz")
    _, res = _port("mdrun", "-s", "chain_em.tpz", "-deffnm", "chain_em")
    trace = res.epot_trace.numpy()
    assert res.n_steps == NSTEPS and trace[-1] < trace[0]
    np.testing.assert_allclose(read_structure("chain_em.gro")[2],
                               res.x.numpy(), atol=6e-4)
    traj = {"nstxout": 5, "nstvout": 5, "nstxout-compressed": 5}
    runs, reruns = [], []
    for w in (0, 1):
        Path(f"chain{w}.mdp").write_text(_mdp(w, **traj))
        _port("grompp", "-f", f"chain{w}.mdp", "-p", "topol.top", "-c",
              "chain_em.gro", "-o", f"chain{w}.tpz")
        _, st = _port("mdrun", "-s", f"chain{w}.tpz", "-deffnm",
                      f"chain{w}", "-fep", "gpu")
        trr, xtc = _steps(f"chain{w}.trr"), _steps(f"chain{w}.xtc")
        assert [f["step"] for f in trr] == [f["step"] for f in xtc] == \
            [0, 5, 10]
        np.testing.assert_array_equal(trr[-1]["x"], st.x.numpy())
        np.testing.assert_array_equal(trr[-1]["v"], st.v.numpy())
        _, out = _port("mdrun", "-s", f"chain{w}.tpz", "-rerun",
                       f"chain{w}.trr", "-deffnm", f"chain_rr{w}", "-fep",
                       "gpu")
        assert list(out.step) == [0, 5, 10]
        (tw, lw), (tr, lr) = (read_xvg(f"chain{w}.dhdl.xvg"),
                              read_xvg(f"chain_rr{w}.dhdl.xvg"))
        # the run's rows at steps 0 and 5; the trr keeps time in float32
        assert lr == lw and tr.shape == (3, tw.shape[1])
        np.testing.assert_allclose(tr[:2, 0], tw[:, 0], rtol=1e-6)
        np.testing.assert_allclose(tr[:2, 1:], tw[:, 1:], rtol=0,
                                   atol=1e-4 * np.abs(tw[:, 1:]).max())
        runs.append(f"chain{w}.dhdl.xvg")
        reruns.append(f"chain_rr{w}.dhdl.xvg")
    for files in (runs, reruns):
        dg, err = _port("bar", "-f", *files, "-b", "0")
        assert np.isfinite(dg) and np.isfinite(err)
    _, out = _port("mdrun", "-s", "chain1.tpz", "-rerun", "chain1.xtc",
                   "-deffnm", "chain_rx1")
    assert np.isfinite(out.delta_h).all() and out.delta_h.shape == (3, N_WIN)
    for kind, prec in (("trr", None), ("xtc", 1000.0)):
        info = _port("check", "-f", f"chain1.{kind}")
        assert (info.natoms, info.steps, info.precision) == (
            st.n_atoms, [0, 5, 10], prec)


def test_em_rejects_a_step_settle_cannot_hold(example, monkeypatch):
    """steep with emstep 0.1 nm on the example: the first trial moves
    waters farther than the Newton SETTLE solves, so its constrained
    positions break them; the minimizer rejects it (without that, the
    broken waters reach the pair list and the excluded-pairs check fails
    hard), the energy never rises and every water keeps its geometry."""
    monkeypatch.chdir(example)
    Path("big_em.mdp").write_text(_mdp(1, integrator="steep", emtol=10,
                                       emstep=0.1))
    _port("grompp", "-f", "big_em.mdp", "-p", "topol.top", "-c",
          "conf.gro", "-o", "big_em.tpz")
    runner, res = _port("mdrun", "-s", "big_em.tpz", "-deffnm", "big_em")
    trace = res.epot_trace.numpy()
    assert res.n_steps == NSTEPS and not bool(res.accepted[0])
    assert (np.diff(trace) <= 0).all() and trace[-1] < trace[0]
    box = tcli._load_tpz("big_em.tpz", "cpu")[0].state.box
    assert float(max_deviation(res.x, box, runner.system)) <= \
        tcli.EM_CONSTRAINT_TOL


def test_frames_at_exact_steps(example, monkeypatch):
    """nstxout 3 and nstxout-compressed 4 against nstlist 10: frames at
    exactly the multiples, step 0 included; nstvout 0 writes no v."""
    monkeypatch.chdir(example)
    Path("exact.mdp").write_text(_mdp(1, **{"nstxout": 3,
                                            "nstxout-compressed": 4}))
    _port("grompp", "-f", "exact.mdp", "-p", "topol.top", "-c", "conf.gro",
          "-o", "exact.tpz")
    _port("mdrun", "-s", "exact.tpz", "-deffnm", "exact")
    trr = _steps("exact.trr")
    assert [f["step"] for f in trr] == [0, 3, 6, 9]
    assert all(f["v"] is None for f in trr)
    assert [f["step"] for f in _steps("exact.xtc")] == [0, 4, 8]


def test_frames_of_a_restart_equal_one_run(example, monkeypatch):
    """10 steps, then -cpi of the same files for 10 more: the same frame
    steps and coordinates as one 20-step run (the restart's step 10 is not
    written twice)."""
    monkeypatch.chdir(example)
    Path("fr.mdp").write_text(_mdp(1, **{"nstxout": 5, "nstvout": 5,
                                         "nstxout-compressed": 5}))
    _port("grompp", "-f", "fr.mdp", "-p", "topol.top", "-c", "conf.gro",
          "-o", "fr.tpz")
    _port("mdrun", "-s", "fr.tpz", "-deffnm", "fr_whole", "-nsteps",
          str(2 * NSTEPS))
    _port("mdrun", "-s", "fr.tpz", "-deffnm", "fr_half")
    _port("mdrun", "-s", "fr.tpz", "-deffnm", "fr_half", "-cpi",
          "fr_half.cpt")
    for kind in ("trr", "xtc"):
        whole, half = _steps(f"fr_whole.{kind}"), _steps(f"fr_half.{kind}")
        assert [f["step"] for f in half] == [f["step"] for f in whole] == \
            [0, 5, 10, 15, 20]
        for a, b in zip(half, whole):
            np.testing.assert_array_equal(a["x"], b["x"])


def test_default_device_is_the_gpu(tmp_path, monkeypatch):
    """With no GPU the CLI stops before reading or building anything; it
    never runs on the CPU (`python -m`: tests/test_torch_nojax.py)."""
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    for argv in (["mdrun", "-s", "t1.tpz", "-deffnm", "nogpu"],
                 ["grompp", "-f", "md1.mdp", "-p", "topol.top", "-c",
                  "conf.gro", "-o", "nogpu.tpz"],
                 ["check", "-s", "t1.tpz"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(argv)
    assert not list(Path(".").glob("nogpu*"))


def test_ethanol_sd_window_matches_jax_at_step_0(ethanol, monkeypatch):
    """Dihedrals, restraints and sd through grompp -r and mdrun -fep gpu:
    step 0 equals the JAX CLI's; dhdl.xvg gains the restraint column."""
    monkeypatch.chdir(ethanol)
    runner, state = _port("mdrun", "-s", "t.tpz", "-deffnm", "t", "-fep",
                          "gpu", "-nsteps", str(NSTEPS))
    assert runner.layout == "v2u" and state.step == NSTEPS
    assert runner.params.integrator.value == "sd"
    assert {"rbdihs", "dihres", "fbposres"} <= set(runner.system.bonded)
    t_e, j_e = np.loadtxt("t.ener.csv"), np.loadtxt("jax.ener.csv")
    assert t_e.shape == j_e.shape == (NSTEPS, 5)
    assert np.isfinite(t_e[::NSTDHDL]).all() and np.isfinite(
        t_e[:, [0, 2, 3, 4]]).all()
    np.testing.assert_allclose(t_e[0, 1], j_e[0, 1], rtol=1e-5)
    (tg, tl), (jg, jl) = read_xvg("t.dhdl.xvg"), jread_xvg("jax.dhdl.xvg")
    assert tl[:3] == jl[:3] and tl[3] == "dH/drestraint-lambda"
    assert len(tl) == 4 + chip_smoke.ETH_N_WIN == len(jl) + 1
    assert tg.shape[0] == jg.shape[0] == NSTEPS // NSTDHDL
    for a, b in ((tg[0, 1:4], jg[0, 1:4]), (tg[0, 5:], jg[0, 4:])):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    assert abs(tg[0, 4]) > 0.0            # dV/dlambda_restraint
    tn, tv = _log_block(Path("t.log").read_text())
    jn, jv = _log_block(Path("jax.log").read_text())
    assert tn == jn
    assert {"Proper Dih.", "Restraints"} <= set(tn)
    pot = tn.index("Kinetic En.")
    np.testing.assert_allclose(tv[:pot], jv[:pot], rtol=1e-5, atol=1e-3)
    # each package's run input runs on the other's mdrun
    _, st = _port("mdrun", "-s", "j.tpz", "-deffnm", "from_jax", "-nsteps",
                  "2")
    assert st.step == 2 and bool(torch.isfinite(st.x).all())


def test_ethanol_sd_restart_is_bitwise(ethanol, monkeypatch):
    """sd: 20 + 20 steps from the port's .cpt equal 40 in one run, bit for
    bit on the CPU (the checkpoint carries the generator of the SD
    draws)."""
    monkeypatch.chdir(ethanol)
    n = 2 * NSTEPS
    _, whole = _port("mdrun", "-s", "t.tpz", "-deffnm", "sd_whole",
                     "-nsteps", str(2 * n))
    _port("mdrun", "-s", "t.tpz", "-deffnm", "sd_half", "-nsteps", str(n))
    _, rest = _port("mdrun", "-s", "t.tpz", "-deffnm", "sd_rest", "-cpi",
                    "sd_half.cpt", "-nsteps", str(n))
    assert rest.step == whole.step == 2 * n
    for k in ("x", "v"):
        assert torch.equal(getattr(rest, k), getattr(whole, k)), k
    _, once = _port("mdrun", "-s", "t.tpz", "-deffnm", "sd_other",
                    "-nsteps", str(2 * n))
    assert torch.equal(once.x, whole.x)           # seeded: reproducible
