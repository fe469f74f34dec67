"""The port stands alone: with jax (and the JAX package) made unimportable,
every module of gromacs_fep_gpu_tpu_torch imports, and one MD step, one
step on a (2, 2, 2) domain grid of eight CPU domains, one step of the
table route (Lorentz-Berthelot, force-switch) and of K7a and K7b, two
C-rescale NPT steps with the dispersion correction, a two-step lambda
window with its dhdl.xvg and BAR, the CLI (solvate -> grompp -> mdrun
with trr/xtc frames -> bar -> check, steep, -rerun, and `python -m`
through __main__) and two sd steps of
chip_smoke.py's OPLS-AA ethanol (dihedrals, restraints, grompp -r) run on
the CPU.  Run in a subprocess so this test's own interpreter, which has
JAX loaded, does not hide a stray import."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
for name in ("jax", "jaxlib", "flax", "gromacs_fep_gpu_tpu"):
    sys.modules[name] = None        # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import gromacs_fep_gpu_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    if not m.endswith(".__main__"):     # __main__ runs the CLI (below)
        importlib.import_module(m)
for m in ("ops.nonbonded_ref", "ops.forces", "ops.foreign", "ops.dispcorr",
          "ops.nb_cluster", "io.xvgio", "analysis.bar", "analysis.mbar",
          "parallel.ensemble", "parallel.mesh", "parallel.spatial",
          "io.mdpio", "io.ndxio", "io.groio", "io.pdbio", "io.topio",
          "io.grompp", "io.buildtools", "io.edrio", "io.cptio",
          "io.checkpoint", "io.logio", "utils.timing", "io.native",
          "io.trrio", "io.xtcio", "md.minimize", "cli", "__main__"):
    assert pkg.__name__ + "." + m in mods, m
from gromacs_fep_gpu_tpu_torch.core.types import (CoulombType, FepParams,
                                                  MdParams)
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
system, state = solvation_system(n_side=5, device="cpu")
params = MdParams(dt=0.001, nstlist=10, coulomb=CoulombType.PME,
                  rcoulomb=0.6, rvdw=0.6, rlist=0.6,
                  pme_grid=pme_grid_size((5 * 0.31,) * 3, 0.12),
                  fep=FepParams(enabled=True, sc_alpha=0.5, sc_coul=True))
runner = MdRunner(system, params, RunnerConfig(super_nnbr=128,
                                               fep_max_nbr=128))
state, logs = runner.run(state, 1)
assert state.step == 1 and bool(torch.isfinite(state.x).all())
assert bool(torch.isfinite(logs[0].epot).all())
# domain decomposition: eight domains on the CPU, K6's plain version and
# the sharded PME
from gromacs_fep_gpu_tpu_torch.parallel.mesh import make_mesh
dd = MdRunner(system, params, RunnerConfig(
    super_nnbr=128, fep_max_nbr=128, dd_block=4, dd_grid=(2, 2, 2),
    mesh=make_mesh(n_spatial=8, devices=["cpu"] * 8)))
out, logs = dd.run(state, 1)
assert bool(torch.isfinite(out.x).all())
assert float((logs[0].epot - runner.run(state, 1)[1][0].epot).abs()) < 1.0
# a Lorentz-Berthelot table with force-switch demotes the default layout
# to the table route; K7a/b/c run on the same system's geometric table
import dataclasses
from gromacs_fep_gpu_tpu_torch.core.topology import lj_table_from_sigma_eps
from gromacs_fep_gpu_tpu_torch.core.types import VdwModifier
lb = torch.as_tensor(lj_table_from_sigma_eps(
    [0.315061, 0.1, 0.35, 0.25, 0.1], [0.636386, 0.0, 0.45, 0.1, 0.0], 2))
lb[1] = lb[:, 1] = lb[4] = lb[:, 4] = 0.0
fsw = params.replace(vdw_modifier=VdwModifier.FORCE_SWITCH, rvdw_switch=0.5)
table = MdRunner(dataclasses.replace(system, nbfp=lb), fsw,
                 RunnerConfig(nnbr=96, fep_max_nbr=128))
assert table.layout == "table"
out, logs = table.run(state, 1)
assert bool(torch.isfinite(logs[0].epot).all())
for layout in ("super", "cluster"):
    k7 = MdRunner(system, params, RunnerConfig(layout=layout, nnbr=96,
                                               super_nnbr=256,
                                               fep_max_nbr=128))
    out, logs = k7.run(state, 1)
    assert bool(torch.isfinite(out.x).all()), layout
# NPT: C-rescale with the dispersion correction, a pressure step each step
from gromacs_fep_gpu_tpu_torch.core.types import PcouplType
npt = MdRunner(system, params.replace(pcoupl=PcouplType.C_RESCALE,
                                      nstpcouple=1, dispcorr=True),
               RunnerConfig(super_nnbr=128, fep_max_nbr=128))
out, logs = npt.run(state, 2)
assert bool(torch.isfinite(logs[0].pres).all())
assert not torch.equal(out.box, state.box)
# a lambda window with a ladder: Delta H -> dhdl.xvg -> BAR
import numpy as np
from gromacs_fep_gpu_tpu_torch.analysis.bar import bar_profile
from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg, write_dhdl_xvg
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs
from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule
ladder = lambda_schedule(3)
rows, idx = [], []
with tempfile.TemporaryDirectory() as tmp:
    for w in (0, 1):
        st = state.replace(lam=torch.tensor(ladder[w]), fep_state=w, step=0)
        runner = MdRunner(system, params.replace(
            fep=FepParams(enabled=True, sc_alpha=0.5, sc_coul=True,
                          nstdhdl=1)),
            RunnerConfig(super_nnbr=128, fep_max_nbr=128),
            all_lambda=ladder)
        _, logs = runner.run(st, 2)
        lg = concat_logs(logs)
        path = os.path.join(tmp, "w%d.dhdl.xvg" % w)
        write_dhdl_xvg(path, np.arange(2) * params.dt, lg.dvdl.numpy(),
                       lg.delta_h.numpy(), ladder, w)
        data, legends = read_xvg(path)
        assert data.shape == (2, 1 + 3 + 3) and len(legends) == 6
        assert float(np.abs(data[:, 4 + w]).max()) == 0.0
        rows.append(data[:, 4:])
        idx.append(np.full(2, w))
legs, total, err = bar_profile(np.concatenate(rows), np.concatenate(idx),
                               300.0, skip_frac=0.0)
assert np.isfinite(legs[0][0]) and np.isnan(legs[1][0])
# the CLI: solvate -> grompp -> 2 steps of mdrun -> bar -> check, then
# `python -m gromacs_fep_gpu_tpu_torch check` through __main__
import runpy
from gromacs_fep_gpu_tpu_torch import cli
TOP = '''[ defaults ]
1 3 yes 0.5 0.8333
[ atomtypes ]
OW 15.9994 -0.834 A 0.315061 0.636386
HW 1.008 0.417 A 0.0 0.0
[ moleculetype ]
SOL 2
[ atoms ]
1 OW 1 SOL OW 1 -0.834 15.9994
2 HW 1 SOL HW1 1 0.417 1.008
3 HW 1 SOL HW2 1 0.417 1.008
[ settles ]
1 1 0.09572 0.15139
[ exclusions ]
1 2 3
2 3
[ system ]
water
[ molecules ]
SOL %d
'''
MDP = ("integrator = md\ndt = 0.001\nnsteps = 2\nnstlist = 2\n"
       "coulombtype = reaction-field\nrcoulomb = 0.55\nrvdw = 0.55\n"
       "rlist = 0.6\nfree-energy = yes\nfep-lambdas = 0 1\n"
       "init-lambda-state = %d\nnstdhdl = 1\nnstxout = 1\nnstvout = 1\n"
       "nstxout-compressed = 1\n")
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    cli.main(["solvate", "-box", "1.3", "-o", "conf.gro"])
    nsol = (int(open("conf.gro").read().splitlines()[1])) // 3
    open("topol.top", "w").write(TOP % nsol)
    for w in (0, 1):
        open("md%d.mdp" % w, "w").write(MDP % w)
        cli.main(["grompp", "-f", "md%d.mdp" % w, "-p", "topol.top", "-c",
                  "conf.gro", "-o", "w%d.tpz" % w], device="cpu")
        cli.main(["mdrun", "-s", "w%d.tpz" % w, "-deffnm", "w%d" % w],
                 device="cpu")
    cli.main(["bar", "-f", "w0.dhdl.xvg", "w1.dhdl.xvg", "-b", "0"])
    # steep before a window, the frames of a window, -rerun after it
    open("em.mdp", "w").write((MDP % 1).replace("integrator = md",
                                                "integrator = steep"))
    cli.main(["grompp", "-f", "em.mdp", "-p", "topol.top", "-c", "conf.gro",
              "-o", "em.tpz"], device="cpu")
    _, res = cli.main(["mdrun", "-s", "em.tpz", "-deffnm", "em"],
                      device="cpu")
    assert res.n_steps == 2 and os.path.exists("em.gro")
    assert cli.main(["check", "-f", "w1.xtc"], device="cpu").steps == [0, 1, 2]
    _, rr = cli.main(["mdrun", "-s", "w1.tpz", "-rerun", "w1.trr",
                      "-deffnm", "rr"], device="cpu")
    assert list(rr.step) == [0, 1, 2]
    cli.main(["check", "-s", "w1.cpt"], device="cpu")
    sys.argv = ["gromacs_fep_gpu_tpu_torch", "check", "-s", "w1.edr"]
    runpy.run_module("gromacs_fep_gpu_tpu_torch", run_name="__main__")
    os.chdir("/")
# a user's ligand: OPLS-AA ethanol with RB dihedrals, a dihedral and a
# flat-bottomed position restraint (grompp -r), decoupled under sd
import chip_smoke
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    open("eth.gro", "w").write(chip_smoke.ETH_GRO)
    cli.main(["solvate", "-cp", "eth.gro", "-box", "1.4", "-o", "conf.gro"])
    nsol = (int(open("conf.gro").read().splitlines()[1]) - 9) // 3
    open("topol.top", "w").write(chip_smoke.ETH_TOP.format(nsol=nsol))
    open("md.mdp", "w").write(chip_smoke.ETH_MDP.format(nsteps=2, window=1))
    cli.main(["grompp", "-f", "md.mdp", "-p", "topol.top", "-c", "conf.gro",
              "-r", "conf.gro", "-o", "eth.tpz"], device="cpu")
    runner, st = cli.main(["mdrun", "-s", "eth.tpz", "-deffnm", "eth"],
                          device="cpu")
    assert st.step == 2 and {"rbdihs", "dihres", "fbposres"} <= set(
        runner.system.bonded)
    os.chdir("/")
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")
            and sys.modules[m] is not None]
print("OK", len(mods))
"""


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_mods = int(r.stdout.split()[-1])
    assert n_mods >= 30


def test_default_device_is_cuda_without_fallback():
    """Entry points default to the GPU and fail where there is none; they
    never carry on quietly on the CPU: solvation_system, and `python -m
    gromacs_fep_gpu_tpu_torch mdrun` (run as __main__), which exits with
    "no CUDA device"."""
    script = ("import runpy, sys, torch\n"
              "from gromacs_fep_gpu_tpu_torch.models.solvation import "
              "solvation_system\n"
              "if torch.cuda.is_available():\n"
              "    print('HAS_CUDA'); sys.exit(0)\n"
              "try:\n"
              "    solvation_system(n_side=3)\n"
              "    sys.exit(1)\n"
              "except (RuntimeError, AssertionError) as e:\n"
              "    print('RAISED', type(e).__name__)\n"
              "sys.argv = ['gromacs_fep_gpu_tpu_torch', 'mdrun', '-s', "
              "'x.tpz']\n"
              "try:\n"
              "    runpy.run_module('gromacs_fep_gpu_tpu_torch', "
              "run_name='__main__')\n"
              "except SystemExit as e:\n"
              "    print('CLI', 'no CUDA device' in str(e.code))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split()[0] in ("RAISED", "HAS_CUDA")
    if r.stdout.split()[0] == "RAISED":
        assert "CLI True" in r.stdout, r.stdout + r.stderr
