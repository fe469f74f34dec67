"""The port stands alone: with jax (and the JAX package) made unimportable,
every module of gromacs_fep_gpu_tpu_torch imports and one MD step runs on
the CPU.  Run in a subprocess so this test's own interpreter, which has
JAX loaded, does not hide a stray import."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "gromacs_fep_gpu_tpu"):
    sys.modules[name] = None        # any import of them raises ImportError
import torch
torch.set_num_threads(1)
import gromacs_fep_gpu_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
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
    assert n_mods >= 20


def test_default_device_is_cuda_without_fallback():
    """Entry points default to the GPU and fail where there is none; they
    never carry on quietly on the CPU."""
    script = ("import torch, sys\n"
              "from gromacs_fep_gpu_tpu_torch.models.solvation import "
              "solvation_system\n"
              "if torch.cuda.is_available():\n"
              "    print('HAS_CUDA'); sys.exit(0)\n"
              "try:\n"
              "    solvation_system(n_side=3)\n"
              "except (RuntimeError, AssertionError) as e:\n"
              "    print('RAISED', type(e).__name__); sys.exit(0)\n"
              "sys.exit(1)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split()[0] in ("RAISED", "HAS_CUDA")
