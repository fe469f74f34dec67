"""Numpy bridge between the JAX package and the PyTorch port for the
tests: JAX pytrees -> dicts of numpy arrays -> the port's from_numpy."""
import numpy as np
import torch

from gromacs_fep_gpu_tpu_torch.core.types import from_numpy

torch.set_num_threads(1)


def system_arrays(js) -> dict:
    d = {k: np.asarray(getattr(js, k)) for k in (
        "charge_a", "charge_b", "type_a", "type_b", "mass_a", "mass_b",
        "perturbed", "nbfp")}
    d["exclusions"] = np.asarray(js.exclusions.idx)
    d.update(settle_atoms=np.asarray(js.settle.atoms),
             settle_d_oh=np.asarray(js.settle.d_oh),
             settle_d_hh=np.asarray(js.settle.d_hh),
             settle_mask=np.asarray(js.settle.mask))
    for name, il in js.bonded.items():
        d[f"bonded_{name}_atoms"] = np.asarray(il.atoms)
        d[f"bonded_{name}_params_a"] = np.asarray(il.params_a)
        d[f"bonded_{name}_params_b"] = np.asarray(il.params_b)
        d[f"bonded_{name}_mask"] = np.asarray(il.mask)
    return d


def state_arrays(jst) -> dict:
    return {k: np.asarray(getattr(jst, k)) for k in ("x", "v", "box", "lam")}


def to_port(js, jst, device="cpu"):
    """(System, State) of the port on the JAX pytrees' exact values."""
    return from_numpy(system_arrays(js), state_arrays(jst), device)


def t(a, dtype=None):
    """numpy/JAX array -> CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=dtype)
