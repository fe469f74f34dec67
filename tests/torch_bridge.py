"""Numpy bridge between the JAX package and the PyTorch port for the
tests: JAX pytrees -> dicts of numpy arrays -> the port's from_numpy; one
set of run parameters -> either package's MdParams; a JAX cluster pair
list -> the port's."""
import numpy as np
import torch

from gromacs_fep_gpu_tpu_torch.core.types import from_numpy
from gromacs_fep_gpu_tpu_torch.ops.pairlist import ClusterPairlist

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
    lists = {f"bonded_{name}": il for name, il in js.bonded.items()}
    if js.pairs14.n > 0:
        lists["pairs14"] = js.pairs14
    for prefix, il in lists.items():
        d[f"{prefix}_atoms"] = np.asarray(il.atoms)
        d[f"{prefix}_params_a"] = np.asarray(il.params_a)
        d[f"{prefix}_params_b"] = np.asarray(il.params_b)
        d[f"{prefix}_mask"] = np.asarray(il.mask)
    return d


def state_arrays(jst) -> dict:
    return {k: np.asarray(getattr(jst, k)) for k in ("x", "v", "box", "lam")}


def to_port(js, jst, device="cpu"):
    """(System, State) of the port on the JAX pytrees' exact values."""
    st = dict(state_arrays(jst), fep_state=int(jst.fep_state))
    return from_numpy(system_arrays(js), st, device)


def t(a, dtype=None):
    """numpy/JAX array -> CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=dtype)


# MdParams fields that hold an enum, by the enum's class name
_ENUM_FIELDS = {"coulomb": "CoulombType", "vdw_modifier": "VdwModifier",
                "integrator": "IntegratorType", "tcoupl": "TcouplType",
                "pcoupl": "PcouplType"}


def md_params(types_mod, fep=None, **kw):
    """types_mod.MdParams (either package's core.types) from plain values:
    enum fields by their mdp value (coulomb="pme", pcoupl="c-rescale"),
    fep a dict of FepParams fields.  The same call on both modules gives
    both sides the same run parameters, pressure coupling included."""
    for name, cls in _ENUM_FIELDS.items():
        if name in kw and isinstance(kw[name], str):
            kw[name] = getattr(types_mod, cls)(kw[name])
    if fep is not None:
        kw["fep"] = types_mod.FepParams(**fep)
    return types_mod.MdParams(**kw)


def port_cluster_list(jl, n_clusters):
    """The port's ClusterPairlist holding a JAX cluster list's arrays."""
    opt = {k: (None if getattr(jl, k) is None else t(getattr(jl, k)))
           for k in ("super_shift", "img", "shift_overflow", "tile_overflow",
                     "tile_max")}
    return ClusterPairlist(
        perm=t(jl.perm, torch.int64), inv_perm=t(jl.inv_perm, torch.int64),
        q_a=t(jl.q_a), q_b=t(jl.q_b), t_a=t(jl.t_a, torch.int64),
        t_b=t(jl.t_b, torch.int64), pert=t(jl.pert),
        excl=t(jl.excl, torch.int64), n_clusters=n_clusters,
        nbr_super=t(jl.nbr_super, torch.int64),
        super_overflow=t(jl.super_overflow),
        super_max_count=t(jl.super_max_count), **opt)
