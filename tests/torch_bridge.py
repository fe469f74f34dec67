"""Numpy bridge between the JAX package and the PyTorch port for the
tests: JAX pytrees -> dicts of numpy arrays -> the port's from_numpy; one
set of run parameters -> either package's MdParams; a JAX cluster pair
list -> the port's; JAX's list builder and v2u pack under jax.jit."""
import functools

import jax
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
    """The port's ClusterPairlist holding a JAX cluster list's arrays (the
    per-cluster list when the JAX list has one: nnbr > 0)."""
    opt = {k: (None if getattr(jl, k) is None else t(getattr(jl, k)))
           for k in ("super_shift", "img", "shift_overflow", "tile_overflow",
                     "tile_max", "super_overflow", "super_max_count",
                     "nbr_shift")}
    if jl.nbr_super is not None:
        opt["nbr_super"] = t(jl.nbr_super, torch.int64)
    if jl.nbr.shape[1] > 0:
        opt.update(nbr=t(jl.nbr, torch.int64), nbr_mask=t(jl.nbr_mask),
                   n_overflow=t(jl.n_overflow), max_count=t(jl.max_count))
    return ClusterPairlist(
        perm=t(jl.perm, torch.int64), inv_perm=t(jl.inv_perm, torch.int64),
        q_a=t(jl.q_a), q_b=t(jl.q_b), t_a=t(jl.t_a, torch.int64),
        t_b=t(jl.t_b, torch.int64), pert=t(jl.pert),
        excl=t(jl.excl, torch.int64), n_clusters=n_clusters, **opt)


def jax_cluster_list(x, box, system, rlist, **kw):
    """JAX's build_cluster_pairlist under jax.jit (one compile in place of
    an eager compile per operation), with its own default sort-cell
    edge."""
    from gromacs_fep_gpu_tpu.ops.pairlist import build_cluster_pairlist
    vol = float(np.prod(np.diagonal(np.asarray(box))))
    cell = max((8 * vol / system.n_atoms) ** (1.0 / 3.0), 0.15)
    return jax.jit(functools.partial(build_cluster_pairlist, rlist=rlist,
                                     cell_size=cell, **kw))(x, box, system)


def jax_prepare_v2u(jl, nbfp):
    """JAX's pallas_prepare_v2u under jax.jit."""
    from gromacs_fep_gpu_tpu.ops.pallas_nb import pallas_prepare_v2u
    return jax.jit(pallas_prepare_v2u)(jl, nbfp)
