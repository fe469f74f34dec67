"""K1 (v2u cluster-pair kernel): the port's plain version against the JAX
Pallas kernel in interpret mode, on the JAX pair list's arrays.

Tolerances: energies rel 1e-5 and forces 2e-5 of the largest force, as
tests/test_pallas_nb.py holds the Pallas kernel against the XLA kernel —
both sides run the same fp32 formulas, only the summation order differs.
The bitmask pack (pallas_prepare_v2u) must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core.types import CoulombType, MdParams
from gromacs_fep_gpu_tpu.models.water import water_box
from gromacs_fep_gpu_tpu.ops.pairlist import build_cluster_pairlist
from gromacs_fep_gpu_tpu.ops.pallas_nb import (pallas_cluster_forces_v2u,
                                               pallas_prepare_v2u)
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
from gromacs_fep_gpu_tpu_torch.ops.pairlist import ClusterPairlist

from torch_bridge import t, to_port


def _port_list(jl, n_clusters):
    """The port's ClusterPairlist holding the JAX list's arrays."""
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


@pytest.fixture(scope="module", params=[True, False],
                ids=["baked_shifts", "min_image"])
def lists(request):
    baked = request.param
    system, state = water_box(8, spacing=0.31, seed=30)
    # an unwrapped molecule several images away: the baked-shift path must
    # re-enter the rebuild frame through nlist.img
    x = state.x.at[30:33].add(jnp.array([2.0 * state.box[0, 0],
                                         -3.0 * state.box[1, 1], 0.0]))
    jl = build_cluster_pairlist(x, state.box, system, 0.6, nnbr=0,
                                super_nnbr=192, super_block=4,
                                compute_shifts=baked)
    assert int(jl.super_overflow) == 0
    if baked:
        assert int(jl.shift_overflow) == 0
    jprep = pallas_prepare_v2u(jl, system.nbfp)
    ts, _ = to_port(system, state.replace(x=x))
    tl = _port_list(jl, jl.n_clusters)
    tprep = nb_v2u.prepare_v2u(tl, ts.nbfp)
    return system, state.replace(x=x), jl, jprep, ts, tl, tprep


def test_prepare_matches_jax(lists):
    _, _, _, jprep, _, _, tprep = lists
    for k in ("iq", "is6", "is12", "jq", "js6", "js12", "pair_m", "excl_m"):
        np.testing.assert_array_equal(getattr(tprep, k).numpy(),
                                      np.asarray(getattr(jprep, k)), err_msg=k)
    np.testing.assert_array_equal(tprep.ng.numpy(),
                                  np.asarray(jprep.ng).reshape(-1))
    np.testing.assert_array_equal(tprep.nbr2.numpy(), np.asarray(jprep.nbr2))
    if jprep.shift is None:
        assert tprep.shift is None
    else:
        np.testing.assert_array_equal(tprep.shift.numpy(),
                                      np.asarray(jprep.shift))


@pytest.mark.parametrize("coulomb", [CoulombType.PME,
                                     CoulombType.REACTION_FIELD])
@pytest.mark.parametrize("compute_energy", [True, False], ids=["VF", "F"])
def test_plain_kernel_matches_pallas(lists, coulomb, compute_energy):
    system, state, jl, jprep, ts, tl, tprep = lists
    params = MdParams(rcoulomb=0.55, rvdw=0.55, rlist=0.6, coulomb=coulomb)
    beta = 3.5 if coulomb == CoulombType.PME else None
    f_j, ec_j, el_j = pallas_cluster_forces_v2u(
        state.x, state.box, jl, system.nbfp, params, beta, prep=jprep,
        interpret=True, compute_energy=compute_energy)
    tparams = ttypes.MdParams(rcoulomb=0.55, rvdw=0.55, rlist=0.6,
                              coulomb=ttypes.CoulombType[coulomb.name])
    consts = nb_v2u.NbConstants.from_params(tparams, beta)
    f_t, ec_t, el_t = nb_v2u.cluster_forces_v2u(
        t(state.x), t(state.box), tl, tprep, consts,
        compute_energy=compute_energy)
    f_j = np.asarray(f_j)
    scale = float(np.abs(f_j).max())
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=2e-5 * scale)
    if compute_energy:
        np.testing.assert_allclose(float(ec_t), float(ec_j), rtol=1e-5)
        np.testing.assert_allclose(float(el_t), float(el_j), rtol=1e-5)


def test_cuda_tensor_never_takes_plain_path(lists, monkeypatch):
    """A non-CPU tensor must reach the kernel wrapper (which builds and
    launches, or raises) — never the plain version."""
    _, state, _, _, _, tl, tprep = lists
    called = []
    monkeypatch.setattr(nb_v2u, "nb_v2u_plain",
                        lambda *a, **k: called.append(1))
    monkeypatch.setattr(nb_v2u, "nb_v2u_cuda",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("cuda path")))
    fake = torch.empty((1, 1, 256), device="meta")
    with pytest.raises(RuntimeError, match="cuda path"):
        nb_v2u.nb_v2u_forces([fake] * 3, [fake] * 3, None, tprep, None,
                             True)
    assert not called
