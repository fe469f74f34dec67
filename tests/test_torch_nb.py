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
from gromacs_fep_gpu_tpu.ops.pallas_nb import pallas_cluster_forces_v2u
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.ops import nb_v2u

import chip_smoke
from torch_bridge import (jax_cluster_list, jax_prepare_v2u,
                          port_cluster_list, t, to_port)


@pytest.fixture(scope="module", params=[True, False],
                ids=["baked_shifts", "min_image"])
def lists(request):
    baked = request.param
    system, state = water_box(8, spacing=0.31, seed=30)
    # an unwrapped molecule several images away: the baked-shift path must
    # re-enter the rebuild frame through nlist.img
    x = state.x.at[30:33].add(jnp.array([2.0 * state.box[0, 0],
                                         -3.0 * state.box[1, 1], 0.0]))
    jl = jax_cluster_list(x, state.box, system, 0.6, nnbr=0,
                          super_nnbr=192, super_block=4,
                          compute_shifts=baked)
    assert int(jl.super_overflow) == 0
    if baked:
        assert int(jl.shift_overflow) == 0
    jprep = jax_prepare_v2u(jl, system.nbfp)
    ts, _ = to_port(system, state.replace(x=x))
    tl = port_cluster_list(jl, jl.n_clusters)
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
    fake = torch.empty((3, 8 * (tprep.nbr2.shape[0] * nb_v2u.BU + 1)),
                       device="meta")
    with pytest.raises(RuntimeError, match="cuda path"):
        nb_v2u.nb_v2u_forces(fake, None, tprep, None, True)
    assert not called


def _consts():
    tparams = ttypes.MdParams(rcoulomb=0.55, rvdw=0.55, rlist=0.6,
                              coulomb=ttypes.CoulombType.PME)
    return nb_v2u.NbConstants.from_params(tparams, 3.5)


def _plane(lists):
    _, state, _, _, _, tl, tprep = lists
    return nb_v2u.sorted_plane(t(state.x), t(state.box), tl, tprep)


def _culled_close_pairs(plane, box, prep, consts):
    """(number of masked-in pairs with r^2 < rmax2 in tiles that
    cull_tiles_plain skips, the keep mask, the live-group mask)."""
    keep = nb_v2u.cull_tiles_plain(plane, 0, box, prep, consts)
    ip, jp = nb_v2u.gather_cat(plane, 0, box, prep)
    S, G = prep.nbr2.shape[:2]
    d = [a.reshape(S, 1, 32, 1) - b.reshape(S, G, 1, 256)
         for a, b in zip(ip, jp)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    bit = torch.arange(32, dtype=torch.int32).reshape(1, 1, 32, 1)
    live = torch.arange(G)[None, :] < prep.ng[:, None].to(torch.int64)
    pair = ((prep.pair_m[:, :, None, :] >> bit) & 1).bool() \
        & live[:, :, None, None]
    kept = keep.repeat_interleave(4, 2).repeat_interleave(8, 3)
    rmax2 = max(consts.rc2, consts.rv2)
    return int((pair & ~kept & (r2 < rmax2)).sum()), keep, live


def test_cull_tiles_plain_never_skips_a_pair_in_the_cutoff(lists):
    """The plain mirror of the kernel's tile cull: on the JAX-built frame
    no skipped tile holds a masked-in pair inside the cut-off, and some
    tiles are skipped; with a pair placed at r^2 = rmax2 (1 -+ 1e-6) on the
    tile's box distance the tile is kept (inside: it must be; outside: the
    margin keeps it); a tile with a NaN coordinate is never skipped.
    Without baked shifts nothing is culled."""
    _, state, _, _, _, tl, tprep = lists
    consts, box = _consts(), t(state.box)
    plane = _plane(lists)
    bad, keep, live = _culled_close_pairs(plane, box, tprep, consts)
    assert bad == 0
    if tprep.shift is None:
        assert bool(keep.all())
        return
    kept = float(keep[live].float().mean())
    assert 0.0 < kept < 1.0
    rmax2 = max(consts.rc2, consts.rv2)
    for sign in (-1.0, 1.0):
        moved, (s, g, h, k, a, b) = chip_smoke.place_boundary_pair(
            plane, box, tprep, rmax2, sign)
        bad, keep, _ = _culled_close_pairs(moved, box, tprep, consts)
        ip, jp = nb_v2u.gather_cat(moved, 0, box, tprep)
        r2 = sum(float(ip[d].reshape(-1)[a] - jp[d][s, g, 8 * k + b % 8])
                 ** 2 for d in range(3))
        # on the intended side of the cut-off, within rounding
        assert sign * (r2 - rmax2) > 0.0
        assert abs(r2 / rmax2 - (1.0 + sign * 1e-6)) < 1e-6
        assert bad == 0 and bool(keep[s, g, h, k])
    row = int(tprep.nbr2[0, 0, 3]) * 8 + 5
    nan_plane = plane.clone()
    nan_plane[1, row] = float("nan")
    keep = nb_v2u.cull_tiles_plain(nan_plane, 0, box, tprep, consts)
    if row < 32 * tprep.nbr2.shape[0]:
        assert bool(keep[row // 32, :, (row % 32) // 4].all())
    hit = tprep.nbr2 == row // 8
    assert bool(hit.any()) and bool(keep.permute(0, 1, 3, 2)[hit].all())


def test_sorted_plane_gathers_to_the_cpu_route_bitwise(lists):
    """The plane that the CUDA route passes, gathered by nbr2 + shift as
    the kernel gathers it (gather_cat), equals gather_coordinates' i and j
    planes bit for bit."""
    _, state, _, _, _, tl, tprep = lists
    box = t(state.box)
    ip, jp = nb_v2u.gather_cat(_plane(lists), 0, box, tprep)
    ic, jc = nb_v2u.gather_coordinates(t(state.x), box, tl, tprep)
    for a, b in zip(ip + jp, ic + jc):
        assert torch.equal(a, b)
    assert tprep.nbr32.dtype == torch.int32
    assert torch.equal(tprep.nbr32.to(torch.int64), tprep.nbr2)
    assert tprep.ng_max == int(tprep.ng.max())


@pytest.mark.parametrize("S, ng_max, want", [
    (10_000, 30, 1),      # a grid of many waves: no split
    (385, 10, 5),         # K1 at 12,290 atoms on 132 SMs x 4 CTAs
    (50, 40, 32),         # a K6 domain launch
    (50, 23, 23),         # capped by the groups a block has
    (0, 0, 1)])
def test_split_count(S, ng_max, want):
    assert nb_v2u.split_count(S, ng_max, 132, 4) == want
