"""Spatial domain decomposition: the port's mesh collectives, DD sorts,
halo geometry, the DD non-bonded routes (K6's plain version, the table
route on the halo) and the sharded PME against the JAX package's, with the
port's eight domains on the CPU and JAX's on the eight virtual CPU devices
of tests/conftest.py; then the port's DD runner against its single-domain
runner.

Tolerances: the collectives, the sorts and the halo-violation counts
exactly; the DD non-bonded routes at the reference fork's gates (energies
rel 1e-4, forces rel 5e-4 of the largest force); the sharded PME at the
gates of tests/test_parallel.py (energy rel 2e-5, dV/dlambda rel 1e-4 or
1e-3 absolute, forces 2e-3 absolute); the DD runner at the gates of the
JAX DD FEP test (Epot rel 1e-4; dV/dlambda at step 0 1e-5, first three
steps 1e-3, all 1e-2 / 5e-3; positions 2e-3 nm).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.models import solvation as jsolv
from gromacs_fep_gpu_tpu.models import water as jwater
from gromacs_fep_gpu_tpu.ops import pairlist as jpl
from gromacs_fep_gpu_tpu.ops.forces import get_beta as j_beta
from gromacs_fep_gpu_tpu.ops.pme import pme_grid_size
from gromacs_fep_gpu_tpu.parallel import mesh as jmesh
from gromacs_fep_gpu_tpu.parallel import spatial as jsp
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs
from gromacs_fep_gpu_tpu_torch.models import solvation as tsolv
from gromacs_fep_gpu_tpu_torch.ops import pairlist as tpl
from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import prepare_v2u
from gromacs_fep_gpu_tpu_torch.parallel import mesh as tmesh
from gromacs_fep_gpu_tpu_torch.parallel import spatial as tsp

from torch_bridge import (jax_cluster_list, jax_prepare_v2u, md_params,
                          port_cluster_list, to_port)

E_REL, F_REL = 1e-4, 5e-4
GRIDS = ((8, 1, 1), (4, 2, 1), (2, 2, 2))


def cpu_mesh():
    return tmesh.make_mesh(n_ens=1, n_spatial=8, devices=["cpu"] * 8)


def jax_mesh():
    return jmesh.make_mesh(n_ens=1, n_spatial=8)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def water(n_side, spacing, seed):
    """JAX water box and the port's copy of it."""
    js, jst = jwater.water_box(n_side, spacing=spacing, seed=seed)
    return js, jst, to_port(js, jst)


@functools.lru_cache(maxsize=None)
def solvated():
    """The JAX DD FEP test's system (n_side 8, 1,541 atoms) with the
    ligand at lambda_coul = lambda_vdw = 0.5, both packages."""
    js, jst = jsolv.solvation_system(n_side=8, spacing=0.31, seed=3,
                                     temperature=300.0)
    jst = jst.replace(lam=jst.lam.at[2].set(0.5).at[3].set(0.5))
    return js, jst, to_port(js, jst)


# -- mesh ------------------------------------------------------------------

COLLECTIVES = {
    "ppermute": (
        lambda a: jax.lax.ppermute(a, "spatial", [(0, 5), (2, 1), (7, 3)]),
        lambda p: tmesh.ppermute(p, [(0, 5), (2, 1), (7, 3)])),
    "psum": (lambda a: jax.lax.psum(a, "spatial"), tmesh.psum),
    "psum_scatter": (
        lambda a: jax.lax.psum_scatter(a, "spatial", scatter_dimension=1,
                                       tiled=True),
        lambda p: tmesh.psum_scatter(p, 1)),
    "all_to_all": (
        lambda a: jax.lax.all_to_all(a, "spatial", split_axis=1,
                                     concat_axis=0, tiled=True),
        lambda p: tmesh.all_to_all(p, split_dim=1, concat_dim=0)),
    "all_gather": (
        lambda a: jax.lax.all_gather(a, "spatial", axis=2, tiled=True),
        lambda p: tmesh.all_gather(p, dim=2)),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_matches_jax(name):
    """Each collective on 8 domains equals jax.lax's under shard_map
    (integer-valued data: sums are exact in any order)."""
    jfn, tfn = COLLECTIVES[name]
    a = np.random.default_rng(5).integers(-50, 50, (16, 8, 4)).astype(
        np.float32)
    run = shard_map(jfn, mesh=jax_mesh(), in_specs=P("spatial"),
                    out_specs=P("spatial"), check_vma=False)
    want = np.asarray(jax.jit(run)(a))
    parts = tfn([torch.tensor(a[2 * d:2 * d + 2]) for d in range(8)])
    got = torch.cat(parts).numpy()
    np.testing.assert_array_equal(got, want)


def test_make_mesh_places_domains():
    """Explicit devices fill the (ens, spatial) grid in order; devices=None
    means the CUDA cards, round-robin, and raises where there are none."""
    m = tmesh.make_mesh(n_spatial=4, devices=["cpu"] * 8)
    assert m.shape == {"ens": 2, "spatial": 4}
    assert m.home == torch.device("cpu")
    assert m.placement() == "4 domains on 1 device (cpu)"
    parts = tmesh.ens_sharding(m, torch.arange(6.0))
    assert [p.tolist() for p in parts] == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    assert len(tmesh.replicated(m, torch.zeros(2))) == 4
    if torch.cuda.is_available():
        m = tmesh.make_mesh(n_spatial=8)
        assert all(d.type == "cuda" for d in m.spatial_devices)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(n_spatial=8)


# -- sorts and geometry ----------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS + ("slab",), ids=str)
def test_dd_sort_matches_jax(grid):
    """sort_atoms_dd (and dd_geometry) on each grid, and the 1-D ring's
    slab order, give JAX's permutation exactly."""
    js, jst, (ts, tst) = water(8, 0.4, 23)
    vol = float(np.prod(np.diag(np.asarray(jst.box))))
    cell = (8 * vol / js.n_atoms) ** (1.0 / 3.0)
    if grid == "slab":
        want = jax.jit(lambda x, b: jpl.sort_atoms_by_cell(
            x, b, cell, slab_axis=0))(jst.x, jst.box)
        got = tpl.sort_atoms_by_cell(tst.x, tst.box, cell, slab_axis=0)
    else:
        ps = tpl.dd_geometry(ts.n_atoms, grid, 8)
        assert ps == jpl.dd_geometry(js.n_atoms, grid, 8)
        want = jax.jit(lambda x, b: jpl.sort_atoms_dd(
            x, b, cell, grid, ps[0]))(jst.x, jst.box)
        got = tpl.sort_atoms_dd(tst.x, tst.box, cell, grid, ps[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def small_list():
    """water_box(3): 81 atoms in 1.2 nm at rlist 0.6 with both list forms
    (the union list of 4-cluster blocks too): 8 slabs of 0.15 nm are far
    thinner than the cut-off."""
    js, jst, (ts, tst) = water(3, 0.4, 20)
    jl = jax_cluster_list(jst.x, jst.box, js, 0.6, nnbr=96, super_nnbr=64,
                          super_block=4)
    return jl, port_cluster_list(jl, jl.n_clusters)


@functools.lru_cache(maxsize=None)
def dd_list():
    """The solvated box's list on the (2, 2, 2) DD sort at dd_block 4,
    rlist 0.4: the per-cluster list and the union list of 4-cluster
    blocks, both sides.  No baked shifts: the DD sort's 4-cluster blocks
    are too extended for them in this 2.48 nm box (the runner then takes
    the in-loop minimum image)."""
    js, jst, _ = solvated()
    grid = (2, 2, 2)
    ps, _ = jpl.dd_geometry(js.n_atoms, grid, 4)
    jl = jax_cluster_list(jst.x, jst.box, js, 0.4, nnbr=128, super_nnbr=160,
                          super_block=4, dd_sort=(grid, ps))
    assert int(jl.super_overflow) == 0 and int(jl.n_overflow) == 0
    return jl, port_cluster_list(jl, jl.n_clusters)


PME_KW = dict(coulomb="pme", rcoulomb=0.35, rvdw=0.35, rlist=0.4,
              pme_grid=pme_grid_size((8 * 0.31,) * 3, 0.12))


@functools.lru_cache(maxsize=None)
def thick_list():
    """The JAX halo test's list: 8 slabs of 0.4 nm along x at rlist 0.3."""
    js, jst, (ts, tst) = water(8, 0.4, 23)
    jl = jax_cluster_list(jst.x, jst.box, js, 0.3, nnbr=64, slab_axis=0)
    return jl, port_cluster_list(jl, jl.n_clusters)


@pytest.mark.parametrize("case", ["thin", "thick"])
def test_halo_violations_match_jax(case):
    """The count of pairs beyond the +-1 halo equals JAX's: > 0 for 0.15
    nm slabs at rlist 0.6, 0 for 0.4 nm slabs at rlist 0.3."""
    jl, tl = small_list() if case == "thin" else thick_list()
    want = int(jsp.halo_violations(jl, 8, 2))
    got = int(tsp.halo_violations(tl, 8, 2))
    assert got == want
    assert (got > 0) == (case == "thin")


# -- the DD non-bonded routes ----------------------------------------------

def test_k6_plain_matches_jax():
    """K6's plain version (per domain: the cat-plane gather, then the v2u
    body) against JAX make_dd_v2u_override in interpret mode at (2, 2, 2),
    dd_block 4, on the same DD-sorted union list with baked shifts."""
    js, jst, (ts, tst) = solvated()
    jp, tp = md_params(jtypes, **PME_KW), md_params(ttypes, **PME_KW)
    grid = (2, 2, 2)
    jl, tl = dd_list()
    jnb = jsp.make_dd_v2u_override(js, jp, jax_mesh(), j_beta(jp), block=4,
                                   grid=grid, interpret=True)
    f_j, ec_j, el_j = jax.jit(functools.partial(jnb, need_energy=True))(
        jst.x, jst.box, jl, jax_prepare_v2u(jl, js.nbfp))
    tnb = tsp.make_dd_v2u_override(ts, tp, cpu_mesh(), get_beta(tp),
                                   block=4, grid=grid)
    pack = tnb.prepare(tl, prepare_v2u(tl, ts.nbfp))
    f_t, ec_t, el_t = tnb(tst.x, tst.box, tl, pack)
    assert rel(f_t, f_j) <= F_REL
    assert rel(ec_t, ec_j) <= E_REL and rel(el_t, el_j) <= E_REL
    assert float(el_j) != 0.0


@pytest.mark.parametrize("shifts", ["baked", "min-image"])
def test_k6_plain_matches_k1_plain(shifts):
    """K6's plain version over the 8 domains against K1's on one domain,
    on the same DD-sorted union list (the port's own builder), with baked
    shifts and with the in-loop minimum image: the same blocks see the
    same j lanes, so forces agree to rounding."""
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import (NbConstants,
                                                      cluster_forces_v2u)
    _, _, (ts, tst) = solvated()
    tp = md_params(ttypes, **PME_KW)
    grid = (2, 2, 2)
    tl = tpl.build_cluster_pairlist(
        tst.x, tst.box, ts, 0.4, super_nnbr=160, super_block=4,
        compute_shifts=shifts == "baked",
        dd_sort=(grid, tpl.dd_geometry(ts.n_atoms, grid, 4)[0]))
    prep = prepare_v2u(tl, ts.nbfp)
    assert (prep.shift is not None) == (shifts == "baked")
    f1, ec1, el1 = cluster_forces_v2u(
        tst.x, tst.box, tl, prep, NbConstants.from_params(tp, get_beta(tp)))
    tnb = tsp.make_dd_v2u_override(ts, tp, cpu_mesh(), get_beta(tp),
                                   block=4, grid=grid)
    f8, ec8, el8 = tnb(tst.x, tst.box, tl, prep)
    assert rel(f8, f1) <= 1e-6
    assert rel(ec8, ec1) <= 1e-6 and rel(el8, el1) <= 1e-6


@pytest.mark.parametrize("grid", [(8, 1, 1), (2, 2, 2)], ids=str)
def test_table_halo_route_matches_jax(grid):
    """make_halo_cluster_force (the table kernel's plain version on each
    domain's i-cluster range of its cat plane) against JAX's on the same
    list: the 1-D ring on the slab-sorted water box (reaction field,
    dd_block 2), the 3-D grid on the DD-sorted solvated box (PME, dd_block
    4)."""
    if grid == (8, 1, 1):
        js, jst, (ts, tst) = water(8, 0.4, 23)
        kw = dict(coulomb="reaction-field", rcoulomb=0.25, rvdw=0.25,
                  rlist=0.3)
        (jl, tl), block = thick_list(), 2
    else:
        js, jst, (ts, tst) = solvated()
        kw = PME_KW
        (jl, tl), block = dd_list(), 4
    jp, tp = md_params(jtypes, **kw), md_params(ttypes, **kw)
    _, c_pad = jsp.halo_shard_geometry(jl, grid, block)
    halo = jsp.make_halo_cluster_force(js, jp, jax_mesh(), j_beta(jp), jl,
                                       block=block, grid=grid)
    f_j, ec_j, el_j = jax.jit(halo)(jsp.sort_state_arrays(jst.x, jl, c_pad),
                                    jst.box)
    thalo = tsp.make_halo_cluster_force(ts, tp, cpu_mesh(), get_beta(tp),
                                        tl, block=block, grid=grid)
    f_t, ec_t, el_t = thalo(tsp.sort_state_arrays(tst.x, tl, c_pad),
                            tst.box)
    assert rel(f_t, f_j) <= F_REL
    assert rel(ec_t, ec_j) <= E_REL and rel(el_t, el_j) <= E_REL


DD_TABLE_PACKS = tuple(f"domain{s}" for s in range(8)) + ("range",)


@functools.lru_cache(maxsize=None)
def dd_table_packs():
    """The table packs of (2, 2, 2) on the DD-sorted solvated box at
    dd_block 4, each with its planes: the eight domains' i-cluster ranges
    of their cat planes (make_halo_cluster_force), then the upper half of
    the replicated route's pack (_range_pack); and the run's constants."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants
    _, _, (ts, tst) = solvated()
    tp = md_params(ttypes, **PME_KW)
    consts = NbConstants.from_params(tp, get_beta(tp))
    grid, block = (2, 2, 2), 4
    _, tl = dd_list()
    _, c_pad = tsp.halo_shard_geometry(tl, grid, block)
    thalo = tsp.make_halo_cluster_force(ts, tp, cpu_mesh(), get_beta(tp),
                                        tl, block=block, grid=grid)
    cats = thalo.planes(tsp.sort_state_arrays(tst.x, tl, c_pad))
    prep = nb_cluster.prepare_table(tl, ts.nbfp, "geometric")
    planes = nb_cluster.gather_planes(tst.x, tst.box, tl, prep)
    c0 = prep.n_icl // 2
    cases = [(list(c), p) for c, p in zip(cats, thalo.packs)]
    cases.append((planes, tsp._range_pack(prep, c0, prep.n_icl, "cpu")))
    return dict(zip(DD_TABLE_PACKS, cases)), tst.box, consts


@pytest.mark.parametrize("name", DD_TABLE_PACKS)
def test_table_cull_on_a_dd_pack(name):
    """The table kernel's tile cull (its plain mirror) on a domain's
    i-cluster range of its cat plane, and on a range pack of the replicated
    route: the pack starts past cluster 0 of its planes (i0 > 0), no
    skipped tile holds a pair in the cut-off, and a pack with live entries
    skips some tiles."""
    import chip_smoke
    packs, box, consts = dd_table_packs()
    planes, pack = packs[name]
    assert pack.i0 > 0 and pack.halo
    bad, keep, live = chip_smoke.table_culled_close_pairs(planes, box, pack,
                                                          consts)
    assert bad == 0
    if bool(live.any()):        # a domain may own only padding
        assert 0.0 < float(keep[live].float().mean()) < 1.0


def test_table_dd_packs_have_live_entries():
    """At most one of the table packs that the cull is held on owns only
    padding (no live entry)."""
    packs = dd_table_packs()[0]
    n_live = sum(int(p.cnt.max()) > 0 for _, p in packs.values())
    assert n_live >= len(packs) - 1


@pytest.mark.parametrize("cnt_max", [None, 7, 10_000],
                         ids=["capacity", "given", "past-capacity"])
def test_halo_packs_take_the_longest_row(cnt_max):
    """make_halo_cluster_force gives every domain's table pack the list's
    longest row (the given one capped at the row capacity W, or W when
    None) and the table kernel's warps per i-cluster for it: 1 on the CPU,
    which has no SMs."""
    _, _, (ts, tst) = solvated()
    tp = md_params(ttypes, **PME_KW)
    _, tl = dd_list()
    thalo = tsp.make_halo_cluster_force(ts, tp, cpu_mesh(), get_beta(tp),
                                        tl, block=4, grid=(2, 2, 2),
                                        cnt_max=cnt_max)
    W = tl.nbr.shape[1]
    want = W if cnt_max is None else min(cnt_max, W)
    assert [p.cnt_max for p in thalo.packs] == [want] * 8
    assert [p.warps for p in thalo.packs] == [1] * 8


@pytest.mark.parametrize("dd", [False, True], ids=["one-domain", "dd"])
def test_runner_table_packs_take_the_rebuilds_longest_row(dd):
    """The runner's table route hands each rebuild's n_max flag (the
    list's longest row, read back with the other flags) to its packs: the
    whole-system pack, or every domain's pack under DD."""
    _, _, (ts, tst) = solvated()
    mesh = dict(mesh=cpu_mesh(), dd_block=4, dd_grid=(2, 2, 2)) if dd \
        else {}
    r = MdRunner(ts, _fep_params(), RunnerConfig(layout="table", nnbr=96,
                                                 **mesh))
    assert r.layout == "table"
    nlist, _, prep, fl = r.rebuild(tst)
    assert fl["n_max"] == int(nlist.max_count) > 0
    packs = prep.packs if dd else [prep]
    assert [(p.cnt_max, p.warps) for p in packs] == \
        [(fl["n_max"], 1)] * len(packs)
    if not dd:
        assert int(prep.cnt.max()) == fl["n_max"]


def test_spatial_cluster_force_matches_jax():
    """Replicated positions, the i-cluster block range split over 8
    domains (make_spatial_cluster_force), against JAX's."""
    js, jst, (ts, tst) = water(3, 0.4, 20)
    kw = dict(coulomb="reaction-field", rcoulomb=0.55, rvdw=0.55,
              rlist=0.6)
    jp, tp = md_params(jtypes, **kw), md_params(ttypes, **kw)
    jl, tl = small_list()
    f_j, ec_j, el_j = jax.jit(jsp.make_spatial_cluster_force(
        js, jp, jax_mesh(), None, block=16))(jst.x, jst.box, jl)
    f_t, ec_t, el_t = tsp.make_spatial_cluster_force(
        ts, tp, cpu_mesh(), None, block=16)(tst.x, tst.box, tl)
    assert rel(f_t, f_j) <= F_REL
    assert rel(ec_t, ec_j) <= E_REL and rel(el_t, el_j) <= E_REL


# -- PME -------------------------------------------------------------------

def test_sharded_pme_matches_jax():
    """make_sharded_pme (per-domain spread, slab/pencil transforms, the
    E[dq] term) against JAX's on the JAX test's perturbed box."""
    js, jst = jsolv.solvation_system(n_side=4, spacing=0.35, seed=5,
                                     temperature=300.0)
    ts, tst = to_port(js, jst)
    kw = dict(coulomb="pme", rcoulomb=0.6, rvdw=0.6, rlist=0.65,
              pme_grid=pme_grid_size((4 * 0.35,) * 3, 0.12),
              fep=dict(enabled=True, sc_alpha=0.5, sc_coul=True))
    jp, tp = md_params(jtypes, **kw), md_params(ttypes, **kw)
    e_j, f_j, d_j = jax.jit(jsp.make_sharded_pme(js, jp, jax_mesh()))(
        jst.x, jst.box, np.float32(0.3))
    e_t, f_t, d_t = tsp.make_sharded_pme(ts, tp, cpu_mesh())(
        tst.x, tst.box, torch.tensor(0.3))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=2e-5)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=2e-3)


# -- the runner ------------------------------------------------------------

def _fep_params():
    return ttypes.MdParams(
        dt=0.001, nstlist=10, coulomb=ttypes.CoulombType.PME,
        rcoulomb=0.28, rvdw=0.28, rlist=0.3,
        pme_grid=pme_grid_size((8 * 0.31,) * 3, 0.12),
        tcoupl=ttypes.TcouplType.V_RESCALE, ref_t=300.0, nsttcouple=10,
        nstcomm=0, fep=ttypes.FepParams(enabled=True, sc_alpha=0.5,
                                        sc_coul=True, sc_sigma=0.3))


def test_dd_runner_matches_single_domain():
    """The port's MdRunner on a (2, 2, 2) grid (K6's plain version, the
    sharded PME) against its single-domain runner on the table route (an
    independent non-bonded route; K6 against K1 is
    test_k6_plain_matches_k1_plain): the perturbed solvation box at lambda
    0.5, 20 steps."""
    _, _, (ts, tst) = solvated()
    params = _fep_params()
    s1, l1 = MdRunner(ts, params, RunnerConfig(
        layout="table", nnbr=96, seed=7)).run(tst, 20)
    dd = MdRunner(ts, params, RunnerConfig(
        mesh=cpu_mesh(), dd_block=4, dd_grid=(2, 2, 2), super_nnbr=128,
        seed=7))
    assert dd.layout == "v2u" and dd.mesh is not None
    s2, l2 = dd.run(tst, 20)
    l1, l2 = concat_logs(l1), concat_logs(l2)
    assert bool(torch.isfinite(l2.epot).all())
    np.testing.assert_allclose(l2.epot.numpy(), l1.epot.numpy(), rtol=1e-4)
    d1, d2 = l1.dvdl[:, 2:4].numpy(), l2.dvdl[:, 2:4].numpy()
    np.testing.assert_allclose(d2[0], d1[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d2[:3], d1[:3], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(d2, d1, rtol=1e-2, atol=5e-3)
    np.testing.assert_allclose(s2.x.numpy(), s1.x.numpy(), atol=2e-3)


def test_dd_runner_fails_hard_on_thin_slabs():
    """A cut-off longer than the slab aborts at the rebuild (JAX's
    message), on the table route the K7 layouts demote to under DD."""
    system, state = tsolv.solvation_system(n_side=4, spacing=0.4, seed=32,
                                           device="cpu")
    params = ttypes.MdParams(dt=0.001, nstlist=10,
                             coulomb=ttypes.CoulombType.REACTION_FIELD,
                             rcoulomb=0.55, rvdw=0.55, rlist=0.6, nstcomm=0)
    r = MdRunner(system, params, RunnerConfig(
        layout="cluster", nnbr=96, mesh=cpu_mesh(), dd_block=2))
    assert r.layout == "table"
    with pytest.raises(RuntimeError, match="halo|slab"):
        r.run(state, 10)


def test_dd_runner_rejects_what_is_not_ported():
    """Pressure coupling under DD and a grid that does not cover the mesh
    raise at construction."""
    system, _ = tsolv.solvation_system(n_side=4, device="cpu")
    params = _fep_params()
    with pytest.raises(NotImplementedError, match="pressure"):
        MdRunner(system, params.replace(
            pcoupl=ttypes.PcouplType.C_RESCALE, nstpcouple=10),
            RunnerConfig(mesh=cpu_mesh()))
    with pytest.raises(ValueError, match="dd_grid"):
        MdRunner(system, params, RunnerConfig(mesh=cpu_mesh(),
                                              dd_grid=(2, 2, 1)))


@pytest.mark.parametrize("devices", [["cuda:0"] * 8,
                                     ["cpu"] * 4 + ["cuda:0"] * 4],
                         ids=["cuda", "mixed"])
def test_dd_runner_rejects_a_mesh_on_another_device(devices):
    """Domains run on the system's kind of device: a mesh that places any
    of them elsewhere raises at construction (no silent copy of the
    non-bonded and PME work to another device)."""
    system, _ = tsolv.solvation_system(n_side=4, device="cpu")
    mesh = tmesh.make_mesh(n_spatial=8, devices=devices)
    with pytest.raises(ValueError, match="domains lie on"):
        MdRunner(system, _fep_params(), RunnerConfig(mesh=mesh,
                                                     dd_grid=(2, 2, 2)))
