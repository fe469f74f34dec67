"""Pair search: the port against the JAX package on identical inputs.

Exact agreement is required for the Hilbert permutation, the per-i-block
neighbour SETS (the packing order of a union list is not part of the
contract), the baked shifts of each (i-block, j-cluster) pair, the image
counts, the FEP pair set and every flag."""
import jax.numpy as jnp
import numpy as np
import pytest

from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import pairlist as jpl
from gromacs_fep_gpu_tpu_torch.ops import pairlist as tpl

from torch_bridge import t, to_port

RLIST = 0.65


@pytest.fixture(scope="module")
def lists():
    js, jst = solvation_system(n_side=7, seed=11)
    # one water unwrapped several boxes away: image counts must agree
    x = jst.x.at[40:43].add(jnp.array([2.0 * jst.box[0, 0], 0.0,
                                       -jst.box[2, 2]]))
    jst = jst.replace(x=x)
    jl = jpl.build_cluster_pairlist(x, jst.box, js, RLIST, nnbr=0,
                                    super_nnbr=192, super_block=4,
                                    compute_shifts=True)
    ts, tst = to_port(js, jst)
    tl = tpl.build_cluster_pairlist(tst.x, tst.box, ts, RLIST,
                                    super_nnbr=192, super_block=4,
                                    compute_shifts=True)
    return js, jst, jl, ts, tst, tl


def _sets(nbr, shift, C):
    out = []
    for b in range(nbr.shape[0]):
        row = {(int(j), tuple(int(s) for s in shift[b, k]))
               for k, j in enumerate(nbr[b]) if 0 <= j < C}
        out.append(row)
    return out


def test_permutation_and_sorted_data(lists):
    _, _, jl, _, _, tl = lists
    np.testing.assert_array_equal(tl.perm.numpy(), np.asarray(jl.perm))
    np.testing.assert_array_equal(tl.inv_perm.numpy(), np.asarray(jl.inv_perm))
    for k in ("q_a", "q_b", "t_a", "t_b", "pert", "excl"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(),
                                      np.asarray(getattr(jl, k)), err_msg=k)
    np.testing.assert_array_equal(tl.img.numpy(), np.asarray(jl.img))


def test_neighbour_sets_and_flags(lists):
    _, _, jl, _, _, tl = lists
    C = tl.n_clusters
    assert C == jl.n_clusters
    got = _sets(tl.nbr_super.numpy(), tl.super_shift.numpy(), C)
    want = _sets(np.asarray(jl.nbr_super), np.asarray(jl.super_shift), C)
    assert got == want
    for k in ("super_overflow", "super_max_count", "shift_overflow"):
        assert int(getattr(tl, k)) == int(getattr(jl, k)), k


def test_overflow_flags_when_capacity_short(lists):
    js, jst, _, ts, tst, _ = lists
    jl = jpl.build_cluster_pairlist(jst.x, jst.box, js, RLIST, nnbr=0,
                                    super_nnbr=32, super_block=4)
    tl = tpl.build_cluster_pairlist(tst.x, tst.box, ts, RLIST,
                                    super_nnbr=32, super_block=4)
    assert int(tl.super_overflow) == int(jl.super_overflow) > 0
    assert int(tl.super_max_count) == int(jl.super_max_count)


def test_two_level_search_matches(lists):
    """The tiled search used from 4,096 clusters on, called directly."""
    _, jst, _, _, tst, tl = lists
    rng = np.random.RandomState(4)
    L = float(jst.box[0, 0])
    C = 300
    lo = rng.uniform(0, L, (C, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 0.3, (C, 3)).astype(np.float32)
    qlo, qhi = lo[::4], hi[::4] + 0.1
    r2 = float(np.float32(RLIST ** 2))
    j_out = jpl._cluster_neighbors_2level(
        jnp.asarray(qlo), jnp.asarray(qhi), jnp.asarray(lo), jnp.asarray(hi),
        jst.box, r2, 96, tile_cap=6)
    t_out = tpl._cluster_neighbors_2level(t(qlo), t(qhi), t(lo), t(hi),
                                          tst.box, r2, 96, tile_cap=6)
    zero = np.zeros(np.asarray(j_out[0]).shape + (3,), np.int64)
    assert _sets(t_out[0].numpy(), zero, C) == _sets(np.asarray(j_out[0]),
                                                     zero, C)
    for a, b in zip(t_out[1:], j_out[-4:]):
        assert int(a) == int(b)


def test_fep_pairlist_and_exclusion_check(lists):
    js, jst, _, ts, tst, _ = lists
    pert = np.where(np.asarray(js.perturbed))[0]
    jf = jpl.build_fep_pairlist(jst.x, jst.box, js, RLIST, pert, max_nbr=96)
    tf = tpl.build_fep_pairlist(tst.x, tst.box, ts, RLIST, pert, max_nbr=96)

    def pairs(fl):
        ii, jj = np.asarray(fl.iidx), np.asarray(fl.jidx)
        inc, exc = np.asarray(fl.included), np.asarray(fl.excluded)
        return ({(int(i), int(j)) for i, j, m in zip(ii, jj, inc) if m},
                {(int(i), int(j)) for i, j, m in zip(ii, jj, exc) if m})
    assert pairs(tf) == pairs(jf)
    assert int(tf.n_overflow) == int(jf.n_overflow)
    for skip in (False, True):
        assert int(tpl.check_exclusions(tst.x, tst.box, ts, 0.2, skip)) == \
            int(jpl.check_exclusions(jst.x, jst.box, js, 0.2, skip))


def test_hilbert_sort_matches():
    rng = np.random.RandomState(9)
    box = np.diag([2.2, 2.5, 1.9]).astype(np.float32)
    x = rng.uniform(-1.0, 3.0, (700, 3)).astype(np.float32)
    jp = np.asarray(jpl.sort_atoms_by_cell(jnp.asarray(x), jnp.asarray(box),
                                           0.3))
    tp = tpl.sort_atoms_by_cell(t(x), t(box), 0.3).numpy()
    np.testing.assert_array_equal(tp, jp)
