"""K2/K3 (PME spread and gather) and the PME reciprocal pair: the port's
plain versions against the JAX Pallas kernels in interpret mode and
against make_pme_recip_pair.

Tolerances: grids and gathered values 5e-6 of their largest magnitude
(tests/test_pme_blocked.py's gate: same splines, different summation
order); reciprocal energy and dV/dlambda rel 1e-5, forces 1e-5 of the
largest force (torch.fft in place of the matmul DFT).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core.types import MdParams as JMdParams
from gromacs_fep_gpu_tpu.core.types import CoulombType as JCoulombType
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import pme as jpme
from gromacs_fep_gpu_tpu.ops import pme_blocked as pb
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.ops import pme as tpme
from gromacs_fep_gpu_tpu_torch.ops import pme_kernels

from torch_bridge import t, to_port


def _setup(n=500, K=(16, 16, 16), L=2.4, seed=0):
    rng = np.random.RandomState(seed)
    box = np.eye(3, dtype=np.float32) * L
    # some atoms outside the box and exactly on its faces: the wrap and the
    # mod of the tap indices must agree
    x = rng.uniform(-L, 2 * L, (n, 3)).astype(np.float32)
    x[:3] = [[0.0, L, 0.5 * L], [L, 0.0, 0.0], [-L, 2 * L, L]]
    q = rng.uniform(-1, 1, n)
    q = (q - q.mean()).astype(np.float32)
    nb, amax = pb.choose_blocks(K, n)
    blocks = pb.build_pme_blocks(jnp.asarray(x), jnp.asarray(box), K, nb,
                                 amax)
    assert int(blocks.n_overflow) == 0
    return x, box, q, K, blocks


def test_spread_plain_matches_pallas():
    x, box, q, K, blocks = _setup()
    g_ref = np.asarray(pb.blocked_spread_pallas(
        jnp.asarray(x), jnp.asarray(box), jnp.asarray(q), K, blocks,
        interpret=True))
    g = pme_kernels.spread(t(x), t(box), t(q), K).numpy()
    np.testing.assert_allclose(g, g_ref, atol=5e-6 * np.abs(g_ref).max())


def test_gather_plain_matches_pallas():
    x, box, q, K, blocks = _setup(seed=1)
    phi = np.random.RandomState(2).normal(size=K).astype(np.float32)
    f_ref, d_ref = pb.blocked_phi_gather_pallas(
        jnp.asarray(x), jnp.asarray(box), jnp.asarray(q), jnp.asarray(phi),
        K, blocks, interpret=True)
    f, d = pme_kernels.gather(t(x), t(box), t(q), t(phi), K)
    f_ref, d_ref = np.asarray(f_ref), np.asarray(d_ref)
    np.testing.assert_allclose(f.numpy(), f_ref,
                               atol=5e-6 * np.abs(f_ref).max())
    np.testing.assert_allclose(d.numpy(), d_ref,
                               atol=5e-6 * np.abs(d_ref).max())


def test_gather_matches_any_order_phi_gather():
    """The order-4 kernel gather equals the generic-order plain gather."""
    x, box, q, K, _ = _setup(seed=3)
    phi = torch.randn(K, generator=torch.Generator().manual_seed(0))
    f, d = pme_kernels.gather(t(x), t(box), t(q), phi, K)
    f2, d2 = tpme.phi_gather(t(x), t(box), t(q), phi, K)
    torch.testing.assert_close(f, f2, rtol=0, atol=5e-6 * float(f2.abs().max()))
    torch.testing.assert_close(d, d2, rtol=0, atol=5e-6 * float(d2.abs().max()))


def test_nonfinite_atom_poisons_grid():
    x, box, q, K, _ = _setup(seed=4)
    x[7, 1] = np.nan
    assert torch.isnan(pme_kernels.spread(t(x), t(box), t(q), K)).any()
    f, d = pme_kernels.gather(t(x), t(box), t(q), torch.ones(K), K)
    assert torch.isnan(f[7]).all() and torch.isnan(d[7])


@pytest.mark.parametrize("lam_c", [0.5, 0.2])
def test_recip_pair_matches_jax(lam_c):
    """E, F and dvdl_c of the lambda-mixed reciprocal sum with the exact
    lambda(1-lambda) E[dq] correction (solvation ligand decoupled)."""
    js, jst = solvation_system(n_side=6, seed=3)
    grid = jpme.pme_grid_size([6 * 0.31] * 3, 0.12)
    jp = JMdParams(coulomb=JCoulombType.PME, rcoulomb=0.6, rvdw=0.6,
                   pme_grid=grid)
    e_fn_j, f_fn_j = jpme.make_pme_recip_pair(js, jp)
    e_j, f_j, dvdl_j = f_fn_j(jst.x, jst.box, lam_c)
    e_ad_j = e_fn_j(jst.x, jst.box, lam_c)

    ts, tst = to_port(js, jst)
    tp = ttypes.MdParams(coulomb=ttypes.CoulombType.PME, rcoulomb=0.6,
                         rvdw=0.6, pme_grid=tuple(grid))
    e_fn_t, f_fn_t = tpme.make_pme_recip_pair(ts, tp)
    lam = torch.tensor(lam_c)
    e_t, f_t, dvdl_t = f_fn_t(tst.x, tst.box, lam)
    e_ad_t = e_fn_t(tst.x, tst.box, lam)

    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(float(e_ad_t), float(e_ad_j), rtol=1e-5)
    np.testing.assert_allclose(float(e_t), float(e_ad_t), rtol=1e-5)
    np.testing.assert_allclose(float(dvdl_t), float(dvdl_j), rtol=1e-5,
                               atol=1e-5 * abs(float(e_j)))
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j,
                               atol=1e-5 * np.abs(f_j).max())


def test_non_cpu_tensor_never_takes_plain_path(monkeypatch):
    """A tensor that is not on the CPU reaches the kernel wrappers, which
    launch or raise; the plain versions are never called for it."""
    called = []
    monkeypatch.setattr(pme_kernels, "spread_plain",
                        lambda *a: called.append("spread"))
    monkeypatch.setattr(pme_kernels, "gather_plain",
                        lambda *a: called.append("gather"))
    x = torch.empty((4, 3), device="meta")
    box, q = torch.empty((3, 3), device="meta"), torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pme_kernels.spread(x, box, q, (8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pme_kernels.gather(x, box, q, torch.empty((8, 8, 8), device="meta"),
                           (8, 8, 8))
    assert not called
