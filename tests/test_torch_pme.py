"""K2/K3 and K4/K5 (PME spread and gather) and the PME reciprocal pair: the
port's plain versions against the JAX Pallas kernels in interpret mode and
against make_pme_recip_pair.

Tolerances: grids and gathered values 5e-6 of their largest magnitude
(tests/test_pme_blocked.py's gate: same splines, different summation
order); against the small-system TPU kernels spread_charges_pallas and
phi_gather_pallas the gates of tests/test_pme.py, grid atol 1e-5 and
forces and dE/dq 3e-5 of the largest (those kernels multiply in three bf16
passes); reciprocal energy and dV/dlambda rel 1e-5, forces 1e-5 of the
largest force (torch.fft in place of the matmul DFT).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core.types import MdParams as JMdParams
from gromacs_fep_gpu_tpu.core.types import CoulombType as JCoulombType
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops import pme as jpme
from gromacs_fep_gpu_tpu.ops import pme_blocked as pb
from gromacs_fep_gpu_tpu.ops import pme_pallas as pp
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


def _small(n, seed):
    """The inputs of tests/test_pme.py's Pallas spread/gather tests."""
    rng = np.random.RandomState(seed)
    box = np.eye(3, dtype=np.float32) * 2.0
    x = rng.uniform(0, 2.0, (n, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, n).astype(np.float32)
    return rng, x, box, q, (20, 24, 28)


def test_spread_dispatch_matches_small_system_pallas_and_xla():
    """K4: the size-free dispatch (plain version on the CPU) against
    spread_charges_pallas in interpret mode and its XLA twin."""
    _, x, box, q, K = _small(257, 3)
    jx, jb, jq = jnp.asarray(x), jnp.asarray(box), jnp.asarray(q)
    g = tpme._spread_dispatch(t(x), t(box), t(q), K, 4).numpy()
    g_pl = np.asarray(pp.spread_charges_pallas(jx, jb, jq, K, interpret=True))
    g_xla = np.asarray(jpme.spread_charges(jx, jb, jq, K))
    np.testing.assert_allclose(g, g_pl, atol=1e-5)
    np.testing.assert_allclose(g, g_xla, atol=5e-6 * np.abs(g_xla).max())
    # order 5 has no kernel: the plain scatter, on the CPU only
    g5 = tpme._spread_dispatch(t(x), t(box), t(q), K, 5).numpy()
    g5_xla = np.asarray(jpme.spread_charges(jx, jb, jq, K, 5))
    np.testing.assert_allclose(g5, g5_xla, atol=5e-6 * np.abs(g5_xla).max())


def test_gather_matches_small_system_pallas():
    """K5: the body that the GPU route of phi_gather stands on (the kernel
    wrapper's plain version) against phi_gather_pallas in interpret mode."""
    rng, x, box, q, K = _small(130, 4)
    phi = rng.normal(size=K).astype(np.float32)
    f_pl, d_pl = pp.phi_gather_pallas(
        jnp.asarray(x), jnp.asarray(box), jnp.asarray(q), jnp.asarray(phi),
        K, interpret=True)
    f, d = pme_kernels.gather(t(x), t(box), t(q), t(phi), K)
    f_pl, d_pl = np.asarray(f_pl), np.asarray(d_pl)
    np.testing.assert_allclose(f.numpy(), f_pl,
                               atol=3e-5 * np.abs(f_pl).max())
    np.testing.assert_allclose(d.numpy(), d_pl,
                               atol=3e-5 * np.abs(d_pl).max())


@pytest.mark.parametrize("order", [4, 5])
def test_phi_gather_matches_xla(order):
    """phi_gather on CPU tensors (the einsum body, any order) against the
    JAX phi_gather."""
    rng, x, box, q, K = _small(130, 4)
    phi = rng.normal(size=K).astype(np.float32)
    f_j, d_j = jpme.phi_gather(jnp.asarray(x), jnp.asarray(box),
                               jnp.asarray(q), jnp.asarray(phi), K, order)
    f, d = tpme.phi_gather(t(x), t(box), t(q), t(phi), K, order)
    f_j, d_j = np.asarray(f_j), np.asarray(d_j)
    np.testing.assert_allclose(f.numpy(), f_j, atol=5e-6 * np.abs(f_j).max())
    np.testing.assert_allclose(d.numpy(), d_j, atol=5e-6 * np.abs(d_j).max())


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
    # under jax.jit: one compile instead of an eager compile per operation
    e_j, f_j, dvdl_j = jax.jit(f_fn_j)(jst.x, jst.box, lam_c)
    e_ad_j = jax.jit(e_fn_j)(jst.x, jst.box, lam_c)

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


def test_pme_entry_points_dispatch_on_device_type_alone(monkeypatch):
    """No public entry point of ops/pme.py runs a plain version for a
    tensor that is not on the CPU: _spread_dispatch, phi_gather,
    reciprocal_energy_force and the energy-only reciprocal_energy reach the
    kernel wrappers (which raise here, there being no GPU); order 5 has no
    kernel and raises.  A launch counter moves only where a kernel is
    launched."""
    called = []
    for mod, name in ((pme_kernels, "spread_plain"),
                      (pme_kernels, "gather_plain"),
                      (tpme, "phi_gather_plain"),
                      (tpme, "spread_charges_scatter")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: called.append(_n))
    K = (8, 8, 8)
    x = torch.empty((4, 3), device="meta")
    box, q = torch.empty((3, 3), device="meta"), torch.empty(4, device="meta")
    phi = torch.empty(K, device="meta")
    infl = tuple(torch.empty(s, device="meta")
                 for s in ((8,), (8,), (8,), K))
    pme_kernels.launches.clear()
    for call in (
            lambda: tpme._spread_dispatch(x, box, q, K, 4),
            lambda: tpme.phi_gather(x, box, q, phi, K),
            lambda: tpme.reciprocal_energy_force(x, box, q, K, 3.0, 4, infl),
            lambda: tpme.reciprocal_energy(x, box, q, K, 3.0, 4, infl)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for call in (lambda: tpme._spread_dispatch(x, box, q, K, 5),
                 lambda: tpme.phi_gather(x, box, q, phi, K, 5)):
        with pytest.raises(NotImplementedError, match="order 4"):
            call()
    assert not called and not pme_kernels.launches
    # CPU tensors take the plain versions, and count no launch
    xc = torch.rand((4, 3))
    tpme.phi_gather(xc, torch.eye(3), torch.ones(4), torch.ones(K), K)
    tpme._spread_dispatch(xc, torch.eye(3), torch.ones(4), K, 4)
    assert called == ["phi_gather_plain", "spread_plain"]
    assert not pme_kernels.launches
