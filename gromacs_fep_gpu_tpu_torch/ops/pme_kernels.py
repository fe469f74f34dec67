"""PME charge spread (K2, K4) and potential gather (K3, K5) — PyTorch/CUDA
counterpart of gromacs_fep_gpu_tpu/ops/pme_blocked.py (_w4,
_spread_kernel / blocked_spread_pallas, _gather_kernel /
blocked_phi_gather_pallas) and of gromacs_fep_gpu_tpu/ops/pme_pallas.py
(_spread_kernel / spread_charges_pallas, _gather_kernel /
phi_gather_pallas).

The Hopper kernels (csrc/pme_spline.cu) work on the global grid, so the
TPU designs' atom bucketing (build_pme_blocks), block windows and
overlap-add fold (K2/K3), and whole-grid one-hot matmuls in three bf16
passes (K4/K5), are not needed: `spread` returns the folded (K1, K2, K3)
grid directly and `gather` reads each atom's 4x4x4 support, at any atom
count.  The spread is bound by the L2's atomic throughput (64 atomicAdds
per atom; 786,560 at 12,290 atoms) and the grid's memset, not by bytes or
flops: it runs 16 tap threads per atom, with each atom's spline support
computed once and staged in shared memory, and the four threads of a grid
row add to neighbouring cells in one instruction.  The gather, bound by
latency and launch cost, runs on the same layout: 16 tap threads per
atom read neighbouring cells of a row in one instruction, a fixed-order
shuffle reduction sums each atom's taps (repeats are bit-identical), and
the kernel converts dphi/du to forces itself, with the inverse of the
lower-triangular box in closed form (`box_inverse`): one launch, no
host-device copy, no sync.  An atom with a non-finite grid coordinate
poisons the result with NaN (the fail-hard rule of blocked_spread)
instead of being dropped.

Dispatch is by device: CPU tensors take the plain PyTorch versions, CUDA
tensors launch the kernels or raise.
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch

from ..core import pbc as pbc_mod
from . import cuda_lib

# launches of the CUDA kernels, keyed by (kernel, grid shape): the grid
# shape tells the paths of different system sizes apart
launches = collections.Counter()


def _w4(w):
    """Closed-form order-4 B-spline weights M4(w+j), j=0..3, and the M3
    values for the derivative taps."""
    m2_0, m2_1 = w, 1.0 - w
    m3_0 = 0.5 * w * m2_0
    m3_1 = 0.5 * ((w + 1.0) * m2_1 + (2.0 - w) * m2_0)
    m3_2 = 0.5 * (1.0 - w) * m2_1
    m4_0 = (w * m3_0) / 3.0
    m4_1 = ((w + 1.0) * m3_1 + (3.0 - w) * m3_0) / 3.0
    m4_2 = ((w + 2.0) * m3_2 + (2.0 - w) * m3_1) / 3.0
    m4_3 = ((1.0 - w) * m3_2) / 3.0
    return (torch.stack([m4_0, m4_1, m4_2, m4_3], -1),
            torch.stack([m3_0, m3_1 - m3_0, m3_2 - m3_1, -m3_2], -1))


def _support(x, box, grid_shape):
    """Per-atom (finite mask, taps (3, n, 4) cell indices, weights and
    derivative weights (3, n, 4)) of the order-4 support."""
    s = pbc_mod.frac_coords(x, box)
    u = (s - torch.floor(s)) * torch.tensor(grid_shape, dtype=x.dtype,
                                             device=x.device)
    finite = torch.isfinite(u).all(-1)
    u = torch.where(finite[:, None], u, torch.zeros_like(u))
    gi = torch.floor(u)
    w, dw = _w4(u - gi)                                   # (n, 3, 4)
    taps = torch.arange(4, device=x.device)
    idx = [torch.remainder(gi[:, d, None].to(torch.int64) - taps,
                           grid_shape[d]) for d in range(3)]
    return finite, idx, w.unbind(1), dw.unbind(1)


def spread_plain(x, box, q, grid_shape) -> torch.Tensor:
    """(K1, K2, K3) charge grid by index_add_ of the 64 taps per atom."""
    K1, K2, K3 = grid_shape
    finite, (i0, i1, i2), (wx, wy, wz), _ = _support(x, box, grid_shape)
    flat = ((i0[:, :, None, None] * K2 + i1[:, None, :, None]) * K3
            + i2[:, None, None, :])
    qf = torch.where(finite, q, torch.full_like(q, float("nan")))
    val = (qf[:, None, None, None] * wx[:, :, None, None]
           * wy[:, None, :, None] * wz[:, None, None, :])
    grid = torch.zeros(K1 * K2 * K3, dtype=x.dtype, device=x.device)
    grid.index_add_(0, flat.reshape(-1), val.reshape(-1))
    return grid.reshape(grid_shape)


def box_inverse(box):
    """(i00, i10, i11, i20, i21, i22): the inverse of the lower-triangular
    box in closed form, as the gather kernel computes it (its upper
    entries are 0)."""
    ax, bx, by = box[0, 0], box[1, 0], box[1, 1]
    cx, cy, cz = box[2, 0], box[2, 1], box[2, 2]
    return (1.0 / ax, -bx / (ax * by), 1.0 / by,
            (bx * cy - by * cx) / (ax * by * cz), -cy / (by * cz), 1.0 / cz)


def gather_plain(x, box, q, phi) -> Tuple[torch.Tensor, torch.Tensor]:
    """(forces (n, 3), dE/dq (n,)): F_e = -sum_d q K_d dphi/du_d binv[e, d]
    and dE/dq = phi at the atom."""
    K1, K2, K3 = phi.shape
    finite, (i0, i1, i2), (wx, wy, wz), (dx, dy, dz) = _support(
        x, box, phi.shape)
    rows = phi.reshape(K1 * K2, K3)[(i0[:, :, None] * K2
                                     + i1[:, None, :])]    # (n, 4, 4, K3)
    v = torch.gather(rows, 3, i2[:, None, None, :].expand(-1, 4, 4, 4))
    p = torch.sum(v * wz[:, None, None, :], -1)            # (n, 4, 4)
    pdz = torch.sum(v * dz[:, None, None, :], -1)
    wxy = wx[:, :, None] * wy[:, None, :]
    g0, g1, g2 = (torch.sum(w * a, (1, 2)) * q * float(k) for w, a, k in (
        (dx[:, :, None] * wy[:, None, :], p, K1),
        (wx[:, :, None] * dy[:, None, :], p, K2), (wxy, pdz, K3)))
    i00, i10, i11, i20, i21, i22 = box_inverse(box)
    forces = torch.stack([-(g0 * i00), -(g0 * i10 + g1 * i11),
                          -(g0 * i20 + g1 * i21 + g2 * i22)], -1)
    dedq = torch.sum(wxy * p, (1, 2))
    nan = torch.full_like(dedq, float("nan"))
    return (torch.where(finite[:, None], forces, nan[:, None]),
            torch.where(finite, dedq, nan))


def _check_inputs(x, box, q):
    for name, t, shape in (("x", x, (x.shape[0], 3)), ("box", box, (3, 3)),
                           ("q", q, (x.shape[0],))):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 CUDA tensor")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}")


def spread_cuda(x, box, q, grid_shape) -> torch.Tensor:
    _check_inputs(x, box, q)
    K1, K2, K3 = grid_shape
    grid = torch.zeros((K1, K2, K3), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return grid
    code = cuda_lib.library("pme_spline").pme_spread_launch(
        x.data_ptr(), q.data_ptr(), box.data_ptr(), grid.data_ptr(),
        x.shape[0], K1, K2, K3, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(code, "pme_spread")
    launches["spread", (K1, K2, K3)] += 1
    return grid


def gather_cuda(x, box, q, phi) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_inputs(x, box, q)
    if phi.device != x.device or phi.dtype != torch.float32 \
            or phi.dim() != 3 or not phi.is_contiguous():
        raise ValueError("phi must be a contiguous float32 (K1, K2, K3) "
                         "grid on the atoms' device")
    K1, K2, K3 = phi.shape
    if phi.numel() >= 2 ** 31:
        raise ValueError("the gather kernel takes grids of < 2^31 cells")
    n = x.shape[0]
    forces = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    dedq = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return forces, dedq
    code = cuda_lib.library("pme_spline").pme_gather_launch(
        x.data_ptr(), q.data_ptr(), box.data_ptr(), phi.data_ptr(),
        forces.data_ptr(), dedq.data_ptr(), n, K1, K2, K3,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(code, "pme_gather")
    launches["gather", (K1, K2, K3)] += 1
    return forces, dedq


def spread(x, box, q, grid_shape) -> torch.Tensor:
    """Folded (K1, K2, K3) order-4 charge grid (blocked_spread_pallas,
    spread_charges_pallas)."""
    if x.device.type == "cpu":
        return spread_plain(x, box, q, grid_shape)
    return spread_cuda(x, box, q, grid_shape)


def gather(x, box, q, phi, grid_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(forces, dE/dq) from the potential grid phi = dE/dQ
    (blocked_phi_gather_pallas, phi_gather_pallas)."""
    if tuple(phi.shape) != tuple(grid_shape):
        raise ValueError(f"phi has shape {tuple(phi.shape)}, expected "
                         f"{tuple(grid_shape)}")
    if x.device.type == "cpu":
        return gather_plain(x, box, q, phi)
    return gather_cuda(x, box, q, phi)
