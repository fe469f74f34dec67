"""Smooth particle-mesh Ewald reciprocal space — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/pme.py (good_fft_size, pme_grid_size,
bspline_weights, bspline_dweights, make_influence_function,
_influence_scaled, reciprocal_energy, reciprocal_energy_force, phi_gather,
self_energy, net_charge_energy, make_pme_recip_fn as the energy half of
make_pme_recip_pair).

torch.fft takes the place of the matmul DFT (make_dft_matrices /
matmul_fft3 / _axis_dft): the same full-spectrum transform.  The force
path spreads and gathers with the K2/K3 kernels of ops/pme_kernels.py; the
AD-able energy (`reciprocal_energy`) spreads with a plain index_add_ and is
used for the small lambda(1-lambda) E[dq] correction over the perturbed
atoms.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..core import pbc as pbc_mod
from ..core.types import MdParams, System
from ..core.units import ONE_4PI_EPS0
from . import pme_kernels
from .fep import ewald_beta


def good_fft_size(n: int) -> int:
    """Smallest size >= n with only factors 2, 3, 5, 7."""
    def ok(m):
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1
    while not ok(n):
        n += 1
    return n


def pme_grid_size(box_diag, spacing: float) -> Tuple[int, int, int]:
    return tuple(good_fft_size(max(int(math.ceil(L / spacing)), 4))
                 for L in box_diag)


def bspline_weights(w: torch.Tensor, order: int) -> torch.Tensor:
    """Cardinal B-spline weights M_order(w + j), j = 0..order-1
    (Essmann recursion).  w: (...,) in [0, 1); returns (..., order)."""
    m = torch.stack([w, 1.0 - w], dim=-1)
    for n in range(3, order + 1):
        u = w[..., None] + torch.arange(n, dtype=w.dtype, device=w.device)
        prev = torch.nn.functional.pad(m, (0, 1))
        prev_shift = torch.nn.functional.pad(m, (1, 0))
        m = (u * prev + (n - u) * prev_shift) / (n - 1)
    return m


def bspline_dweights(w: torch.Tensor, order: int) -> torch.Tensor:
    """d/du of M_order(w + j): M_n'(v) = M_{n-1}(v) - M_{n-1}(v - 1)."""
    m = bspline_weights(w, order - 1)
    return torch.nn.functional.pad(m, (0, 1)) - torch.nn.functional.pad(
        m, (1, 0))


def _bspline_moduli(K: int, order: int) -> np.ndarray:
    """|b(m)|^-2 factors of the influence function (Essmann eq. 4.4)."""
    mnode = bspline_weights(torch.zeros((), dtype=torch.float64),
                            order).numpy()
    mlist = np.arange(K)
    denom = np.zeros(K, dtype=np.complex128)
    for k in range(order - 1):
        denom += mnode[k + 1] * np.exp(2j * np.pi * mlist * k / K)
    mag2 = np.abs(denom) ** 2
    b2 = 1.0 / np.maximum(mag2, 1e-10)
    bad = mag2 < 1e-10
    if bad.any():
        b2[bad] = 0.5 * (np.roll(b2, 1)[bad] + np.roll(b2, -1)[bad])
    return b2


def make_influence_function(grid_shape, order: int):
    """Static per-wavevector factors (numpy), full spectrum."""
    b2 = [_bspline_moduli(K, order) for K in grid_shape]
    K1, K2, K3 = grid_shape
    m1 = np.fft.fftfreq(K1) * K1
    m2 = np.fft.fftfreq(K2) * K2
    m3 = np.fft.fftfreq(K3) * K3
    bb = (b2[0][np.abs(np.rint(m1)).astype(int) % K1][:, None, None]
          * b2[1][np.abs(np.rint(m2)).astype(int) % K2][None, :, None]
          * b2[2][np.abs(np.rint(m3)).astype(int) % K3][None, None, :])
    return (m1, m2, m3, bb)


def _influence_scaled(box, influence, beta, dtype):
    """(G, scale): per-mode factor and prefactor, E = scale * sum(G |Q^|^2).
    `influence` holds tensors on the box's device."""
    m1, m2, m3, bb = influence
    binv = pbc_mod.inv3(box)
    gT = torch.einsum('ji,jk->ik', binv, binv)
    mm = (m1[:, None, None] ** 2 * gT[0, 0]
          + m2[None, :, None] ** 2 * gT[1, 1]
          + m3[None, None, :] ** 2 * gT[2, 2]
          + 2.0 * m1[:, None, None] * m2[None, :, None] * gT[0, 1]
          + 2.0 * m1[:, None, None] * m3[None, None, :] * gT[0, 2]
          + 2.0 * m2[None, :, None] * m3[None, None, :] * gT[1, 2])
    ok = mm > 1e-10
    pref = torch.where(ok, torch.exp(-(math.pi ** 2) * mm / beta ** 2)
                       / torch.where(ok, mm, torch.ones_like(mm)),
                       torch.zeros_like(mm))
    scale = ONE_4PI_EPS0 / (2.0 * math.pi * pbc_mod.box_volume(box))
    return pref * bb, scale


def influence_tensors(influence, device):
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in influence)


def spread_charges_scatter(x, box, charges, grid_shape, order: int = 4):
    """Plain differentiable spread (index_add_ of order^3 taps per atom)."""
    K = torch.tensor(grid_shape, device=x.device)
    s = pbc_mod.frac_coords(x, box)
    u = (s - torch.floor(s)) * K.to(x.dtype)
    gi = torch.floor(u).detach().to(torch.int64)
    w = u - gi.to(x.dtype)
    ws = [bspline_weights(w[:, d], order) for d in range(3)]
    j = torch.arange(order, device=x.device)
    idx = [torch.remainder(gi[:, d:d + 1] - j, grid_shape[d])
           for d in range(3)]
    K1, K2, K3 = grid_shape
    flat = ((idx[0][:, :, None, None] * K2 + idx[1][:, None, :, None]) * K3
            + idx[2][:, None, None, :])
    wq = (charges[:, None, None, None] * ws[0][:, :, None, None]
          * ws[1][:, None, :, None] * ws[2][:, None, None, :])
    grid = torch.zeros(K1 * K2 * K3, dtype=x.dtype, device=x.device)
    return grid.index_add(0, flat.reshape(-1), wq.reshape(-1)).reshape(
        grid_shape)


def reciprocal_energy(x, box, charges, grid_shape, beta, order: int = 4,
                      influence=None):
    """SPME reciprocal energy (no self/net-charge terms), differentiable."""
    if influence is None:
        influence = influence_tensors(
            make_influence_function(grid_shape, order), x.device)
    qh = torch.fft.fftn(spread_charges_scatter(x, box, charges, grid_shape,
                                               order))
    G, scale = _influence_scaled(box, influence, beta, x.dtype)
    return scale * torch.sum(G * (qh.real ** 2 + qh.imag ** 2))


def energy_and_potential(grid, box, beta, influence):
    """(energy, phi) of a charge grid: E = scale sum(G |Q^|^2) and the
    potential grid phi = dE/dQ = 2 scale Re(DFT(G conj(Q^)))."""
    qh = torch.fft.fftn(grid)
    G, scale = _influence_scaled(box, influence, beta, grid.dtype)
    energy = scale * torch.sum(G * (qh.real ** 2 + qh.imag ** 2))
    phi = (2.0 * scale * torch.fft.fftn(G * torch.conj(qh)).real
           ).contiguous()
    return energy, phi


def reciprocal_energy_force(x, box, charges, grid_shape, beta,
                            order: int = 4, influence=None):
    """(energy, forces, dE/dq) with the K2 spread and the K3 gather."""
    if order != 4:
        raise NotImplementedError("the PME kernels are order 4 only")
    if influence is None:
        influence = influence_tensors(
            make_influence_function(grid_shape, order), x.device)
    grid = pme_kernels.spread(x, box, charges, grid_shape)
    energy, phi = energy_and_potential(grid, box, beta, influence)
    forces, dEdq = pme_kernels.gather(x, box, charges, phi, grid_shape)
    return energy, forces, dEdq


def phi_gather(x, box, charges, phi, grid_shape, order: int = 4):
    """Plain (forces, dE/dq) from phi for any order — the JAX phi_gather."""
    K = torch.tensor(grid_shape, device=x.device)
    s = pbc_mod.frac_coords(x, box)
    u = (s - torch.floor(s)) * K.to(x.dtype)
    gi = torch.floor(u).to(torch.int64)
    w = u - gi.to(x.dtype)
    ws = [bspline_weights(w[:, d], order) for d in range(3)]
    dws = [bspline_dweights(w[:, d], order) for d in range(3)]
    j = torch.arange(order, device=x.device)
    idx = [torch.remainder(gi[:, d:d + 1] - j, grid_shape[d])
           for d in range(3)]
    K1, K2, K3 = grid_shape
    v = phi[idx[0][:, :, None, None], idx[1][:, None, :, None],
            idx[2][:, None, None, :]]                      # (n, o, o, o)
    pw = torch.einsum('nijk,ni,nj,nk->n', v, ws[0], ws[1], ws[2])
    dEdu = torch.stack([
        torch.einsum('nijk,ni,nj,nk->n', v, dws[0], ws[1], ws[2]),
        torch.einsum('nijk,ni,nj,nk->n', v, ws[0], dws[1], ws[2]),
        torch.einsum('nijk,ni,nj,nk->n', v, ws[0], ws[1], dws[2])],
        -1) * charges[:, None] * K.to(x.dtype)
    binv = pbc_mod.inv3(box)
    forces = -(dEdu[:, 0:1] * binv[:, 0] + dEdu[:, 1:2] * binv[:, 1]
               + dEdu[:, 2:3] * binv[:, 2])
    return forces, pw


def self_energy(charges, beta):
    return -ONE_4PI_EPS0 * beta / math.sqrt(math.pi) * torch.sum(charges ** 2)


def net_charge_energy(charges, beta, volume):
    q = torch.sum(charges)
    return -ONE_4PI_EPS0 * math.pi / (2.0 * beta ** 2 * volume) * q * q


class _RecipSetup:
    """Static data shared by the energy and force functions."""

    def __init__(self, system: System, params: MdParams, grid_shape):
        self.beta = ewald_beta(params.rcoulomb, params.ewald_rtol)
        self.grid_shape = tuple(grid_shape or params.pme_grid or ())
        if len(self.grid_shape) != 3:
            raise ValueError("grid shape required: set params.pme_grid or "
                             "pass grid_shape")
        self.order = params.pme_order
        dev = system.device
        self.influence = influence_tensors(
            make_influence_function(self.grid_shape, self.order), dev)
        self.qa, self.qb = system.charge_a, system.charge_b
        dq = (self.qb - self.qa).cpu().numpy()
        pert = np.nonzero(dq != 0.0)[0]
        self.fep_q = pert.size > 0
        self.pert_idx = torch.as_tensor(pert, dtype=torch.int64, device=dev)
        self.dq = torch.as_tensor(dq[pert], dtype=torch.float32, device=dev)

    def e_dd(self, x, box):
        """Mesh E[dq] of the perturbed atoms' charge differences."""
        return reciprocal_energy(x[self.pert_idx], box, self.dq,
                                 self.grid_shape, self.beta, self.order,
                                 self.influence)


def _recip_energy_fn(st: _RecipSetup):
    """recip_fn(x, box, lam_c) -> energy, differentiable, with the exact
    quadratic lambda mix (1-l) E[qA] + l E[qB] = E[q(l)] + l(1-l) E[dq],
    self and net-charge terms included (the JAX make_pme_recip_fn)."""
    beta = st.beta

    def recip_fn(x, box, lam_c):
        vol = pbc_mod.box_volume(box)
        qmix = ((1.0 - lam_c) * st.qa + lam_c * st.qb) if st.fep_q else st.qa
        e = (reciprocal_energy(x, box, qmix, st.grid_shape, beta, st.order,
                               st.influence)
             + self_energy(qmix, beta) + net_charge_energy(qmix, beta, vol))
        if st.fep_q:
            e_dd = (st.e_dd(x, box) + self_energy(st.dq, beta)
                    + net_charge_energy(st.dq, beta, vol))
            e = e + lam_c * (1.0 - lam_c) * e_dd
        return e

    return recip_fn


def make_pme_recip_pair(system: System, params: MdParams, grid_shape=None):
    """(energy_fn, force_fn): energy_fn is _recip_energy_fn; force_fn(x,
    box, lam_c) -> (E, F, dvdl_c) runs the kernels on the lambda-mixed grid
    plus the exact lambda(1-lambda) E[dq] correction (energy, its autograd
    force on the perturbed atoms, and its dvdl)."""
    st = _RecipSetup(system, params, grid_shape)
    energy_fn = _recip_energy_fn(st)
    beta = st.beta

    def force_fn(x, box, lam_c):
        vol = pbc_mod.box_volume(box)
        if not st.fep_q:
            e_grid, f, _ = reciprocal_energy_force(
                x, box, st.qa, st.grid_shape, beta, st.order, st.influence)
            e = (e_grid + self_energy(st.qa, beta)
                 + net_charge_energy(st.qa, beta, vol))
            return e, f, torch.zeros((), dtype=x.dtype, device=x.device)
        qmix = ((1.0 - lam_c) * st.qa + lam_c * st.qb).contiguous()
        e_grid, f, dEdq = reciprocal_energy_force(
            x, box, qmix, st.grid_shape, beta, st.order, st.influence)
        e = (e_grid + self_energy(qmix, beta)
             + net_charge_energy(qmix, beta, vol))
        xp = x[st.pert_idx].detach().requires_grad_(True)
        with torch.enable_grad():
            e_kk = reciprocal_energy(xp, box, st.dq, st.grid_shape, beta,
                                     st.order, st.influence)
            (g_kk,) = torch.autograd.grad(e_kk, xp)
        e_kk = e_kk.detach()
        e_dd = (e_kk + self_energy(st.dq, beta)
                + net_charge_energy(st.dq, beta, vol))
        lam_fac = lam_c * (1.0 - lam_c)
        e = e + lam_fac * e_dd
        f = f.index_add(0, st.pert_idx, -lam_fac * g_kk)
        dvdl = torch.sum(dEdq[st.pert_idx] * st.dq)
        dvdl = dvdl - 2.0 * ONE_4PI_EPS0 * beta / math.sqrt(math.pi) \
            * torch.sum(qmix[st.pert_idx] * st.dq)
        dvdl = dvdl - ONE_4PI_EPS0 * math.pi / (beta ** 2 * vol) \
            * (torch.sum(qmix) * torch.sum(st.dq))
        dvdl = dvdl + (1.0 - 2.0 * lam_c) * e_dd
        return e, f, dvdl

    return energy_fn, force_fn
