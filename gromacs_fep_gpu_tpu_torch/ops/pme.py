"""Smooth particle-mesh Ewald reciprocal space — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/pme.py (good_fft_size, pme_grid_size,
bspline_weights, bspline_dweights, make_influence_function,
_influence_scaled, _spread_dispatch, reciprocal_energy,
reciprocal_energy_force, phi_gather, self_energy, net_charge_energy,
make_pme_recip_fn as the energy half of make_pme_recip_pair) and of
ops/pme_pallas.py (spread_charges_pallas, phi_gather_pallas: here
_spread_dispatch and phi_gather on a CUDA tensor).

torch.fft takes the place of the matmul DFT (make_dft_matrices /
matmul_fft3 / _axis_dft): the same full-spectrum transform.  Every spread
and gather that is not differentiated goes through the per-atom kernels of
ops/pme_kernels.py, at every system size; the AD-able energy
(`reciprocal_energy` on a tensor that requires grad) spreads with a plain
index_add_ and is used for the small lambda(1-lambda) E[dq] correction
over the perturbed atoms.

The reciprocal virial of an NPT pressure step (`force_fn(...,
need_virial=True)`) is the strain derivative of the reciprocal energy.  The
JAX package takes it by AD through an XLA spread; here it reuses the
force pass's grids: under a diagonal strain x -> x s, box -> box s the
fractional coordinates, and so the charge grids, do not move, and the
strain acts only through the influence function, the 1/V prefactor and the
net-charge term (`_strain_virial`).  No spread beyond the force pass's.
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
from .nonbonded_ref import ewald_beta


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


def influence_tensors(influence, device, dtype=torch.float32):
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in influence)


def spread_charges_scatter(x, box, charges, grid_shape, order: int = 4):
    """Plain differentiable spread (index_add_ of order^3 taps per atom).
    The grid shape scales each axis as a Python float: a tensor of it would
    be a synchronising host-to-device copy on every call on a GPU."""
    s = pbc_mod.frac_coords(x, box)
    s = s - torch.floor(s)
    u = torch.stack([s[:, d] * float(grid_shape[d]) for d in range(3)], -1)
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


def _spread_dispatch(x, box, charges, grid_shape, order):
    """Charge spread of every path that is not differentiated, at every
    system size.  It stands for both TPU spreads of the JAX package:
    blocked_spread_pallas (K2, from 8,000 atoms up there) and
    spread_charges_pallas (K4, the whole-grid one-hot matmul below that).
    On a GPU both are the per-atom 4x4x4 kernel of pme_kernels.spread,
    which needs neither atom blocks nor a size threshold; CPU tensors take
    its plain version (any other order: the plain scatter, CPU only)."""
    if order == 4:
        return pme_kernels.spread(x, box, charges, grid_shape)
    if x.device.type != "cpu":
        raise NotImplementedError("the PME kernels are order 4 only")
    return spread_charges_scatter(x, box, charges, grid_shape, order)


def reciprocal_energy(x, box, charges, grid_shape, beta, order: int = 4,
                      influence=None):
    """SPME reciprocal energy (no self/net-charge terms).  Differentiable
    through the plain scatter when x or the charges require grad; an
    energy-only call spreads with _spread_dispatch (the kernel on a GPU)."""
    if influence is None:
        influence = influence_tensors(
            make_influence_function(grid_shape, order), x.device, x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or charges.requires_grad):
        grid = spread_charges_scatter(x, box, charges, grid_shape, order)
    else:
        grid = _spread_dispatch(x, box, charges, grid_shape, order)
    return mesh_energy(grid, box, beta, influence)


def mesh_energy(grid, box, beta, influence):
    """E = scale * sum(G |Q^|^2) of a charge grid; differentiable in the
    grid and in the box."""
    qh = torch.fft.fftn(grid)
    G, scale = _influence_scaled(box, influence, beta, grid.dtype)
    return scale * torch.sum(G * (qh.real ** 2 + qh.imag ** 2))


def _strain_virial(energy_of_box, box):
    """Xi_aa = 1/2 dE/d eps_a of energy_of_box(box * (1 + eps)) at eps = 0:
    the diagonal virial of a term whose coordinate dependence is frozen
    (the charge grids, in fractional coordinates)."""
    eps = torch.zeros(3, dtype=box.dtype, device=box.device,
                      requires_grad=True)
    with torch.enable_grad():
        e = energy_of_box(box * (1.0 + eps)[None, :])
        (g,) = torch.autograd.grad(e, eps)
    return 0.5 * g


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
    """(energy, forces, dE/dq): spread, solve, gather, with the kernels
    on a GPU (order 4 only there)."""
    if influence is None:
        influence = influence_tensors(
            make_influence_function(grid_shape, order), x.device, x.dtype)
    return _spread_solve_gather(x, box, charges, grid_shape, beta, order,
                                influence)[1:]


def _spread_solve_gather(x, box, charges, grid_shape, beta, order,
                         influence):
    """(grid, energy, forces, dE/dq) of reciprocal_energy_force."""
    grid = _spread_dispatch(x, box, charges, grid_shape, order)
    energy, phi = energy_and_potential(grid, box, beta, influence)
    forces, dEdq = phi_gather(x, box, charges, phi, grid_shape, order)
    return grid, energy, forces, dEdq


def phi_gather(x, box, charges, phi, grid_shape, order: int = 4):
    """Per-atom (forces, dE/dq) from the potential grid phi = dE/dQ — the
    JAX phi_gather and its TPU twin phi_gather_pallas (K5).  A tensor that
    is not on the CPU goes to the gather kernel (order 4, or it raises);
    a CPU tensor takes the plain version below, at any order."""
    if x.device.type != "cpu":
        if order != 4:
            raise NotImplementedError("the PME kernels are order 4 only")
        return pme_kernels.gather(x, box, charges, phi, grid_shape)
    return phi_gather_plain(x, box, charges, phi, grid_shape, order)


def phi_gather_plain(x, box, charges, phi, grid_shape, order: int = 4):
    """Plain (forces, dE/dq) from phi for any order."""
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
        self._influence_np = make_influence_function(self.grid_shape,
                                                     self.order)
        self._influence = {}
        self.qa, self.qb = system.charge_a, system.charge_b
        dq = (self.qb - self.qa).cpu().numpy()
        pert = np.nonzero(dq != 0.0)[0]
        self.fep_q = pert.size > 0
        self.pert_idx = torch.as_tensor(pert, dtype=torch.int64, device=dev)
        self.dq = torch.as_tensor(dq[pert], dtype=torch.float32, device=dev)

    def influence(self, dtype):
        """The influence function's factors in the coordinates' dtype."""
        if dtype not in self._influence:
            self._influence[dtype] = influence_tensors(
                self._influence_np, self.qa.device, dtype)
        return self._influence[dtype]

    def e_dd(self, x, box):
        """Mesh E[dq] of the perturbed atoms' charge differences."""
        return reciprocal_energy(x[self.pert_idx].contiguous(), box,
                                 self.dq.to(x.dtype), self.grid_shape,
                                 self.beta, self.order,
                                 self.influence(x.dtype))


def _recip_energy_fn(st: _RecipSetup):
    """recip_fn(x, box, lam_c) -> energy, differentiable, with the exact
    quadratic lambda mix (1-l) E[qA] + l E[qB] = E[q(l)] + l(1-l) E[dq],
    self and net-charge terms included (the JAX make_pme_recip_fn)."""
    beta = st.beta

    def recip_fn(x, box, lam_c):
        vol = pbc_mod.box_volume(box)
        # charges in the coordinates' dtype first: a 0-dim lambda does not
        # promote them
        qa, qb = st.qa.to(x.dtype), st.qb.to(x.dtype)
        qmix = ((1.0 - lam_c) * qa + lam_c * qb) if st.fep_q else qa
        e = (reciprocal_energy(x, box, qmix, st.grid_shape, beta,
                               st.order, st.influence(x.dtype))
             + self_energy(qmix, beta) + net_charge_energy(qmix, beta, vol))
        if st.fep_q:
            dq = st.dq.to(x.dtype)
            e_dd = (st.e_dd(x, box) + self_energy(dq, beta)
                    + net_charge_energy(dq, beta, vol))
            e = e + lam_c * (1.0 - lam_c) * e_dd
        return e

    return recip_fn


def _recip_slope_fn(st: _RecipSetup):
    """slope_fn(x, box) -> d recip_fn / d lam_c, for the foreign-lambda
    sweep.  The mix identity of _recip_energy_fn makes recip_fn exactly
    linear in lam_c: recip_fn(l) = (1-l) E[qA] + l E[qB], so the energy
    difference between any two lambdas is (l2 - l1) (E[qB] - E[qA]) and one
    evaluation serves the whole ladder.  E is quadratic in the charges, so
    with phi_A = dE/dQ at qA

        E[qB] - E[qA] = sum_i dq_i (dE/dq_i)[qA] + E[dq]:

    one spread of qA, one solve, one gather on the perturbed atoms and the
    small E[dq] mesh term, with no difference of two large energies.  No
    gradient is taken (call it under torch.no_grad())."""
    beta = st.beta

    def slope_fn(x, box):
        if not st.fep_q:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        influence = st.influence(x.dtype)
        qa, qb, dq = st.qa.to(x.dtype), st.qb.to(x.dtype), st.dq.to(x.dtype)
        grid = _spread_dispatch(x, box, qa, st.grid_shape, st.order)
        _, phi = energy_and_potential(grid, box, beta, influence)
        xp = x[st.pert_idx].contiguous()
        _, dEdq = phi_gather(xp, box, dq, phi, st.grid_shape, st.order)
        mesh = torch.sum(dEdq * dq) + reciprocal_energy(
            xp, box, dq, st.grid_shape, beta, st.order, influence)
        # self and net-charge terms of E[qB] - E[qA], in difference form
        e_self = -ONE_4PI_EPS0 * beta / math.sqrt(math.pi) * torch.sum(
            dq * (qa + qb)[st.pert_idx])
        e_net = (-ONE_4PI_EPS0 * math.pi
                 / (2.0 * beta ** 2 * pbc_mod.box_volume(box))
                 * torch.sum(dq) * (torch.sum(qa) + torch.sum(qb)))
        return mesh + e_self + e_net

    return slope_fn


def make_pme_recip_fns(system: System, params: MdParams, grid_shape=None):
    """(energy_fn, force_fn, slope_fn) on one shared setup: the pair of
    make_pme_recip_pair plus _recip_slope_fn for the foreign-lambda
    sweep."""
    st = _RecipSetup(system, params, grid_shape)
    return _recip_energy_fn(st), _recip_force_fn(st), _recip_slope_fn(st)


def make_pme_recip_pair(system: System, params: MdParams, grid_shape=None):
    """(energy_fn, force_fn): energy_fn is _recip_energy_fn; force_fn(x,
    box, lam_c) -> (E, F, dvdl_c) runs the kernels on the lambda-mixed grid
    plus the exact lambda(1-lambda) E[dq] correction (energy, its autograd
    force on the perturbed atoms, and its dvdl)."""
    return make_pme_recip_fns(system, params, grid_shape)[:2]


def _recip_force_fn(st: _RecipSetup):
    beta = st.beta

    def force_fn(x, box, lam_c, need_virial: bool = False):
        """(E, F, dvdl_c), and with need_virial also the (3,) diagonal
        virial of E, from the grids of this pass held fixed."""
        vol = pbc_mod.box_volume(box)
        influence = st.influence(x.dtype)
        # charges in the coordinates' dtype first: a 0-dim lambda does not
        # promote them
        qa, qb, dq = (c.to(x.dtype) for c in (st.qa, st.qb, st.dq))
        q = ((1.0 - lam_c) * qa + lam_c * qb).contiguous() if st.fep_q else qa
        grid, e_grid, f, dEdq = _spread_solve_gather(
            x, box, q, st.grid_shape, beta, st.order, influence)
        e = e_grid + self_energy(q, beta) + net_charge_energy(q, beta, vol)
        out_vir = []
        if not st.fep_q:
            if need_virial:
                grid = grid.detach()
                out_vir.append(_strain_virial(
                    lambda b: mesh_energy(grid, b, beta, influence)
                    + net_charge_energy(q, beta, pbc_mod.box_volume(b)),
                    box))
            return (e, f, torch.zeros((), dtype=x.dtype, device=x.device),
                    *out_vir)
        xp = x[st.pert_idx].detach().requires_grad_(True)
        with torch.enable_grad():
            grid_dd = spread_charges_scatter(xp, box, dq, st.grid_shape,
                                             st.order)
            e_kk = mesh_energy(grid_dd, box, beta, influence)
            (g_kk,) = torch.autograd.grad(e_kk, xp)
        e_kk = e_kk.detach()
        e_dd = (e_kk + self_energy(dq, beta)
                + net_charge_energy(dq, beta, vol))
        lam_fac = lam_c * (1.0 - lam_c)
        e = e + lam_fac * e_dd
        f = f.index_add(0, st.pert_idx, -lam_fac * g_kk)
        dvdl = torch.sum(dEdq[st.pert_idx] * dq)
        dvdl = dvdl - 2.0 * ONE_4PI_EPS0 * beta / math.sqrt(math.pi) \
            * torch.sum(q[st.pert_idx] * dq)
        dvdl = dvdl - ONE_4PI_EPS0 * math.pi / (beta ** 2 * vol) \
            * (torch.sum(q) * torch.sum(dq))
        dvdl = dvdl + (1.0 - 2.0 * lam_c) * e_dd
        if need_virial:
            grid, grid_dd = grid.detach(), grid_dd.detach()

            def energy_of_box(b):
                v = pbc_mod.box_volume(b)
                return (mesh_energy(grid, b, beta, influence)
                        + net_charge_energy(q, beta, v)
                        + lam_fac * (mesh_energy(grid_dd, b, beta, influence)
                                     + net_charge_energy(dq, beta, v)))
            out_vir.append(_strain_virial(energy_of_box, box))
        return (e, f, dvdl, *out_vir)

    return force_fn
