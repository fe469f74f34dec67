"""MBAR: the multistate Bennett acceptance ratio estimator.

Shirts & Chodera, J. Chem. Phys. 129, 124105 (2008).  Generalizes the
pairwise BAR in analysis/bar.py (reference: gmxana/gmx_bar.cpp) to use
EVERY window's samples for every free-energy difference — the estimator
of choice for FEP ladders whose windows all log ΔH to all λ states
(calc-lambda-neighbors = -1), exactly what this framework's dhdl/edr
output provides.

The port's own copy of gromacs_fep_gpu_tpu/analysis/mbar.py (numpy only).

Self-consistent iteration with stabilized log-sum-exp; the additive
per-sample constant in u_kn cancels, so ΔH_i→k rows can be used
directly without knowing U_i itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _logsumexp(a, axis):
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    return np.squeeze(m, axis) + np.log(
        np.sum(np.exp(a - m), axis=axis))


def mbar_solve(u_kn: np.ndarray, n_k: np.ndarray, tol: float = 1e-12,
               maxiter: int = 20000) -> np.ndarray:
    """Dimensionless free energies f_k (f_0 = 0) from u_kn (K, N): the
    reduced energy of every sample at every state (samples concatenated
    in origin-state order, n_k per state).  Invariant to adding any
    per-sample constant to a column of u_kn."""
    K, N = u_kn.shape
    if int(np.sum(n_k)) != N:
        raise ValueError(f"n_k sums to {np.sum(n_k)}, u_kn has {N}")
    f = np.zeros(K)
    log_nk = np.log(np.asarray(n_k, float))
    for _ in range(maxiter):
        log_denom = _logsumexp(log_nk[:, None] + f[:, None] - u_kn,
                               axis=0)                      # (N,)
        f_new = -_logsumexp(-u_kn - log_denom[None, :], axis=1)
        f_new = f_new - f_new[0]
        delta = np.max(np.abs(f_new - f))
        f = f_new
        if delta < tol:
            break
    return f


def mbar_weights(u_kn: np.ndarray, n_k: np.ndarray,
                 f: np.ndarray) -> np.ndarray:
    """W (N, K): normalized sample weights at each state;
    columns sum to 1 (eq. C9 of Shirts & Chodera)."""
    log_nk = np.log(np.asarray(n_k, float))
    log_denom = _logsumexp(log_nk[:, None] + f[:, None] - u_kn, axis=0)
    return np.exp(f[None, :] - u_kn.T - log_denom[:, None])


def mbar(delta_h_kj: np.ndarray, lam_idx: np.ndarray, kt: float,
         n_states: Optional[int] = None, n_blocks: int = 5
         ) -> Tuple[np.ndarray, np.ndarray]:
    """MBAR over per-sample ΔH rows.

    delta_h_kj: (N, L) with row n = U(λ_m; x_n) - U(λ_{i_n}; x_n) in
    kJ/mol for every ladder state m (the dhdl.xvg / edr dH layout).
    lam_idx: (N,) origin window of each sample.
    Returns (f in kJ/mol with f[0]=0, block-bootstrap errors)."""
    L = delta_h_kj.shape[1] if n_states is None else n_states
    lam_idx = np.asarray(lam_idx)

    def solve(rows, idx):
        # sort samples by origin state
        order = np.argsort(idx, kind="stable")
        rows, idx = rows[order], idx[order]
        n_k = np.bincount(idx, minlength=L)
        if (n_k == 0).any():
            missing = np.where(n_k == 0)[0]
            raise ValueError(f"MBAR needs samples from every state; "
                             f"missing {missing.tolist()}")
        u_kn = (rows / kt).T                      # (L, N)
        return mbar_solve(u_kn, n_k) * kt

    f = solve(np.asarray(delta_h_kj, float), lam_idx)
    # block error: contiguous sample blocks per window keep correlation
    errs = np.zeros(L)
    if n_blocks > 1:
        fs = []
        for b in range(n_blocks):
            keep = np.zeros(len(lam_idx), bool)
            for i in range(L):
                w = np.where(lam_idx == i)[0]
                lo = (b * len(w)) // n_blocks
                hi = ((b + 1) * len(w)) // n_blocks
                keep[w[lo:hi]] = True
            try:
                fs.append(solve(np.asarray(delta_h_kj, float)[keep],
                                lam_idx[keep]))
            except ValueError:
                continue
        if len(fs) > 1:
            errs = np.std(np.asarray(fs), axis=0) / np.sqrt(len(fs))
    return f, errs
