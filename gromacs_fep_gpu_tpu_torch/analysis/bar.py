"""Free-energy estimators: BAR and exponential averaging (and a simple
MBAR solver) over foreign-lambda energy differences — the `gmx bar`
analogue (reference: src/gromacs/gmxana/gmx_bar.cpp:3333).  The port's
own copy of gromacs_fep_gpu_tpu/analysis/bar.py (numpy only)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.units import BOLTZ


def exp_average(delta_u: np.ndarray, kt: float) -> float:
    """Zwanzig FEP: dG = -kT ln <exp(-dU/kT)> (numerically stabilized)."""
    w = -delta_u / kt
    wmax = w.max()
    return float(-kt * (wmax + np.log(np.mean(np.exp(w - wmax)))))


def bar(delta_u_fwd: np.ndarray, delta_u_rev: np.ndarray, kt: float,
        tol: float = 1e-8, max_iter: int = 200) -> Tuple[float, float]:
    """Bennett acceptance ratio between adjacent states.

    delta_u_fwd: U_{i+1}(x) - U_i(x) sampled at state i;
    delta_u_rev: U_i(x) - U_{i+1}(x) sampled at state i+1.
    Returns (dG, statistical error estimate) in the same energy units.
    Solves the self-consistent BAR equation by bisection on dG
    (the reference iterates the same implicit equation, gmx_bar.cpp).
    """
    nf, nr = len(delta_u_fwd), len(delta_u_rev)
    m = kt * np.log(nf / nr)

    def fermi(x):
        return 1.0 / (1.0 + np.exp(np.clip(x, -500, 500)))

    def imbalance(dg):
        # Bennett self-consistency on SUMS (gmx_bar.cpp calc_bar_sum):
        # sum f((M + wF - dG)/kT) = sum f((-M + wR + dG)/kT), with
        # wR = U_i - U_{i+1} at state i+1.  Equating means instead would
        # converge to dG + kT ln(nf/nr) when sample counts differ.
        a = np.log(np.sum(fermi((m + delta_u_fwd - dg) / kt)) + 1e-300)
        b = np.log(np.sum(fermi((-m + delta_u_rev + dg) / kt)) + 1e-300)
        return a - b

    lo, hi = -1e4, 1e4
    flo, fhi = imbalance(lo), imbalance(hi)
    if flo * fhi > 0:  # fall back to exponential averaging
        return exp_average(delta_u_fwd, kt), float("nan")
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        fm = imbalance(mid)
        if abs(fm) < tol or hi - lo < tol:
            break
        if flo * fm <= 0:
            hi = mid
        else:
            lo, flo = mid, fm
    dg = 0.5 * (lo + hi)

    # Bennett error estimate
    ff = fermi((m + delta_u_fwd - dg) / kt)
    fr = fermi((-m + delta_u_rev + dg) / kt)
    with np.errstate(divide="ignore"):
        var = ((np.var(ff) / (np.mean(ff) ** 2 + 1e-300)) / nf
               + (np.var(fr) / (np.mean(fr) ** 2 + 1e-300)) / nr)
    return float(dg), float(kt * np.sqrt(max(var, 0.0)))


def bar_profile(delta_h: np.ndarray, lambda_idx: np.ndarray,
                temperature: float, skip_frac: float = 0.1):
    """Free-energy profile over a lambda ladder from stacked dhdl data.

    delta_h: (T, L) Delta H from each sample's own window to all windows;
    lambda_idx: (T,) the window each sample was generated in.
    Returns (dg_per_leg list, total dG, total error)."""
    import warnings as _warnings
    kt = BOLTZ * temperature
    L = delta_h.shape[1]
    # discard the equilibration fraction per window, not of the
    # concatenated series (files are stacked in window order)
    keep = np.zeros(len(lambda_idx), bool)
    for w in np.unique(lambda_idx):
        rows = np.where(lambda_idx == w)[0]
        keep[rows[int(len(rows) * skip_frac):]] = True
    delta_h = delta_h[keep]
    lambda_idx = lambda_idx[keep]
    legs = []
    total, var_total = 0.0, 0.0
    n_done = 0
    for i in range(L - 1):
        at_i = delta_h[lambda_idx == i]
        at_j = delta_h[lambda_idx == i + 1]
        if len(at_i) == 0 or len(at_j) == 0:
            _warnings.warn(f"bar: no samples for leg {i}->{i+1}; skipped "
                           "(simulate every lambda window for a total dG)")
            legs.append((np.nan, np.nan))
            continue
        fwd = at_i[:, i + 1] - at_i[:, i]
        rev = at_j[:, i] - at_j[:, i + 1]
        dg, err = bar(fwd, rev, kt)
        legs.append((dg, err))
        total += dg
        n_done += 1
        if np.isfinite(err):
            var_total += err**2
    if n_done == 0:
        raise ValueError("bar: no lambda leg has samples on both sides")
    return legs, total, float(np.sqrt(var_total))
