"""Long-range dispersion (tail) correction, DispCorr = EnerPres — the
port's copy of gromacs_fep_gpu_tpu/ops/dispcorr.py (average_c6_c12,
energy_integrals, make_dispersion_correction); reference:
src/gromacs/mdlib/dispersioncorrection.cpp.

E = <C6>(lambda) * (N/2) * (density * enerdiffsix - enershiftsix)

with <C6> the pair-count-weighted average over all type pairs minus the
excluded pairs (dispersioncorrection.cpp:139-285), per FEP end state, and
enerdiffsix the integral of the difference between the true -r^-6 and the
modifier-shaped simulated potential (setInteractionParameters:380-520).
The force-switch region integrals are evaluated analytically instead of by
the reference's spline-table quadrature.

dV/dl = (<C6>_B - <C6>_A) * (N/2) * (...) goes to the VDW channel
(reference: sim_util.cpp:2210-2213).  Both functions are linear in
lambda_vdw and take a scalar or an (L,) lambda.

One difference from the JAX module: `p_tail` takes lambda_vdw and mixes
<C6> at it, as the reference does; the JAX step evaluates it at
lambda_vdw = 0 only.
"""
from __future__ import annotations

import numpy as np

from ..core import pbc as pbc_mod
from ..core.types import MdParams, System, VdwModifier
from ..core.units import PRESFAC
from .nonbonded_ref import forceswitch_constants


def average_c6_c12(system: System, state: str = "a"):
    """Pair-averaged <c6>, <c12> for one end state, excluding excluded
    pairs (reference: dispersioncorrection.cpp:139-288 setAllVdW)."""
    t = (system.type_a if state == "a" else system.type_b).cpu().numpy()
    nbfp = system.nbfp.cpu().numpy().astype(np.float64)
    ntp = nbfp.shape[0]
    counts = np.bincount(t, minlength=ntp).astype(np.float64)
    npair_ij = np.outer(counts, counts)
    np.fill_diagonal(npair_ij, counts * (counts - 1))
    # each unordered pair counted once
    csix = 0.5 * np.sum(npair_ij * nbfp[:, :, 0])
    ctwelve = 0.5 * np.sum(npair_ij * nbfp[:, :, 1])
    npair = 0.5 * np.sum(npair_ij)

    # subtract excluded pairs
    excl = system.exclusions.cpu().numpy()
    rows = np.repeat(np.arange(excl.shape[0]), excl.shape[1])
    cols = excl.reshape(-1)
    sel = (cols >= 0) & (cols > rows)
    ti, tj = t[rows[sel]], t[cols[sel]]
    csix -= np.sum(nbfp[ti, tj, 0])
    ctwelve -= np.sum(nbfp[ti, tj, 1])
    nexcl = int(sel.sum())

    denom = npair - nexcl
    if denom <= 0:
        return 0.0, 0.0
    return float(csix / denom), float(ctwelve / denom)


def energy_integrals(params: MdParams):
    """(enerdiffsix, enerdifftwelve, enershiftsix, enershifttwelve)
    (reference: dispersioncorrection.cpp:380-520 setInteractionParameters;
    the dispersion channel multiplies +<c6>, with the -r^-6 sign folded
    into the integrand)."""
    rc = params.rvdw
    rc3 = rc ** 3
    rc9 = rc3 ** 3
    four_pi = 4.0 * np.pi
    if params.vdw_modifier == VdwModifier.FORCE_SWITCH:
        rsw = params.rvdw_switch
        c2d, c3d, cp6 = forceswitch_constants(6.0, rsw, rc)
        c2r, c3r, cp12 = forceswitch_constants(12.0, rsw, rc)
        d = rc - rsw
        # I3 = int_rsw^rc r^2 (r-rsw)^3 dr, I4 likewise with ^4
        i3 = d ** 6 / 6.0 + 2.0 * rsw * d ** 5 / 5.0 + rsw ** 2 * d ** 4 / 4.0
        i4 = d ** 7 / 7.0 + rsw * d ** 6 / 3.0 + rsw ** 2 * d ** 5 / 5.0
        ener6 = four_pi * (cp6 * rc3 / 3.0 - 2.0 * c2d * i3 - 1.5 * c3d * i4) \
            - four_pi / (3.0 * rc3)
        ener12 = four_pi * (-cp12 * rc3 / 3.0 + 4.0 * c2r * i3
                            + 3.0 * c3r * i4) + four_pi / (9.0 * rc9)
        return ener6, ener12, cp6, -cp12
    if params.vdw_modifier == VdwModifier.POTENTIAL_SHIFT:
        shift6, shift12 = -1.0 / (rc3 * rc3), 1.0 / (rc9 * rc3)
        ener6 = four_pi * shift6 * rc3 / 3.0 - four_pi / (3.0 * rc3)
        ener12 = four_pi * shift12 * rc3 / 3.0 + four_pi / (9.0 * rc9)
        return ener6, ener12, shift6, shift12
    # plain cut-off: tail only, no self-shift correction
    return -four_pi / (3.0 * rc3), four_pi / (9.0 * rc9), 0.0, 0.0


def make_dispersion_correction(system: System, params: MdParams):
    """(e_tail(box, lam_vdw) -> (E_tail, dvdl_vdw), p_tail(box, lam_vdw) ->
    P_tail in bar).

    Only the dispersion (c6) channel is corrected, DispCorr = EnerPres
    (reference: dispersioncorrection.cpp:544, bCorrAll only for AllEner*).
    """
    c6a, _ = average_c6_c12(system, "a")
    c6b, _ = average_c6_c12(system, "b")
    n = system.n_atoms
    ener6, _, shift6, _ = energy_integrals(params)
    num_corr = 0.5 * n
    fep = bool(c6a != c6b)

    def avg_c6(lam_v):
        return (1.0 - lam_v) * c6a + lam_v * c6b if fep else c6a

    def e_tail(box, lam_v=0.0):
        density = n / pbc_mod.box_volume(box)
        factor = num_corr * (density * ener6 - shift6)
        dvdl = (c6b - c6a) * factor if fep else 0.0 * factor
        return avg_c6(lam_v) * factor, dvdl

    # virial of the pressure term: the analytic part beyond the cut-off
    # (reference: addCorrectionBeyondCutoff, virial->dispersion = 8 pi/rc3;
    # the switch-region virial difference is neglected, as in the JAX
    # module)
    r0 = params.rvdw_switch if params.vdw_modifier == VdwModifier.FORCE_SWITCH \
        else params.rvdw
    virdiff6 = 0.5 * 8.0 * np.pi / r0 ** 3

    def p_tail(box, lam_v=0.0):
        vol = pbc_mod.box_volume(box)
        density = n / vol
        vir = num_corr * density * avg_c6(lam_v) * virdiff6 / 3.0
        return -2.0 / vol * vir * PRESFAC

    return e_tail, p_tail
