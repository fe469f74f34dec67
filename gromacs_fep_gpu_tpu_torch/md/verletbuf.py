"""Verlet buffer estimation from kinetic theory — copy of
gromacs_fep_gpu_tpu/md/verletbuf.py (calc_verlet_buffer, effective_rlist)
reading the port's System tensors through host numpy.

Implements the reference's energy-drift-targeted buffer sizing
(reference: src/gromacs/mdlib/calc_verletbuf.cpp:1182 calcVerletBufferSize,
:571 energyDriftAtomPair, :652 energyDrift): for a requested maximum
energy drift per atom per ps (verlet-buffer-tolerance), bisect the buffer
size using a Gaussian model of atomic displacement over the list
lifetime, with per-atom-type thermal variances (constrained atoms get the
2D rotation + COM decomposition) and the potential's Taylor expansion at
the cut-off.

All host-side numpy: runs once per run setup, not in the step loop.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.types import CoulombType, MdParams, System, VdwModifier
from ..core.units import BOLTZ, ONE_4PI_EPS0


def _np(a, dtype=None):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def verlet_buffer(params: MdParams, min_mass: float = 1.008,
                  temperature: float | None = None,
                  safety: float = 2.0) -> float:
    """Simple conservative fallback (used when no System is available):
    ~ safety * nstlist*dt * v_thermal(lightest atom)."""
    t = temperature if temperature is not None else params.ref_t
    if t <= 0:
        t = 300.0
    v_rms = math.sqrt(3.0 * BOLTZ * t / min_mass)  # nm/ps
    lifetime = params.nstlist * params.dt
    return safety * v_rms * lifetime


# -- kinetic-theory drift estimate ------------------------------------------

def _atom_kinetic_types(system: System):
    """Unique (mass, type, q, bConstr, con_mass, con_len) rows + counts
    (reference: getVerletBufferAtomtypes, calc_verletbuf.cpp:330)."""
    n = system.n_atoms
    mass = _np(system.mass_a, np.float64)
    typ = _np(system.type_a)
    q = _np(system.charge_a, np.float64)
    con_mass = np.zeros(n)
    con_len = np.zeros(n)

    def note(a, m_other, length):
        if m_other > con_mass[a]:
            con_mass[a] = m_other
            con_len[a] = length

    lc = system.lincs
    l_atoms, l_len, l_mask = _np(lc.atoms), _np(lc.length_a), _np(lc.mask)
    for k in range(int(l_mask.shape[0])):
        if float(l_mask[k]) == 0.0:
            continue
        a1, a2 = (int(v) for v in l_atoms[k])
        note(a1, mass[a2], float(l_len[k]))
        note(a2, mass[a1], float(l_len[k]))
    st = system.settle
    for k in range(int(_np(st.mask).shape[0])):
        if float(_np(st.mask)[k]) == 0.0:
            continue
        o, h1, h2 = (int(v) for v in _np(st.atoms)[k])
        doh = float(_np(st.d_oh)[k])
        con_mass[o], con_len[o] = mass[h1], doh
        con_mass[h1], con_len[h1] = mass[o], doh
        con_mass[h2], con_len[h2] = mass[o], doh

    bconstr = con_mass > 0.4 * mass
    rows = np.stack([mass, typ.astype(np.float64), q,
                     bconstr.astype(np.float64), con_mass, con_len], axis=1)
    uniq, counts = np.unique(np.round(rows, 9), axis=0, return_counts=True)
    return uniq, counts


def _constrained_sigma2(kt_fac, mass, con_mass, con_len):
    """(sigma2_2d, sigma2_3d) for a constrained atom
    (reference: constrained_atom_sigma2, calc_verletbuf.cpp:473)."""
    mass_frac = con_mass / (mass + con_mass)
    sigma2_rot = kt_fac * mass_frac / mass
    com_dist = con_len * mass_frac
    sigma2_rel = sigma2_rot / max(com_dist ** 2, 1e-30)
    a, b = 1.0 / 3.0, 2.0 / 45.0
    sigma2_rel = min(sigma2_rel, 1.0 / math.sqrt(b))
    s2_2d = (com_dist ** 2 * sigma2_rel
             / (1.0 + a * sigma2_rel + b * sigma2_rel ** 2))
    s2_3d = kt_fac / (mass + con_mass)
    return s2_2d, s2_3d


def _approx_2dof(s2, x):
    """Gaussian overestimate of the 2-DOF displacement distribution
    (reference: approx_2dof, calc_verletbuf.cpp:549)."""
    ex = math.exp(-x * x / (2.0 * s2))
    er = math.erfc(x / math.sqrt(2.0 * s2))
    if er < 1e-300:
        return 0.0, 1.0
    shift = -x + math.sqrt(2.0 * s2 / math.pi) * ex / er
    scale = 0.5 * math.pi * math.exp(ex * ex / (math.pi * er * er)) * er
    return shift, scale


def _drift_pair(constr_i, constr_j, s2, s2i_2d, s2j_2d, r_buffer, der):
    """Energy-drift overestimate for one atom pair
    (reference: energyDriftAtomPair, calc_verletbuf.cpp:571)."""
    erfc_arg_max = 8.0
    rsh = r_buffer
    sc_fac = 1.0
    if rsh * rsh > 2.0 * s2 * erfc_arg_max * erfc_arg_max:
        c_exp = c_erfc = 0.0
    else:
        if constr_i:
            sh, sc = _approx_2dof(s2i_2d, r_buffer * s2i_2d / s2)
            rsh += sh
            sc_fac *= sc
        if constr_j:
            sh, sc = _approx_2dof(s2j_2d, r_buffer * s2j_2d / s2)
            rsh += sh
            sc_fac *= sc
        c_exp = math.exp(-rsh * rsh / (2.0 * s2)) / math.sqrt(2.0 * math.pi)
        c_erfc = 0.5 * math.erfc(rsh / math.sqrt(2.0 * s2))
    s = math.sqrt(s2)
    rsh2 = rsh * rsh
    pot, md1, d2, md3 = der
    p0 = sc_fac * pot * (s * c_exp - rsh * c_erfc)
    p1 = sc_fac * md1 / 2.0 * ((rsh2 + s2) * c_erfc - rsh * s * c_exp)
    p2 = (sc_fac * d2 / 6.0
          * (s * (rsh2 + 2 * s2) * c_exp - rsh * (rsh2 + 3 * s2) * c_erfc))
    p3 = (sc_fac * md3 / 24.0
          * ((rsh2 * rsh2 + 6 * rsh2 * s2 + 3 * s2 * s2) * c_erfc
             - rsh * s * (rsh2 + 5 * s2) * c_exp))
    return p0 + p1 + p2 + p3


def _vdw_derivatives(params: MdParams):
    """(ljDisp, ljRep) Taylor terms at rvdw
    (reference: getVdwDerivatives, calc_verletbuf.cpp:812)."""
    rv = params.rvdw
    disp = [0.0, 0.0, 0.0, 0.0]
    rep = [0.0, 0.0, 0.0, 0.0]
    if params.vdw_modifier in (VdwModifier.NONE, VdwModifier.POTENTIAL_SHIFT):
        disp[1] = -6.0 * rv ** -7
        disp[2] = 7.0 * disp[1] / rv
        disp[3] = 8.0 * disp[2] / rv
        rep[1] = 12.0 * rv ** -13
        rep[2] = 13.0 * rep[1] / rv
        rep[3] = 14.0 * rep[2] / rv
    elif params.vdw_modifier == VdwModifier.FORCE_SWITCH:
        disp[3] = -_md3_force_switch(6.0, params.rvdw_switch, rv)
        rep[3] = _md3_force_switch(12.0, params.rvdw_switch, rv)
    elif params.vdw_modifier == VdwModifier.POTENTIAL_SWITCH:
        md3_pswf = 60.0 / (rv - params.rvdw_switch) ** 3
        disp[3] = -(rv ** -6) * md3_pswf
        rep[3] = (rv ** -12) * md3_pswf
    return disp, rep


def _md3_force_switch(p, rswitch, rc):
    """-V''' at rc for a force-switched r^-p potential: the switched
    force is p r^-(p+1) + a (r-rs)^2 + b (r-rs)^3, so -V''' = F'' at rc
    (reference: md3_force_switch, calc_verletbuf.cpp:796)."""
    a = -((p + 4) * rc - (p + 1) * rswitch) / \
        (rc ** (p + 2) * (rc - rswitch) ** 2)
    b = ((p + 3) * rc - (p + 1) * rswitch) / \
        (rc ** (p + 2) * (rc - rswitch) ** 3)
    md3_pot = p * (p + 1) * (p + 2) * rc ** -(p + 3)
    md3_sw = 2.0 * a + 6.0 * b * (rc - rswitch)
    return md3_pot + md3_sw


def _elec_derivatives(params: MdParams):
    """Electrostatics Taylor terms at rcoulomb
    (reference: getElecDerivatives, calc_verletbuf.cpp:878)."""
    elfac = ONE_4PI_EPS0 / params.epsilon_r
    rc = params.rcoulomb
    elec = [0.0, 0.0, 0.0, 0.0]
    if params.coulomb in (CoulombType.CUTOFF, CoulombType.REACTION_FIELD):
        if params.coulomb == CoulombType.CUTOFF:
            k_rf = 0.0
        else:
            # epsilon_rf = 0 convention: infinite RF permittivity
            k_rf = 0.5 / rc ** 3
        elec[1] = elfac * (1.0 / rc ** 2 - 2.0 * k_rf * rc)
        elec[2] = elfac * (2.0 / rc ** 3 + 2.0 * k_rf)
    elif params.coulomb == CoulombType.PME:
        from ..ops.nonbonded_ref import ewald_beta
        b = ewald_beta(rc, params.ewald_rtol)
        br = b * rc
        m2s = 2.0 / math.sqrt(math.pi)
        elec[1] = elfac * (b * math.exp(-br * br) * m2s / rc
                           + math.erfc(br) / (rc * rc))
        elec[2] = elfac / (rc * rc) * (
            2.0 * b * (1.0 + br * br) * math.exp(-br * br) * m2s
            + 2.0 * math.erfc(br) / rc)
    return elec


def _surface_frac(cluster_size, particle_distance, rlist):
    """Fraction of cluster pairs just outside the cut-off not in the list
    (reference: surface_frac, calc_verletbuf.cpp:741)."""
    if rlist < 0.5 * particle_distance:
        return 1.0
    d = 0.5 * particle_distance / rlist
    if cluster_size == 1:
        area_rel = 1.0
    elif cluster_size == 2:
        area_rel = 1.0 + d
    else:  # 4 (used for 8 too — conservative, as the reference does)
        cluster_size = 4
        area_rel = (1.0 + 1.0 / math.pi
                    * (6.0 * math.acos(1.0 / math.sqrt(3.0)) * d
                       + math.sqrt(3.0) * d * d
                       * (1.0 + 5.0 / 18.0 * d ** 2 + 7.0 / 45.0 * d ** 4
                          + 83.0 / 756.0 * d ** 6)))
    return area_rel / cluster_size


def _energy_drift(att, counts, nbfp, kt_fac, lj_disp, lj_rep, elec,
                  rlj, rcoul, rlist, n_atoms, density):
    """System drift estimate in kJ/mol over one list lifetime step
    (reference: energyDrift, calc_verletbuf.cpp:652)."""
    drift = 0.0
    ntyp = att.shape[0]
    sig = []
    for i in range(ntyp):
        mass, typ, q, bc, cm, cl = att[i]
        if bc > 0.5:
            s2_2d, s2_3d = _constrained_sigma2(kt_fac, mass, cm, cl)
        else:
            s2_2d, s2_3d = 0.0, kt_fac / mass
        sig.append((s2_2d, s2_3d))
    for i in range(ntyp):
        mi, ti, qi, bci, _, _ = att[i]
        s2i_2d, s2i_3d = sig[i]
        for j in range(i, ntyp):
            mj, tj, qj, bcj, _, _ = att[j]
            s2j_2d, s2j_3d = sig[j]
            s2 = s2i_2d + s2i_3d + s2j_2d + s2j_3d
            c6 = float(nbfp[int(ti), int(tj), 0])
            c12 = float(nbfp[int(ti), int(tj), 1])
            lj = [c6 * lj_disp[k] + c12 * lj_rep[k] for k in range(4)]
            pot_lj = _drift_pair(bci > 0.5, bcj > 0.5, s2, s2i_2d, s2j_2d,
                                 rlist - rlj, lj)
            qq = qi * qj
            eq = [elec[0] * qq, elec[1] * qq, elec[2] * qq, 0.0]
            pot_q = _drift_pair(bci > 0.5, bcj > 0.5, s2, s2i_2d, s2j_2d,
                                rlist - rcoul, eq)
            pot = pot_lj + pot_q
            npairs = (counts[i] * (counts[i] - 1) / 2.0 if j == i
                      else float(counts[i]) * counts[j])
            pot *= npairs
            pot *= (4.0 * math.pi * (rlist + math.sqrt(s2)) ** 2
                    * density / n_atoms)
            drift += abs(pot)
    return drift


def calc_verlet_buffer(system: System, params: MdParams, volume: float,
                       temperature: Optional[float] = None,
                       tolerance: float = 0.005,
                       cluster_i: int = 4, cluster_j: int = 4) -> float:
    """Buffer (nm) for a target drift of `tolerance` kJ/mol/ps per atom —
    the calcVerletBufferSize analogue (calc_verletbuf.cpp:1182).
    Bisection with 0.001 nm resolution."""
    t = temperature if temperature is not None else params.ref_t
    if t <= 0:
        t = 300.0
    n_atoms = int(system.n_atoms)
    density = n_atoms / max(volume, 1e-12)
    particle_distance = (math.sqrt(2.0) / density) ** (1.0 / 3.0)
    att, counts = _atom_kinetic_types(system)
    lj_disp, lj_rep = _vdw_derivatives(params)
    elec = _elec_derivatives(params)
    lifetime = params.nstlist * params.dt
    kt_fac = BOLTZ * t * lifetime ** 2
    nbfp = _np(system.nbfp, np.float64)
    rc = max(params.rvdw, params.rcoulomb)
    resolution = 0.001
    min_mass = float(att[:, 0].min())
    ib0, ib1 = -1, int(5.0 * 2.0 * math.sqrt(kt_fac / min_mass)
                       / resolution) + 1
    while ib1 - ib0 > 1:
        ib = (ib0 + ib1) // 2
        rb = ib * resolution
        rl = rc + rb
        drift = _energy_drift(att, counts, nbfp, kt_fac, lj_disp, lj_rep,
                              elec, params.rvdw, params.rcoulomb, rl,
                              n_atoms, density)
        drift *= (_surface_frac(min(cluster_i, 4), particle_distance, rl)
                  * _surface_frac(min(cluster_j, 4), particle_distance, rl))
        drift /= params.nstlist * params.dt * n_atoms  # per atom per ps
        if drift > tolerance:
            ib0 = ib
        else:
            ib1 = ib
    return ib1 * resolution


def effective_rlist(params: MdParams, min_mass: float = 1.008,
                    system: Optional[System] = None,
                    volume: Optional[float] = None) -> float:
    """List cut-off: explicit rlist if larger than the interaction
    cut-off, else cut-off + buffer (kinetic-theory sized when the system
    and box volume are available, conservative thermal estimate
    otherwise)."""
    rc = max(params.rcoulomb, params.rvdw)
    if params.rlist > rc:
        return params.rlist
    if system is not None and volume is not None:
        return rc + calc_verlet_buffer(system, params, volume)
    return rc + verlet_buffer(params, min_mass)
