"""md.log writer — the MDLogger/EnergyOutput log analogue; PyTorch-port
copy of gromacs_fep_gpu_tpu/io/logio.py (MdLogWriter; numpy only).

The log it reads holds numpy arrays: epot, ekin, temp, pres, dvdl,
constr_rmsd and terms, the (steps, 12) energy decomposition in the order
of core/types.py's EnergyTerms fields.

Reference: src/gromacs/mdlib/energyoutput.cpp:1288 (per-nstlog
"Energies (kJ/mol)" blocks via pr_ebin, mdlib/ebin.cpp:339 — 5 terms per
row, name row then %15.5e value row), the closing averages block
(eprAVER, energyoutput.cpp:1340), and the input-parameter dump
(pr_inputrec, mdtypes/inputrec.cpp).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.types import _ENERGY_FIELDS


def _ebin_block(f, names, values, per_row: int = 5):
    """pr_ebin layout: rows of up to `per_row` right-aligned 15-char
    names, then the matching %15.5e values (ebin.cpp:339)."""
    for i in range(0, len(names), per_row):
        f.write("".join("%15s" % n for n in names[i:i + per_row]) + "\n")
        f.write("".join("  %13.5e" % v for v in values[i:i + per_row])
                + "\n")


def _terms_table(terms, i: Optional[int], extra):
    """(names, values) for one frame (i) or NaN-mean over all frames
    (i=None); a term that is zero on every energy step is dropped like the
    reference drops unused F_* entries (the force-only steps' NaN rows do
    not keep it, as the JAX writer's zero rows do not)."""
    def pick(a):
        a = np.asarray(a, np.float64)
        if i is not None:
            return float(a[i])
        a = a[np.isfinite(a)]
        return float(a.mean()) if a.size else float("nan")

    col = {k: terms[:, c] for c, k in enumerate(_ENERGY_FIELDS)}
    rows = [("LJ (SR)", col["lj"]), ("Coulomb (SR)", col["coulomb"]),
            ("LJ recip.", col["lj_recip"]),
            ("Coul. recip.", col["coul_recip"]),
            ("Bond", col["bonds"]), ("Angle", col["angles"]),
            ("Proper Dih.", col["dihedrals"]),
            ("Improper Dih.", col["impropers"]),
            ("LJ-14", col["lj14"]), ("Coulomb-14", col["coul14"]),
            ("Restraints", col["restraints"]),
            ("Disper. corr.", col["dispcorr"])]
    names, vals = [], []
    for n, a in rows:
        arr = np.asarray(a, np.float64)
        if np.all(arr[np.isfinite(arr)] == 0.0):
            continue
        names.append(n)
        vals.append(pick(arr))
    for n, a in extra:
        names.append(n)
        vals.append(pick(a))
    return names, vals


class MdLogWriter:
    """Writes the setup report, per-nstlog energy blocks, the closing
    averages, and the performance summary into one .log file."""

    def __init__(self, path: str, params, system, argv=None):
        self._f = open(path, "w")
        f = self._f
        f.write("Log file opened: tpumd mdrun\n")
        if argv:
            f.write("Command line:\n  " + " ".join(argv) + "\n")
        f.write("\nInput Parameters:\n")
        for fld in dataclasses.fields(params):
            v = getattr(params, fld.name)
            if v is None:
                continue
            if dataclasses.is_dataclass(v):
                f.write("   %-24s:\n" % fld.name)
                for sf in dataclasses.fields(v):
                    f.write("      %-21s = %s\n"
                            % (sf.name, getattr(v, sf.name)))
            else:
                f.write("   %-24s = %s\n" % (fld.name, v))
        f.write("\nSystem: %d atoms\n\n" % system.n_atoms)
        f.flush()

    def write_frames(self, log, times, nstlog: int, dt: float):
        """log: concatenated StepLog; one block per nstlog steps plus the
        last frame (energyoutput.cpp printStepToEnergyFile cadence)."""
        f = self._f
        n = len(times)
        steps = list(range(0, n, max(nstlog, 1)))
        if (n - 1) not in steps:
            steps.append(n - 1)
        etot = np.asarray(log.epot) + np.asarray(log.ekin)
        dvdl_sum = np.asarray(log.dvdl).sum(axis=1)
        for i in steps:
            if not np.isfinite(np.asarray(log.epot)[i]):
                continue
            f.write("           Step           Time\n")
            f.write("%15d %14.5f\n\n" % (i, times[i]))
            f.write("   Energies (kJ/mol)\n")
            extra = [("Potential", log.epot), ("Kinetic En.", log.ekin),
                     ("Total Energy", etot), ("Temperature", log.temp),
                     ("Pressure (bar)", log.pres)]
            if np.any(dvdl_sum != 0.0):
                extra.append(("dVremain/dl", dvdl_sum))
            if np.any(np.asarray(log.constr_rmsd) != 0.0):
                extra.append(("Constr. rmsd", log.constr_rmsd))
            names, vals = _terms_table(log.terms, i, extra)
            _ebin_block(f, names, vals)
            f.write("\n")
        # closing averages over the run (eprAVER block)
        f.write("\t<======  ###############  ==>\n"
                "\t<====  A V E R A G E S  ====>\n"
                "\t<==  ###############  ======>\n\n")
        f.write("   Energies (kJ/mol)\n")
        extra = [("Potential", log.epot), ("Kinetic En.", log.ekin),
                 ("Total Energy", etot), ("Temperature", log.temp),
                 ("Pressure (bar)", log.pres)]
        names, vals = _terms_table(log.terms, None, extra)
        _ebin_block(f, names, vals)
        f.write("\n")
        f.flush()

    def write_performance(self, wallcycle_report: str, ns_day: float,
                          wall_s: float, nsteps: int, n_atoms: int):
        f = self._f
        f.write(wallcycle_report + "\n")
        f.write("\n               Core t (s)   Wall t (s)\n")
        f.write("       Time: %12.3f %12.3f\n" % (wall_s, wall_s))
        f.write("                 (ns/day)    (hour/ns)\n")
        f.write("Performance: %12.3f %12.3f\n"
                % (ns_day, 24.0 / ns_day if ns_day > 0 else float("inf")))
        f.write("\nFinished mdrun (%d steps, %d atoms)\n"
                % (nsteps, n_atoms))
        f.flush()

    def close(self):
        self._f.close()
