"""xvg writers/readers, including GROMACS-compatible dhdl.xvg — the
port's own copy of gromacs_fep_gpu_tpu/io/xvgio.py (numpy only; the same
bytes for the same arrays)
(reference: src/gromacs/mdlib/energyoutput.cpp:640 open_dhdl,
:1032-1100 column layout — time, dH/dlambda per coupling type, Delta H to
each foreign lambda)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.types import FepCoupling

_COMPONENT_NAMES = {
    FepCoupling.FEP: "fep",
    FepCoupling.MASS: "mass",
    FepCoupling.COUL: "coul",
    FepCoupling.VDW: "vdw",
    FepCoupling.BONDED: "bonded",
    FepCoupling.RESTRAINT: "restraint",
    FepCoupling.TEMPERATURE: "temperature",
}


def write_xvg(path: str, title: str, xlabel: str, ylabel: str,
              legends: Sequence[str], data: np.ndarray):
    """data: (nrows, 1 + nseries) — first column is x."""
    with open(path, "w") as f:
        f.write(f'@    title "{title}"\n')
        f.write(f'@    xaxis  label "{xlabel}"\n')
        f.write(f'@    yaxis  label "{ylabel}"\n')
        f.write('@TYPE xy\n@ view 0.15, 0.15, 0.75, 0.85\n')
        f.write('@ legend on\n@ legend box on\n')
        for i, leg in enumerate(legends):
            f.write(f'@ s{i} legend "{leg}"\n')
        np.savetxt(f, data, fmt="%.6g")


def write_dhdl_xvg(path: str, times: np.ndarray, dvdl: np.ndarray,
                   delta_h: Optional[np.ndarray],
                   lambdas: np.ndarray, cur_lambda_idx: int,
                   components=(FepCoupling.COUL, FepCoupling.VDW,
                               FepCoupling.BONDED),
                   temperature: float = 300.0):
    """dhdl.xvg compatible with `gmx bar` column conventions.

    dvdl: (T, 7); delta_h: (T, L) Delta H to each lambda window or None;
    lambdas: (L, 7)."""
    legends: List[str] = []
    cols = [np.asarray(times)]
    for c in components:
        legends.append(f"dH/d{_COMPONENT_NAMES[c]}-lambda")
        cols.append(np.asarray(dvdl)[:, int(c)])
    if delta_h is not None:
        L = delta_h.shape[1]
        for l in range(L):
            lamv = np.asarray(lambdas)[l]
            desc = ", ".join(f"{np.round(float(lamv[int(c)]), 4):g}"
                             for c in components)
            legends.append(f"\\xD\\f{{}}H \\xl\\f{{}} to ({desc})")
            cols.append(np.asarray(delta_h)[:, l])
    data = np.stack(cols, axis=1)
    with open(path, "w") as f:
        f.write(f'@    title "dH/d\\xl\\f{{}} and \\xD\\f{{}}H"\n')
        f.write('@    xaxis  label "Time (ps)"\n')
        f.write('@    yaxis  label "dH/d\\xl\\f{} and \\xD\\f{}H (kJ/mol)"\n')
        f.write('@TYPE xy\n')
        f.write(f'@ subtitle "T = {temperature} (K), '
                f'\\xl\\f{{}} state {cur_lambda_idx}"\n')
        f.write('@ legend on\n')
        for i, leg in enumerate(legends):
            f.write(f'@ s{i} legend "{leg}"\n')
        np.savetxt(f, data, fmt="%.8g")


def read_xvg(path: str):
    """Returns (data array, legends list)."""
    legends = []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("@"):
                if "legend" in line and ' s' in line.split("legend")[0]:
                    legends.append(line.split('"')[1])
                continue
            if line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    return np.asarray(rows), legends
