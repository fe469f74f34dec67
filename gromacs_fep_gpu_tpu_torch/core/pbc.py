"""Periodic-boundary utilities — PyTorch counterpart of
gromacs_fep_gpu_tpu/core/pbc.py (pbc_dx, wrap_frac_cell, frac_coords,
box_volume, inv3).

The box is a 3x3 lower-triangular matrix (GROMACS convention).  Fractional
coordinates come from exact elementwise back-substitution, never from a
matrix product: floor()/round() of the result decide image counts, cell
assignment and periodic shifts, and a reduced-precision product misplaces
boundary atoms by whole box lengths.
"""
from __future__ import annotations

import torch


def pbc_dx(dx: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement (pbc_dx_aiuc order: rows c, b, a)."""
    sz = torch.round(dx[..., 2] / box[2, 2])
    dx = dx - sz[..., None] * box[2]
    sy = torch.round(dx[..., 1] / box[1, 1])
    dx = dx - sy[..., None] * box[1]
    sx = torch.round(dx[..., 0] / box[0, 0])
    return dx - sx[..., None] * box[0]


def frac_coords(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Fractional coordinates s with x = s @ box, elementwise in fp32."""
    s2 = x[..., 2] / box[2, 2]
    s1 = (x[..., 1] - s2 * box[2, 1]) / box[1, 1]
    s0 = (x[..., 0] - s1 * box[1, 0] - s2 * box[2, 0]) / box[0, 0]
    return torch.stack([s0, s1, s2], dim=-1)


def wrap_frac_cell(x: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap atoms into the fractional unit cell, recomposed elementwise."""
    f = frac_coords(x, box)
    f = f - torch.floor(f)
    return f[..., 0:1] * box[0] + f[..., 1:2] * box[1] + f[..., 2:3] * box[2]


def box_volume(box: torch.Tensor) -> torch.Tensor:
    return box[0, 0] * box[1, 1] * box[2, 2]


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e]),
        torch.stack([B, a * i - c * g, c * d - a * f]),
        torch.stack([C, b * g - a * h, a * e - b * d]),
    ])
    return adj / det
