"""Cluster pair-list construction — PyTorch counterpart of
gromacs_fep_gpu_tpu/ops/pairlist.py (_hilbert3, sort_atoms_by_cell with
its slab order, the domain-decomposition sort dd_geometry / sort_atoms_dd /
_morton2, _pack_valid, _cluster_neighbors, _cluster_neighbors_2level,
_total_image_counts, build_cluster_pairlist, check_exclusions,
build_fep_pairlist).

Atoms are Hilbert-sorted into 8-atom clusters.  Two FULL list forms, both
of j-clusters whose bounding boxes come within rlist:
- the per-cluster list (nnbr > 0): up to nnbr j-clusters per i-cluster,
  nearest first (the table route, K7b and K7c read it); with
  compute_shifts and no union list, per-entry build-time periodic shifts
  (nbr_shift, box-vector counts) for K7c;
- the union list (super_nnbr): one list per block of `super_block`
  i-clusters (4 for the v2u kernel K1, 8 for the supercluster kernel K7a),
  with per-(block, entry) shifts when compute_shifts is set.
The bounding-box test runs in chunks of query rows, so no (C, C) matrix is
ever held at once.  Capacity overflow is reported in flags and handled by
the runner's grow-and-roll-back.  Triclinic shifts raise
NotImplementedError.  `torch.sort(..., stable=True)` reproduces
lax.top_k's tie order (lower index first).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import pbc as pbc_mod
from ..core.types import System

CLUSTER = 8


@dataclasses.dataclass
class ClusterPairlist:
    perm: torch.Tensor          # (n_pad,) sorted -> original id (n = dummy)
    inv_perm: torch.Tensor      # (n,) original -> sorted position
    q_a: torch.Tensor           # (n_pad,) sorted static atom data
    q_b: torch.Tensor
    t_a: torch.Tensor
    t_b: torch.Tensor
    pert: torch.Tensor          # (n_pad,) f32 1.0 if perturbed
    excl: torch.Tensor          # (n_pad, K) partners in SORTED ids, -1 pad
    n_clusters: int
    # union list of super_block-cluster i-blocks (None without super_nnbr)
    nbr_super: Optional[torch.Tensor] = None     # (S, NNBR_B) ids (C = pad)
    super_overflow: Optional[torch.Tensor] = None  # () blocks over NNBR_B
    super_max_count: Optional[torch.Tensor] = None
    # per-cluster list (None without nnbr), nearest first
    nbr: Optional[torch.Tensor] = None           # (C, NNBR) ids (C = pad)
    nbr_mask: Optional[torch.Tensor] = None      # (C, NNBR) 1.0 valid
    n_overflow: Optional[torch.Tensor] = None    # () clusters over NNBR
    max_count: Optional[torch.Tensor] = None     # () largest need
    nbr_shift: Optional[torch.Tensor] = None     # (C, NNBR, 3) int8
    super_shift: Optional[torch.Tensor] = None   # (S, NNBR_B, 3) int8
    img: Optional[torch.Tensor] = None           # (n_pad, 3) f32
    shift_overflow: Optional[torch.Tensor] = None
    tile_overflow: Optional[torch.Tensor] = None
    tile_max: Optional[torch.Tensor] = None

    @property
    def n_pad(self) -> int:
        return self.perm.shape[0]


@dataclasses.dataclass
class FepPairlist:
    """Flat half list of perturbed atom pairs (original atom ids)."""
    iidx: torch.Tensor
    jidx: torch.Tensor
    included: torch.Tensor
    excluded: torch.Tensor
    n_overflow: torch.Tensor


def _hilbert3(ix, iy, iz, bits: int = 8):
    """3D Hilbert index (Skilling's transpose algorithm, vectorized)."""
    X = [ix.to(torch.int32), iy.to(torch.int32), iz.to(torch.int32)]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            x0_if = X[0] ^ P
            t = (X[0] ^ X[i]) & P
            x0_else = X[0] ^ t
            xi_else = X[i] ^ t
            X0_new = torch.where(cond, x0_if, x0_else)
            Xi_new = torch.where(cond, X[i], xi_else)
            X[0] = X0_new
            if i != 0:
                X[i] = Xi_new
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [xi ^ t for xi in X]
    key = torch.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << 1) | ((X[i] >> b) & 1)
    return key


def sort_atoms_by_cell(x, box, cell_size: float,
                       slab_axis: Optional[int] = None):
    """Hilbert ordering of atoms on one power-of-two cell grid.  slab_axis:
    that axis becomes the primary key (slab-major order, a 2-D Morton key
    inside the slab), so contiguous cluster ranges are spatial slabs: the
    1-D ring of the domain decomposition (parallel/spatial.py)."""
    diag = torch.diagonal(box)
    raw = torch.clamp(torch.exp(torch.mean(torch.log(
        torch.clamp(diag / cell_size, 1.0, 255.0)))), 1.0, 127.0)
    ncell = (2 * torch.exp2(torch.ceil(torch.log2(raw)))).to(torch.int32)
    frac = pbc_mod.frac_coords(x, box)
    frac = frac - torch.floor(frac)
    ic = torch.minimum(torch.clamp((frac * ncell).to(torch.int32), min=0),
                       ncell - 1)
    if slab_axis is None:
        key = _hilbert3(ic[:, 0], ic[:, 1], ic[:, 2])
    else:
        oth = [d for d in range(3) if d != slab_axis]
        key = (ic[:, slab_axis] << 16) | _morton2(ic[:, oth[0]],
                                                   ic[:, oth[1]])
    return torch.argsort(key, stable=True)


def _morton2(a, b):
    """2-D Morton interleave of two 8-bit cell indices (a high)."""
    m2 = torch.zeros_like(a)
    for bit in range(7, -1, -1):
        m2 = (m2 << 2) | (((a >> bit) & 1) << 1) | ((b >> bit) & 1)
    return m2


def dd_geometry(n_atoms: int, grid, block: int):
    """(ps, c_pad): clusters per domain of an N-D domain grid, aligned to
    the kernel block, and the padded total cluster count — shared by the
    DD sort and the halo machinery (parallel/spatial.py) so that domain
    boundaries agree."""
    C = (n_atoms + CLUSTER - 1) // CLUSTER
    nsh = int(np.prod(grid))
    ps = -(-C // nsh)
    ps = -(-ps // block) * block
    return ps, ps * nsh


def sort_atoms_dd(x, box, cell_size: float, grid, ps: int):
    """Hierarchical equal-count sort of an N-D domain grid (the JAX
    sort_atoms_dd): axis 0 is split into P0 equal-count groups by rank,
    each group is re-ranked along axis 1 and split into P1 chunks, and so
    on, so domain d owns clusters [d*ps, (d+1)*ps) of a compact box.  The
    keys are packed in int32 exactly as in JAX and every argsort is
    stable (jnp.argsort's order), so the permutation is JAX's."""
    n = x.shape[0]
    dev = x.device
    diag = torch.diagonal(box)
    raw = torch.clamp(diag / cell_size, 1.0, 255.0)
    ncell = torch.exp2(torch.ceil(torch.log2(raw))).to(torch.int32)
    frac = pbc_mod.frac_coords(x, box)
    frac = frac - torch.floor(frac)
    ic = torch.minimum(torch.clamp((frac * ncell).to(torch.int32), min=0),
                       ncell - 1)
    P0, P1, P2 = grid
    if P0 * P1 * P2 > 127:
        raise ValueError("sort_atoms_dd int32 key packing supports up "
                         "to 127 devices per spatial grid")
    a0 = ps * P1 * P2 * CLUSTER
    a1 = ps * P2 * CLUSTER
    a2 = ps * CLUSTER

    def ranks(key):
        order = torch.argsort(key, stable=True)
        r = torch.empty((n,), dtype=torch.int32, device=dev)
        r[order] = torch.arange(n, dtype=torch.int32, device=dev)
        return r

    i0, i1, i2 = (ic[:, d] for d in range(3))
    r0 = ranks((i0 << 16) | _morton2(i1, i2))
    g0 = torch.clamp(r0 // a0, max=P0 - 1)
    r1 = ranks((g0 << 16) | (i1 << 8) | i2)
    g1 = torch.clamp((r1 - g0 * a0) // a1, max=P1 - 1)
    g01 = g0 * P1 + g1
    r2 = ranks((g01 << 24) | (i2 << 16) | _morton2(i0, i1))
    g2 = torch.clamp((r2 - g01 * a1) // a2, max=P2 - 1)
    dev_id = g01 * P2 + g2
    key3 = (dev_id << 24) | (i2 << 16) | (i1 << 8) | i0
    return torch.argsort(key3, stable=True)


def _pack_valid(ok, k: int):
    """Stable front-compaction of a boolean lane mask: pos[r, p] = lane of
    the (p+1)-th True entry of row r (clipped to E-1 past the count),
    valid[r, p] = p < count."""
    E = ok.shape[-1]
    cs = torch.cumsum(ok.to(torch.int32), dim=-1)
    count = cs[..., -1]
    outs = []
    for p0 in range(0, k, 128):
        pr = torch.arange(p0, min(p0 + 128, k), dtype=torch.int32,
                          device=ok.device)
        outs.append(torch.sum((cs[..., :, None] <= pr).to(torch.int64),
                              dim=-2))
    pos = torch.cat(outs, dim=-1)
    valid = torch.arange(k, device=ok.device) < count[..., None]
    return torch.clamp(pos, max=E - 1), valid


def _cluster_neighbors(lo_i, hi_i, bb_lo, bb_hi, box, rlist2: float,
                       nnbr: int, block: int = 256):
    """For each query box, up to nnbr j-clusters whose bounding boxes come
    within rlist, nearest first (ties by index, as lax.top_k).  lo_i/hi_i:
    (Ci, 3) query boxes; bb_lo/bb_hi: (C, 3) cluster boxes."""
    Ci, C = lo_i.shape[0], bb_lo.shape[0]
    centers = 0.5 * (bb_lo + bb_hi)
    half = 0.5 * (bb_hi - bb_lo)
    k = min(nnbr, C)
    idx_out, count_out = [], []
    for c0 in range(0, Ci, block):
        lo, hi = lo_i[c0:c0 + block], hi_i[c0:c0 + block]
        dc = pbc_mod.pbc_dx(0.5 * (lo + hi)[:, None, :] - centers[None],
                            box)
        gap = torch.clamp(torch.abs(dc) - (0.5 * (hi - lo)[:, None, :]
                                           + half[None]), min=0.0)
        lb2 = torch.sum(gap * gap, -1)
        cand = lb2 < rlist2
        count_out.append(torch.sum(cand, dim=1))
        key = torch.where(cand, lb2, torch.full_like(lb2, float("inf")))
        srt, order = torch.sort(key, dim=1, stable=True)
        sel = order[:, :k]
        idx_out.append(torch.where(torch.isfinite(srt[:, :k]), sel,
                                   torch.full_like(sel, C)))
    idx = torch.cat(idx_out)
    if k < nnbr:
        idx = torch.nn.functional.pad(idx, (0, nnbr - k), value=C)
    count = torch.cat(count_out)
    return (idx, torch.sum(count > nnbr).to(torch.int32),
            torch.max(count).to(torch.int32))


def _cluster_neighbors_2level(lo_i, hi_i, bb_lo, bb_hi, box, rlist2: float,
                              nnbr: int, tile: int = 32, block: int = 128,
                              tile_cap: Optional[int] = None):
    """Two-level search for large C: query boxes first select candidate
    tiles of 32 Hilbert-contiguous clusters, then run the exact bbox test
    against those tiles' members; in-range clusters are front-packed
    (unordered, _pack_valid)."""
    Ci, C = lo_i.shape[0], bb_lo.shape[0]
    dev = bb_lo.device
    nt = -(-C // tile)
    padj = nt * tile - C
    lo_t = torch.nn.functional.pad(bb_lo, (0, 0, 0, padj), value=1e6
                                   ).reshape(nt, tile, 3)
    hi_t = torch.nn.functional.pad(bb_hi, (0, 0, 0, padj), value=-1e6
                                   ).reshape(nt, tile, 3)
    t_lo = lo_t.min(dim=1).values
    t_hi = hi_t.max(dim=1).values
    cen_t = 0.5 * (t_lo + t_hi)
    half_t = 0.5 * (t_hi - t_lo)
    tcap = min(nt, tile_cap if tile_cap is not None
               else max(8, 2 * nnbr // tile + 8))
    slab = torch.cat([0.5 * (bb_lo + bb_hi), 0.5 * (bb_hi - bb_lo),
                      torch.ones((C, 1), device=dev),
                      torch.zeros((C, 1), device=dev)], dim=1)
    slab_t = torch.nn.functional.pad(slab, (0, 0, 0, padj)
                                     ).reshape(nt, tile * 8)
    k = min(nnbr, tcap * tile)
    idx_out, count_out, tcount_out = [], [], []
    for c0 in range(0, Ci, block):
        lo, hi = lo_i[c0:c0 + block], hi_i[c0:c0 + block]
        B = lo.shape[0]
        cen_i = 0.5 * (lo + hi)
        half_i = 0.5 * (hi - lo)
        dct = pbc_mod.pbc_dx(cen_i[:, None, :] - cen_t[None], box)
        gap_t = torch.clamp(torch.abs(dct) - (half_i[:, None, :]
                                              + half_t[None]), min=0.0)
        cand_t = torch.sum(gap_t * gap_t, -1) < rlist2
        tcount_out.append(torch.sum(cand_t, dim=1))
        t_idx, t_ok = _pack_valid(cand_t, tcap)
        g = slab_t[t_idx].reshape(B, tcap * tile, 8)
        ok_j = (g[..., 6] > 0.5) & torch.repeat_interleave(t_ok, tile, dim=1)
        dc = pbc_mod.pbc_dx(cen_i[:, None, :] - g[..., 0:3], box)
        gap = torch.clamp(torch.abs(dc) - (half_i[:, None, :] + g[..., 3:6]),
                          min=0.0)
        ok = (torch.sum(gap * gap, -1) < rlist2) & ok_j
        count_out.append(torch.sum(ok, dim=1))
        pos, mask = _pack_valid(ok, k)
        t_sel = torch.gather(t_idx, 1, pos // tile)
        idx_out.append(torch.where(mask, t_sel * tile + pos % tile,
                                   torch.full_like(pos, C)))
    idx = torch.cat(idx_out)
    if k < nnbr:
        idx = torch.nn.functional.pad(idx, (0, nnbr - k), value=C)
    count = torch.cat(count_out)
    t_count = torch.cat(tcount_out)
    return (idx, torch.sum(count > nnbr).to(torch.int32),
            torch.max(count).to(torch.int32),
            torch.sum(t_count > tcap).to(torch.int32),
            torch.max(t_count).to(torch.int32))


def _total_image_counts(x, box, perm, n, n_pad, xs, xref, dloc, valid_lane):
    """Per-SORTED-atom periodic image counts of the rebuild's cluster-local
    frame: x[perm] - img @ box lands each atom where the build-time boxes
    and shifts modelled it (rebuild wrap plus per-cluster local fold)."""
    frac = pbc_mod.frac_coords(x, box)
    img_wrap = torch.cat([torch.floor(frac)[perm[:n]],
                          torch.zeros((n_pad - n, 3), device=x.device)])
    local_pos = (xref + dloc).reshape(n_pad, 3)
    k = torch.round(pbc_mod.frac_coords(xs - local_pos, box))
    k = torch.where(valid_lane.reshape(n_pad, 1), k, torch.zeros_like(k))
    return img_wrap + k


def build_cluster_pairlist(x, box, system: System, rlist: float,
                           nnbr: int = 0,
                           cell_size: Optional[float] = None,
                           super_nnbr: Optional[int] = None,
                           compute_shifts: bool = False,
                           super_block: int = 4,
                           triclinic: bool = False,
                           tile_cap: Optional[int] = None,
                           slab_axis: Optional[int] = None,
                           dd_sort=None) -> ClusterPairlist:
    """Rebuild the cluster pair lists (NS step): the per-cluster list when
    nnbr > 0, the union list of super_block-cluster blocks when super_nnbr
    is given, at least one of them.  compute_shifts bakes periodic shifts
    into the union list when there is one, else into the per-cluster
    list.  Domain decomposition: slab_axis sorts slab-major along that
    axis (the 1-D ring); dd_sort = ((P0, P1, P2), ps) takes the N-D
    hierarchical equal-count sort (sort_atoms_dd) instead, domain d owning
    clusters [d*ps, (d+1)*ps)."""
    if nnbr <= 0 and super_nnbr is None:
        raise ValueError("ask for the per-cluster list (nnbr > 0), the "
                         "union list (super_nnbr) or both")
    if triclinic:
        raise NotImplementedError("triclinic baked shifts are not ported")
    dev = x.device
    n = system.n_atoms
    C = (n + CLUSTER - 1) // CLUSTER
    n_pad = C * CLUSTER
    if cell_size is None:
        vol = float(np.prod(np.diagonal(box.detach().cpu().numpy())))
        cell_size = max((CLUSTER * vol / max(n, 1)) ** (1.0 / 3.0), 0.15)

    if dd_sort is not None:
        perm = sort_atoms_dd(x, box, cell_size, dd_sort[0], dd_sort[1])
    else:
        perm = sort_atoms_by_cell(x, box, cell_size, slab_axis=slab_axis)
    perm = torch.cat([perm, torch.full((n_pad - n,), n, dtype=perm.dtype,
                                       device=dev)])
    inv_perm = torch.empty((n,), dtype=torch.int64, device=dev)
    inv_perm[perm[:n]] = torch.arange(n, device=dev)

    dummy = (1e4 + torch.arange(n_pad - n, dtype=x.dtype, device=dev
                                )[:, None] * torch.ones(3, device=dev))
    xs = torch.cat([pbc_mod.wrap_frac_cell(x, box)[perm[:n]], dummy])
    xc = xs.reshape(C, CLUSTER, 3)
    xref = xc[:, 0:1, :]
    dloc = pbc_mod.pbc_dx(xc - xref, box)
    valid_lane = (perm < n).reshape(C, CLUSTER, 1)
    dloc = torch.where(valid_lane, dloc, torch.zeros_like(dloc))
    bb_lo = xref[:, 0] + dloc.min(dim=1).values
    bb_hi = xref[:, 0] + dloc.max(dim=1).values

    rl2 = float(np.float32(rlist ** 2))
    nbr = nbr_mask = n_overflow = max_count = None
    if nnbr > 0:
        nbr, n_overflow, max_count = _cluster_neighbors(
            bb_lo, bb_hi, bb_lo, bb_hi, box, rl2, nnbr)
        nbr_mask = (nbr < C).to(x.dtype)

    SB = super_block
    S = (C + SB - 1) // SB
    pad_s = S * SB - C
    lo_s = torch.nn.functional.pad(bb_lo, (0, 0, 0, pad_s), value=1e6
                                   ).reshape(S, SB, 3)
    hi_s = torch.nn.functional.pad(bb_hi, (0, 0, 0, pad_s), value=1e6
                                   ).reshape(S, SB, 3)
    blk_lo = lo_s.min(dim=1).values
    blk_hi = torch.where(hi_s > 5e5, torch.full_like(hi_s, -1e6),
                         hi_s).max(dim=1).values
    nbr_super = super_overflow = super_max = None
    tile_overflow = tile_max = None
    if super_nnbr is not None and C >= 4096:
        (nbr_super, super_overflow, super_max, tile_overflow,
         tile_max) = _cluster_neighbors_2level(
            blk_lo, blk_hi, bb_lo, bb_hi, box, rl2, super_nnbr,
            tile_cap=tile_cap)
    elif super_nnbr is not None:
        nbr_super, super_overflow, super_max = _cluster_neighbors(
            blk_lo, blk_hi, bb_lo, bb_hi, box, rl2, super_nnbr)

    super_shift = nbr_shift = img = shift_overflow = None
    if compute_shifts and nbr_super is None:
        # one shift per (i-cluster, entry) from the cluster centres, valid
        # for the whole nstlist window (the buffer bounds the motion)
        cen = 0.5 * (bb_lo + bb_hi)
        he = 0.5 * (bb_hi - bb_lo)
        nbr_c = torch.clamp(nbr, max=C - 1)
        rel = pbc_mod.frac_coords(cen[:, None, :] - cen[nbr_c], box)
        nbr_shift = torch.round(rel).to(torch.int8)
        # after the centre shift, the largest atom-pair displacement per
        # component must stay below L - rlist, else another image of the
        # pair could be the interacting one
        diag = torch.diagonal(box)
        dmax = (torch.abs(rel - torch.round(rel)) * diag + he[:, None, :]
                + he[nbr_c])
        bad = torch.any(dmax > (diag - rlist), dim=-1)
        shift_overflow = torch.sum((bad & (nbr_mask > 0)).to(torch.int32))
        img = _total_image_counts(x, box, perm, n, n_pad, xs, xref, dloc,
                                  valid_lane)
    elif compute_shifts:
        cen_b = 0.5 * (blk_lo + blk_hi)
        cen_c = 0.5 * (bb_lo + bb_hi)
        he_c = 0.5 * (bb_hi - bb_lo)
        nbr_u = torch.clamp(nbr_super, max=C - 1)
        cen_d = cen_b[:, None, :] - cen_c[nbr_u]
        valid_u = nbr_super < C
        super_shift = torch.round(pbc_mod.frac_coords(cen_d, box)
                                  ).to(torch.int8)
        diag = torch.diagonal(box)
        cen_m = torch.nn.functional.pad(cen_c, (0, 0, 0, pad_s)
                                        ).reshape(S, SB, 3)
        he_m = torch.nn.functional.pad(he_c, (0, 0, 0, pad_s)
                                       ).reshape(S, SB, 3)
        valid_m = torch.arange(S * SB, device=dev).reshape(S, SB) < C
        sL = super_shift.to(x.dtype) * diag
        d_m = (torch.abs(cen_m[:, :, None, :] - cen_c[nbr_u][:, None, :, :]
                         - sL[:, None, :, :]) + he_m[:, :, None, :]
               + he_c[nbr_u][:, None, :, :])
        bad_m = (torch.any(d_m > (diag - rlist), dim=-1)
                 & valid_m[:, :, None])
        bad_u = torch.any(bad_m, dim=1)
        shift_overflow = torch.sum((bad_u & valid_u).to(torch.int32))
        img = _total_image_counts(x, box, perm, n, n_pad, xs, xref, dloc,
                                  valid_lane)

    def gather_pad(a, fill):
        return torch.cat([a[perm[:n]],
                          torch.full((n_pad - n,), fill, dtype=a.dtype,
                                     device=dev)])

    ex = system.exclusions
    valid = ex >= 0
    partner = torch.where(valid, inv_perm[torch.where(valid, ex, 0)],
                          torch.full_like(ex, -1))
    K = ex.shape[1]
    excl = torch.cat([partner[perm[:n]],
                      torch.full((n_pad - n, K), -1, dtype=ex.dtype,
                                 device=dev)])
    return ClusterPairlist(
        perm=perm, inv_perm=inv_perm,
        q_a=gather_pad(system.charge_a, 0.0),
        q_b=gather_pad(system.charge_b, 0.0),
        t_a=gather_pad(system.type_a, 0), t_b=gather_pad(system.type_b, 0),
        pert=gather_pad(system.perturbed.to(x.dtype), 0.0), excl=excl,
        n_clusters=C, nbr_super=nbr_super, super_overflow=super_overflow,
        super_max_count=super_max, nbr=nbr, nbr_mask=nbr_mask,
        n_overflow=n_overflow, max_count=max_count, nbr_shift=nbr_shift,
        super_shift=super_shift, img=img,
        shift_overflow=shift_overflow, tile_overflow=tile_overflow,
        tile_max=tile_max)


def check_exclusions(x, box, system: System, rlist: float,
                     skip_perturbed: bool = False):
    """Number of excluded pairs beyond rlist (their RF/Ewald exclusion
    corrections would be lost; the reference fails hard on this)."""
    ex = system.exclusions
    valid = ex >= 0
    partner = torch.where(valid, ex, torch.zeros_like(ex))
    if skip_perturbed:
        pert = system.perturbed
        valid = valid & ~pert[:, None] & ~pert[partner]
    d = pbc_mod.pbc_dx(x[:, None, :] - x[partner], box)
    r2 = torch.sum(d * d, -1)
    return torch.sum((r2 > rlist * rlist) & valid).to(torch.int32)


def build_fep_pairlist(x, box, system: System, rlist: float,
                       pert_idx: np.ndarray, max_nbr: int = 512
                       ) -> FepPairlist:
    """Pairs involving perturbed atoms: per perturbed atom up to max_nbr
    partners within rlist (nearest first) plus ALL its excluded partners;
    pert-pert pairs kept once (i < j)."""
    dev = x.device
    n = system.n_atoms
    npert = int(pert_idx.shape[0])
    pidx = torch.as_tensor(np.asarray(pert_idx, np.int64), device=dev)
    is_pert = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_pert[pidx] = True
    dx = pbc_mod.pbc_dx(x[pidx][:, None, :] - x[None, :, :], box)
    r2 = torch.sum(dx * dx, -1)
    ids = torch.arange(n, device=dev)
    rows = system.exclusions[pidx]
    vmask = rows >= 0
    is_excl = torch.zeros((npert, n), dtype=torch.bool, device=dev)
    rowk = torch.arange(npert, device=dev)[:, None].expand_as(rows)
    is_excl[rowk[vmask], rows[vmask]] = True
    within = r2 < rlist * rlist
    notself = ids[None, :] != pidx[:, None]
    dup = is_pert[None, :] & (ids[None, :] < pidx[:, None])
    cand = (within | is_excl) & notself & (~dup)
    max_nbr = min(max_nbr, n)
    key = torch.where(cand, r2, torch.full_like(r2, float("inf")))
    srt, order = torch.sort(key, dim=1, stable=True)
    top_j = order[:, :max_nbr]
    sel = torch.isfinite(srt[:, :max_nbr])
    count = torch.sum(cand, dim=1)
    n_overflow = torch.sum(count > max_nbr).to(torch.int32)
    ii = pidx[:, None].expand_as(top_j)
    exc = torch.gather(is_excl, 1, top_j) & sel
    inc = sel & ~exc
    return FepPairlist(iidx=ii.reshape(-1), jidx=top_j.reshape(-1),
                       included=inc.reshape(-1).to(x.dtype),
                       excluded=exc.reshape(-1).to(x.dtype),
                       n_overflow=n_overflow)
