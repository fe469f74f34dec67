"""Spatial domain decomposition — PyTorch counterpart of
gromacs_fep_gpu_tpu/parallel/spatial.py (make_spatial_cluster_force, the
halo geometry _as_grid / _grid_nsh / _axis_offsets / halo_shard_geometry /
_dev_offset_bad / halo_violations / sort_state_arrays, the dimension-sweep
halo and cat-space remap of make_halo_cluster_force and
make_dd_v2u_override, make_dd_nb_override, make_sharded_pme).

Atoms are sorted so that domain d owns the contiguous cluster range [d*ps,
(d+1)*ps) (ops/pairlist.py: slab_axis=0 for a 1-D ring of domains,
sort_atoms_dd for a (P0, P1, P2) grid).  Each step a domain receives its
halo neighbours' position strips in one sweep per decomposed axis (axes 2
-> 1 -> 0, [minus, own, plus] each: the dd_move_x analogue), and computes
the forces on its own atoms from the full pair list on that halo-extended
("cat") plane, so no force goes back.  The static per-rebuild data (the
list remapped to cat-space cluster ids, charges, masks, exclusions) is
packed once per rebuild (`prepare`); only coordinates move per step.

Two non-bonded routes run under DD, as in the JAX runner:
- K6 (make_dd_v2u_override): the v2u kernel per domain, its j lanes read
  from the cat plane by cluster id (ops/nb_v2u.py nb_v2u_dd_forces, the
  kGatherJ flavour of csrc/nb_v2u.cu);
- the table route (make_halo_cluster_force / make_dd_nb_override): the
  per-cluster kernel of csrc/nb_cluster.cu on an i-cluster range of the cat
  plane (ops/nb_cluster.py, PrepCluster.i0).
make_sharded_pme runs the PME reciprocal part per domain: each spreads its
atom chunk (K2), the grids are reduced into axis-0 slabs, transformed as
slabs and axis-1 pencils with one all_to_all each way, and each domain
gathers its chunk's forces (K3) from the all-gathered potential.

The domains are one process over a list of devices (parallel/mesh.py):
each domain's tensors live on mesh.spatial_devices[d] and a collective is
a copy or sum between them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..core import pbc as pbc_mod
from ..core.types import MdParams, System
from ..core.units import ONE_4PI_EPS0
from ..ops import nb_cluster, pme as pme_mod
from ..ops.nb_v2u import BU, NbConstants, PrepV2U, nb_v2u_dd_forces
from ..ops.pairlist import CLUSTER, ClusterPairlist
from .mesh import SPATIAL_AXIS, DeviceMesh, all_gather, all_to_all, \
    ppermute, psum_scatter


def _on(dev: torch.device):
    """Make `dev` the current CUDA device while a domain launches its
    kernels (a kernel runs on its stream's device)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


# -- geometry ---------------------------------------------------------------

def _as_grid(grid_or_nsh):
    """A domain count (1-D ring) or an explicit (P0, P1, P2)."""
    if isinstance(grid_or_nsh, int):
        return (grid_or_nsh, 1, 1)
    g = tuple(int(p) for p in grid_or_nsh)
    return g + (1,) * (3 - len(g))


def _grid_nsh(grid) -> int:
    return int(np.prod(grid))


def _axis_offsets(grid):
    """Per-axis halo offsets: {-1, 0, +1} on decomposed axes, {0} on
    trivial ones (3 or 1 blocks per axis in the cat layout)."""
    return [([-1, 0, 1] if p > 1 else [0]) for p in grid]


def halo_shard_geometry(nlist: ClusterPairlist, grid_or_nsh, block: int):
    """(ps, c_pad): clusters per domain (a multiple of `block`) and the
    padded cluster count ps * prod(grid)."""
    nsh = _grid_nsh(_as_grid(grid_or_nsh))
    ps = -(-nlist.n_clusters // nsh)
    ps = -(-ps // block) * block
    return ps, ps * nsh


def _dev_offset_bad(ci_dev, oj_dev, grid):
    """Per-entry flag: j's owner domain is beyond the +-1 halo of i's on
    any decomposed axis.  ci_dev (rows,), oj_dev (rows, width)."""
    P0, P1, P2 = grid
    bad = torch.zeros(oj_dev.shape, dtype=torch.bool, device=oj_dev.device)
    for axis, P in enumerate(grid):
        if P <= 1:
            continue
        div = (P1 * P2, P2, 1)[axis]
        gi = (ci_dev[:, None] // div) % P
        gj = (oj_dev // div) % P
        bad |= torch.remainder(gj - gi + 1, P) >= 3
    return bad


def halo_violations(nlist: ClusterPairlist, grid_or_nsh, block: int):
    """Number of listed pairs whose j-cluster lies outside the i-cluster's
    halo (offset beyond +-1 on a decomposed axis): a domain thinner than
    the list cut-off, which the halo path would silently miss.  Counts the
    per-cluster list and, when present, the union list; a () int32
    tensor."""
    grid = _as_grid(grid_or_nsh)
    ps, _ = halo_shard_geometry(nlist, grid, block)
    C = nlist.n_clusters
    total = torch.zeros((), dtype=torch.int32, device=nlist.perm.device)
    if nlist.nbr is not None and nlist.nbr.shape[1] > 0:
        ci = torch.arange(nlist.nbr.shape[0], device=nlist.nbr.device) // ps
        bad = _dev_offset_bad(ci, nlist.nbr // ps, grid)
        total = total + torch.sum(bad & (nlist.nbr_mask > 0)).to(torch.int32)
    if nlist.nbr_super is not None:
        ns = nlist.nbr_super
        S = ns.shape[0]
        sbu = -(-C // S)                       # clusters per union block
        ci = (torch.arange(S, device=ns.device) * sbu) // ps
        oj = torch.clamp(ns, 0, C - 1) // ps
        bad = _dev_offset_bad(ci, oj, grid)
        total = total + torch.sum(bad & (ns >= 0) & (ns < C)).to(torch.int32)
    return total


def sort_state_arrays(x, nlist: ClusterPairlist, c_pad: int, img=None,
                      box=None):
    """Positions -> cluster-sorted rows padded to c_pad clusters: padding
    atoms at 1e4 + i, the clusters past the list at 2e4 + i, as JAX places
    them.  With img (the rebuild's image counts of baked shifts) the rows
    move into the rebuild frame, x - img * diag(box)."""
    n = nlist.inv_perm.shape[0]
    n_pad = nlist.n_pad
    dev = x.device
    xs = torch.where((nlist.perm < n)[:, None],
                     x[torch.clamp(nlist.perm, max=n - 1)],
                     1e4 + torch.arange(n_pad, dtype=x.dtype,
                                        device=dev)[:, None])
    if img is not None:
        xs = xs - img * torch.diagonal(box)
    extra = c_pad * CLUSTER - n_pad
    dummy = (2e4 + torch.arange(extra, dtype=x.dtype, device=dev)[:, None]
             * torch.ones(3, dtype=x.dtype, device=dev))
    return torch.cat([xs, dummy])


class HaloGrid:
    """The halo layout of one domain grid: the per-axis ppermute sweep that
    builds each domain's cat plane, and the maps of global cluster ids and
    static rows into it.  The cat plane holds B = prod(blocks per axis)
    blocks of ps clusters, row-major over the axes' slots (minus, own,
    plus on a decomposed axis), then one dummy cluster (id B * ps)."""

    def __init__(self, grid_or_nsh):
        self.grid = _as_grid(grid_or_nsh)
        P0, P1, P2 = self.grid
        self.nsh = _grid_nsh(self.grid)
        self.offs = _axis_offsets(self.grid)
        b0, b1, b2 = (len(o) for o in self.offs)
        self.n_blocks = b0 * b1 * b2
        self._bfac = (b1 * b2, b2, 1)
        self._div = (P1 * P2, P2, 1)
        self.own_blk = ((1 if P0 > 1 else 0) * b1
                        + (1 if P1 > 1 else 0)) * b2 + (1 if P2 > 1 else 0)

    def coords(self, s: int):
        return tuple((s // self._div[a]) % self.grid[a] for a in range(3))

    def _compose(self, g) -> int:
        return sum(g[a] * self._div[a] for a in range(3))

    def _shift_perm(self, axis: int, d: int):
        """(src, dst) pairs: domain s sends to its +d neighbour along
        `axis`, so every domain receives its -d neighbour's strip."""
        pairs = []
        for s in range(self.nsh):
            g = list(self.coords(s))
            g[axis] = (g[axis] + d) % self.grid[axis]
            pairs.append((s, self._compose(g)))
        return pairs

    def sweep(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Dimension-sweep halo (axes 2 -> 1 -> 0, [minus, own, plus] per
        decomposed axis, each sweep forwarding the strip of the previous
        one): each domain's own rows (dim 0) -> its cat rows, without the
        trailing dummy cluster."""
        strips = list(parts)
        for axis in (2, 1, 0):
            if self.grid[axis] <= 1:
                continue
            minus = ppermute(strips, self._shift_perm(axis, +1))
            plus = ppermute(strips, self._shift_perm(axis, -1))
            strips = [torch.cat([m, s, p]) for m, s, p in
                      zip(minus, strips, plus)]
        return strips

    def cat_remap(self, ids_cl, s: int, ps: int, c_pad: int):
        """Global cluster ids -> cat-space ids of domain s; ids outside its
        halo, and ids >= c_pad, -> the dummy cluster B * ps.  With P = 2 on
        an axis the other domain is always the minus slot (the plus slot
        holds the same strip and is never addressed)."""
        g = self.coords(s)
        owner = ids_cl // ps
        ok = ids_cl < c_pad
        blk = torch.zeros_like(ids_cl)
        for axis, P in enumerate(self.grid):
            if P <= 1:
                continue
            ds = torch.remainder((owner // self._div[axis]) % P - g[axis] + 1,
                                 P)
            ok &= ds < 3
            blk = blk + torch.clamp(ds, max=2) * self._bfac[axis]
        return torch.where(ok, blk * ps + torch.remainder(ids_cl, ps),
                           torch.full_like(ids_cl, self.n_blocks * ps))

    def cat_rows(self, arr, s: int, ps: int, fill):
        """Static per-atom rows (global sorted order, c_pad clusters) in
        domain s's cat order, the trailing dummy cluster filled with
        `fill`."""
        g = self.coords(s)
        P0, P1, P2 = self.grid
        rows = ps * CLUSTER
        parts = []
        for o0 in self.offs[0]:
            for o1 in self.offs[1]:
                for o2 in self.offs[2]:
                    src = self._compose(((g[0] + o0) % P0, (g[1] + o1) % P1,
                                         (g[2] + o2) % P2))
                    parts.append(arr[src * rows:(src + 1) * rows])
        parts.append(torch.full((CLUSTER,) + tuple(arr.shape[1:]), fill,
                                dtype=arr.dtype, device=arr.device))
        return torch.cat(parts)

    def cat_planes(self, xs, ps: int, devices) -> List[torch.Tensor]:
        """Per-step: the sorted padded rows xs (c_pad * 8, 3) -> each
        domain's (3, n_cat_rows) coordinate planes of its cat plane, the
        dummy cluster at 3e4 + i."""
        rows = ps * CLUSTER
        parts = [xs[s * rows:(s + 1) * rows].to(devices[s])
                 for s in range(self.nsh)]
        out = []
        for s, strip in enumerate(self.sweep(parts)):
            dummy = (3e4 + torch.arange(CLUSTER, dtype=xs.dtype,
                                        device=strip.device)[:, None]
                     * torch.ones(3, dtype=xs.dtype, device=strip.device))
            out.append(torch.cat([strip, dummy]).t().contiguous())
        return out


def _check_mesh(mesh: DeviceMesh, halo: HaloGrid):
    if mesh.shape[SPATIAL_AXIS] != halo.nsh:
        raise ValueError(f"grid {halo.grid} does not cover the "
                         f"{mesh.shape[SPATIAL_AXIS]}-domain spatial axis")


# -- table route ------------------------------------------------------------

def make_spatial_cluster_force(system: System, params: MdParams,
                               mesh: DeviceMesh, beta, block: int = 16):
    """f(x, box, nlist) -> (f_sorted, e_coul, e_lj): replicated positions,
    the i-cluster block range split over the spatial domains (each domain
    runs the table kernel on its range of the full plane)."""
    from ..ops.cluster_nb import lj_table_mode
    devices = mesh.spatial_devices
    nsh = len(devices)
    lj_mode = lj_table_mode(system.nbfp.cpu().numpy())
    consts = NbConstants.from_params(params, beta)

    def sharded(x, box, nlist: ClusterPairlist):
        prep = nb_cluster.prepare_table(nlist, system.nbfp, lj_mode)
        planes = nb_cluster.gather_planes(x, box, nlist, prep)
        C = nlist.n_clusters
        blk = max(1, min(block, C))
        n_blk = -(-C // blk)
        per = -(-n_blk // nsh) * blk             # clusters per domain
        e64 = torch.zeros(2, dtype=torch.float64, device=x.device)
        f_rows = []
        for s, dev in enumerate(devices):
            c0, c1 = s * per, min((s + 1) * per, prep.n_icl)
            if c1 <= c0:
                continue
            part = _range_pack(prep, c0, c1, dev)
            with _on(dev):
                fx, fy, fz, e = nb_cluster.nb_cluster_forces(
                    [p.to(dev) for p in planes], box.to(dev), part, consts,
                    True)
            f_rows.append(torch.stack([fx, fy, fz], -1).to(x.device))
            e64 = e64 + e.to(x.device, torch.float64).sum(0)
        f = torch.cat(f_rows)[:nlist.n_pad]
        return f, (0.5 * e64[0]).to(x.dtype), (0.5 * e64[1]).to(x.dtype)

    return sharded


def _range_pack(prep: nb_cluster.PrepCluster, c0: int, c1: int, dev):
    """The table pack of i-clusters [c0, c1) on the full plane, on dev."""
    rows = slice(c0 * CLUSTER, c1 * CLUSTER)
    return dataclasses.replace(
        prep, i0=c0, n_icl=c1 - c0, halo=True,
        nbr=prep.nbr[c0:c1].contiguous().to(dev),
        cnt=prep.cnt[c0:c1].contiguous().to(dev),
        excl=prep.excl[rows].contiguous().to(dev),
        **{k: getattr(prep, k).to(dev) for k in
           ("q", "pv", "s6", "s12", "types", "nbfp")
           if getattr(prep, k) is not None})


def make_halo_cluster_force(system: System, params: MdParams,
                            mesh: DeviceMesh, beta, nlist: ClusterPairlist,
                            block: int = 8, grid=None):
    """halo_force(xs_sorted, box, need_energy=True) -> (f_sorted, e_coul,
    e_lj) on one rebuild's list.  xs_sorted: (c_pad * 8, 3) sorted padded
    positions (sort_state_arrays).  Each domain gets its halo neighbours'
    strips (HaloGrid.sweep) and runs the table kernel on its own i-cluster
    range of its cat plane; the static data (the own rows of the list and
    of the exclusions remapped to cat ids, the cat rows of charges, masks
    and types) is packed here, once per rebuild.  Requires
    halo_violations(nlist, grid, block) == 0."""
    from ..ops.cluster_nb import lj_table_mode
    halo = HaloGrid(grid if grid is not None else mesh.shape[SPATIAL_AXIS])
    _check_mesh(mesh, halo)
    devices = mesh.spatial_devices
    ps, c_pad = halo_shard_geometry(nlist, halo.grid, block)
    lj_table = lj_table_mode(system.nbfp.cpu().numpy()) == "table"
    consts = NbConstants.from_params(params, beta)
    C = nlist.n_clusters
    n = nlist.inv_perm.shape[0]
    extra = c_pad * CLUSTER - nlist.n_pad
    dev0 = nlist.perm.device
    dummy_cl = halo.n_blocks * ps

    def pad(a, fill):
        return torch.cat([a, torch.full((extra,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=dev0)])
    valid = (nlist.perm < n).to(torch.float32)
    static = {"q": pad(nlist.q_a.to(torch.float32), 0.0),
              "pv": pad(valid * (1.0 - nlist.pert), 0.0)}
    if lj_table:
        static["types"] = pad(nlist.t_a.to(torch.int32), 0)
    else:
        d6 = torch.sqrt(torch.clamp(torch.diagonal(system.nbfp[:, :, 0]),
                                    min=0.0))
        d12 = torch.sqrt(torch.clamp(torch.diagonal(system.nbfp[:, :, 1]),
                                     min=0.0))
        static["s6"] = pad(d6[nlist.t_a], 0.0)
        static["s12"] = pad(d12[nlist.t_a], 0.0)
    excl_pad = pad(nlist.excl, -1)
    nbr_valid = torch.nn.functional.pad(nlist.nbr_mask > 0,
                                        (0, 0, 0, c_pad - C))
    nbr_p = torch.nn.functional.pad(nlist.nbr, (0, 0, 0, c_pad - C),
                                    value=c_pad)

    packs = []
    for s, dev in enumerate(devices):
        own = slice(s * ps, (s + 1) * ps)
        nbr_cat = torch.where(nbr_valid[own],
                              halo.cat_remap(nbr_p[own], s, ps, c_pad),
                              torch.full_like(nbr_p[own], dummy_cl))
        ex = excl_pad[s * ps * CLUSTER:(s + 1) * ps * CLUSTER]
        e_ok = ex >= 0
        e_cl = halo.cat_remap(torch.where(e_ok, ex, torch.zeros_like(ex))
                              // CLUSTER, s, ps, c_pad)
        excl_cat = torch.where(e_ok & (e_cl != dummy_cl),
                               e_cl * CLUSTER + torch.remainder(ex, CLUSTER),
                               torch.full_like(ex, -1))
        cat = {k: halo.cat_rows(v, s, ps, 0).contiguous().to(dev)
               for k, v in static.items()}
        packs.append(nb_cluster.PrepCluster(
            layout="table", n_icl=ps, i0=halo.own_blk * ps, halo=True,
            nbr=nbr_cat.to(torch.int32).contiguous().to(dev),
            cnt=torch.sum(nbr_valid[own], 1).to(torch.int32).contiguous()
            .to(dev),
            excl=excl_cat.to(torch.int32).contiguous().to(dev),
            nbfp=(system.nbfp.to(torch.float32).contiguous().to(dev)
                  if lj_table else None), **cat))

    def planes_of(xs):
        return halo.cat_planes(xs, ps, devices)

    def halo_force(xs, box, need_energy: bool = True):
        planes = planes_of(xs)
        f_rows, e64 = [], torch.zeros(2, dtype=torch.float64,
                                      device=xs.device)
        for s, dev in enumerate(devices):
            with _on(dev):
                fx, fy, fz, e = nb_cluster.nb_cluster_forces(
                    list(planes[s]), box.to(dev), packs[s], consts,
                    need_energy)
            f_rows.append(torch.stack([fx, fy, fz], -1).to(xs.device))
            e64 = e64 + e.to(xs.device, torch.float64).sum(0)
        return (torch.cat(f_rows), (0.5 * e64[0]).to(xs.dtype),
                (0.5 * e64[1]).to(xs.dtype))

    # the pieces chip_smoke.py holds against their plain versions
    halo_force.c_pad = c_pad
    halo_force.packs = packs
    halo_force.planes = planes_of
    return halo_force


def make_dd_nb_override(system: System, params: MdParams, mesh: DeviceMesh,
                        beta, block: int = 8, grid=None):
    """nb_kernel_override of make_cluster_force_fn for the table route under
    DD: nb(x, box, nlist, prep, need_energy) -> (f_sorted, e_coul, e_lj).
    prep is nb.prepare(nlist) of the same rebuild (make_halo_cluster_force),
    or None (packed on the fly).  Requires the list built with the matching
    sort and halo_violations == 0 (the runner checks each rebuild)."""
    grid = grid if grid is not None else mesh.shape[SPATIAL_AXIS]

    def prepare(nlist: ClusterPairlist, prep=None):
        return make_halo_cluster_force(system, params, mesh, beta, nlist,
                                       block=block, grid=grid)

    def nb(x, box, nlist: ClusterPairlist, prep=None,
           need_energy: bool = True):
        halo = prep if callable(prep) else prepare(nlist)
        xs = sort_state_arrays(x, nlist, halo.c_pad)
        f_rows, e_c, e_lj = halo(xs, box, need_energy)
        return f_rows[:nlist.n_pad], e_c, e_lj

    nb.prepare = prepare
    nb.layout = "table"
    return nb


# -- K6 ---------------------------------------------------------------------

@dataclasses.dataclass
class DdPackV2U:
    """Per-rebuild data of K6: for each domain its slice of the v2u pack
    (PrepV2U of sps = ps / 4 blocks on the domain's device, nbr2 holding
    cat-space cluster ids as int32), the geometry, and the rebuild's image
    counts when the shifts are baked."""
    ps: int
    c_pad: int
    domains: List[PrepV2U]
    img: Optional[torch.Tensor]


def make_dd_v2u_override(system: System, params: MdParams, mesh: DeviceMesh,
                         beta, block: int = 8, grid=None):
    """nb_kernel_override routing the v2u kernel through the halo (K6):
    nb(x, box, nlist, prep, need_energy) -> (f_sorted, e_coul, e_lj).  Each
    domain owns a contiguous range of 4-cluster i-blocks, receives its
    halo neighbours' position strips and runs the v2u body on its blocks
    with the j lanes read from its cat plane (ops/nb_v2u.py
    nb_v2u_dd_forces).  prep is nb.prepare(nlist, prep_v2u) of the same
    rebuild (a DdPackV2U), or the PrepV2U itself (packed on the fly).
    Requires the list built with the DD sort, super_block=4 and
    halo_violations == 0."""
    halo = HaloGrid(grid if grid is not None else mesh.shape[SPATIAL_AXIS])
    _check_mesh(mesh, halo)
    devices = mesh.spatial_devices
    consts = NbConstants.from_params(params, beta)

    def prepare(nlist: ClusterPairlist, prep: PrepV2U) -> DdPackV2U:
        ps, c_pad = halo_shard_geometry(nlist, halo.grid, block)
        if ps % BU:
            raise ValueError("DD cell size must align to 4-cluster blocks")
        sps, Sp = ps // BU, c_pad // BU
        C = nlist.n_clusters

        def padb(a, fill=0):
            if a is None or a.shape[0] == Sp:
                return a
            pad = torch.full((Sp - a.shape[0],) + tuple(a.shape[1:]), fill,
                             dtype=a.dtype, device=a.device)
            return torch.cat([a, pad])
        full = {f.name: padb(getattr(prep, f.name),
                             C if f.name == "nbr2" else 0)
                for f in dataclasses.fields(PrepV2U)}
        domains = []
        for s, dev in enumerate(devices):
            blk = slice(s * sps, (s + 1) * sps)
            part = {k: (None if v is None else v[blk].contiguous().to(dev))
                    for k, v in full.items()}
            part["nbr2"] = halo.cat_remap(full["nbr2"][blk], s, ps, c_pad
                                          ).to(torch.int32).contiguous() \
                .to(dev)
            domains.append(PrepV2U(**part))
        return DdPackV2U(ps=ps, c_pad=c_pad, domains=domains,
                         img=nlist.img if prep.shift is not None else None)

    def planes(x, box, nlist: ClusterPairlist, pack: DdPackV2U):
        """Each domain's (3, n_cat_rows) cat plane of one step."""
        xs = sort_state_arrays(x, nlist, pack.c_pad, img=pack.img, box=box)
        return halo.cat_planes(xs, pack.ps, devices)

    def nb(x, box, nlist: ClusterPairlist, prep, need_energy: bool = True):
        pack = prep if isinstance(prep, DdPackV2U) else prepare(nlist, prep)
        cat = planes(x, box, nlist, pack)
        f_rows, e_c, e_lj = [], 0.0, 0.0
        for s, dev in enumerate(devices):
            with _on(dev):
                fx, fy, fz, e = nb_v2u_dd_forces(
                    cat[s], halo.own_blk * pack.ps, box.to(dev),
                    pack.domains[s], consts, need_energy)
            f_rows.append(torch.stack([fx.reshape(-1), fy.reshape(-1),
                                       fz.reshape(-1)], -1).to(x.device))
            e_c = e_c + torch.sum(e[:, 0]).to(x.device)
            e_lj = e_lj + torch.sum(e[:, 1]).to(x.device)
        return torch.cat(f_rows)[:nlist.n_pad], 0.5 * e_c, 0.5 * e_lj

    nb.prepare = prepare
    nb.planes = planes
    nb.halo = halo
    nb.layout = "v2u"
    return nb


# -- PME --------------------------------------------------------------------

def _pad_dim(t, dim: int, size: int):
    """t zero-padded along dim to `size` (complex tensors too)."""
    if t.shape[dim] == size:
        return t
    shape = list(t.shape)
    shape[dim] = size - t.shape[dim]
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)],
                     dim=dim)


def make_sharded_pme(system: System, params: MdParams, mesh: DeviceMesh,
                     grid_shape=None):
    """Sharded PME reciprocal part: pme_fn(x, box, lam_c) -> (E, F,
    dvdl_c), the counterpart of the single-device force function
    (ops/pme.py _recip_force_fn) over the spatial domains:
      1. domain d spreads its atom chunk (chunk = ceil(n / nsh) atoms in
         the original order) onto the whole grid (K2 on a GPU),
      2. psum_scatter reduces the grids into axis-0 slabs (padded to K1p, a
         multiple of nsh),
      3. FFTs along axes 1 and 2 run on the slab,
      4. all_to_all turns slabs into axis-1 pencils (K2 padded to K2p),
         and the FFT along axis 0 runs on the first K1 rows,
      5. each domain applies its pencil of the influence function (the
         energy is a sum over domains),
      6. the inverse retraces the path (the same forward transforms of
         G conj(Q^), as ops/pme.py energy_and_potential),
      7. all_gather rebuilds the potential grid and each domain gathers its
         chunk's forces and dE/dq (K3 on a GPU).
    The lambda(1-lambda) E[dq] term of the perturbed atoms runs on the
    whole grid on the home device, as in JAX.  The virial is not ported
    under DD (pressure coupling raises)."""
    st = pme_mod._RecipSetup(system, params, grid_shape)
    beta, order = st.beta, st.order
    K = st.grid_shape
    K1, K2, _ = K
    devices = mesh.spatial_devices
    nsh = len(devices)
    K1p, K2p = -(-K1 // nsh) * nsh, -(-K2 // nsh) * nsh
    S2 = K2p // nsh
    n = int(system.n_atoms)
    chunk = -(-n // nsh)
    n_pad = chunk * nsh

    def pme_fn(x, box, lam_c, need_virial: bool = False):
        if need_virial:
            raise NotImplementedError("the PME virial under domain "
                                      "decomposition is not ported")
        home, dt = x.device, x.dtype
        vol = pbc_mod.box_volume(box)
        qa, qb, dq = (c.to(dt) for c in (st.qa, st.qb, st.dq))
        q = ((1.0 - lam_c) * qa + lam_c * qb) if st.fep_q else qa
        x_pad = _pad_dim(x, 0, n_pad)
        q_pad = _pad_dim(q, 0, n_pad)
        G, scale = pme_mod._influence_scaled(box, st.influence(dt), beta, dt)
        G_pad = _pad_dim(G, 1, K2p)
        xb = [(x_pad[s * chunk:(s + 1) * chunk].contiguous().to(d),
               q_pad[s * chunk:(s + 1) * chunk].contiguous().to(d),
               box.to(d)) for s, d in enumerate(devices)]
        grids = []
        for (xd, qd, bd), d in zip(xb, devices):
            with _on(d):
                grids.append(_pad_dim(pme_mod._spread_dispatch(
                    xd, bd, qd, K, order), 0, K1p))
        slabs = psum_scatter(grids, 0)                       # (S1, K2, K3)
        spec = [_pad_dim(torch.fft.fft(torch.fft.fft(s, dim=2), dim=1),
                         1, K2p) for s in slabs]
        pencils = all_to_all(spec, split_dim=1, concat_dim=0)
        qh = [torch.fft.fft(p[:K1], dim=0) for p in pencils]  # (K1, S2, K3)
        g_sh = [G_pad[:, s * S2:(s + 1) * S2].to(d)
                for s, d in enumerate(devices)]
        energy = sum((scale.to(d) * torch.sum(g * (h.real ** 2
                                                    + h.imag ** 2))).to(home)
                     for g, h, d in zip(g_sh, qh, devices))
        back = [_pad_dim(torch.fft.fft(g * torch.conj(h), dim=0), 0, K1p)
                for g, h in zip(g_sh, qh)]
        slabs = all_to_all(back, split_dim=0, concat_dim=1)  # (S1, K2p, K3)
        phi_slab = [(2.0 * scale.to(s.device) * torch.fft.fft(
            torch.fft.fft(s[:, :K2], dim=1), dim=2).real) for s in slabs]
        phis = all_gather(phi_slab, 0)
        f_parts, dedq_parts = [], []
        for (xd, qd, bd), phi, d in zip(xb, phis, devices):
            with _on(d):
                f_d, dedq_d = pme_mod.phi_gather(
                    xd, bd, qd, phi[:K1].contiguous(), K, order)
            f_parts.append(f_d.to(home))
            dedq_parts.append(dedq_d.to(home))
        f = torch.cat(f_parts)[:n]
        dEdq = torch.cat(dedq_parts)[:n]
        e = energy + pme_mod.self_energy(q, beta) \
            + pme_mod.net_charge_energy(q, beta, vol)
        if not st.fep_q:
            return e, f, torch.zeros((), dtype=dt, device=home)
        xp = x[st.pert_idx].detach().requires_grad_(True)
        with torch.enable_grad():
            grid_dd = pme_mod.spread_charges_scatter(xp, box, dq, K, order)
            e_kk = pme_mod.mesh_energy(grid_dd, box, beta, st.influence(dt))
            (g_kk,) = torch.autograd.grad(e_kk, xp)
        e_dd = (e_kk.detach() + pme_mod.self_energy(dq, beta)
                + pme_mod.net_charge_energy(dq, beta, vol))
        lam_fac = lam_c * (1.0 - lam_c)
        e = e + lam_fac * e_dd
        f = f.index_add(0, st.pert_idx, -lam_fac * g_kk)
        dvdl = torch.sum(dEdq[st.pert_idx] * dq)
        dvdl = dvdl - 2.0 * ONE_4PI_EPS0 * beta / math.sqrt(math.pi) \
            * torch.sum(q[st.pert_idx] * dq)
        dvdl = dvdl - ONE_4PI_EPS0 * math.pi / (beta ** 2 * vol) \
            * (torch.sum(q) * torch.sum(dq))
        dvdl = dvdl + (1.0 - 2.0 * lam_c) * e_dd
        return e, f, dvdl

    return pme_fn
