"""Per-i-cluster-list non-bonded kernels — PyTorch/CUDA counterpart of
gromacs_fep_gpu_tpu/ops/pallas_nb.py for the non-default layouts (K7a
pallas_prepare / pallas_cluster_forces, K7b pallas_prepare_cl /
pallas_cluster_forces_cl, K7c pallas_prepare_v2 / pallas_cluster_forces_v2)
and of the XLA kernel of gromacs_fep_gpu_tpu/ops/cluster_nb.py
(cluster_nb_kernel_core) for the table route.

Layouts, each a list form of its own and a wrapper with its own launch
counter:
- "super" (K7a): 8-cluster superclusters sharing one union j list (built
  with super_block=8), in-loop minimum image, exclusion ids;
- "cluster" (K7b): each i-cluster's own list (nnbr > 0), in-loop minimum
  image, exclusion ids;
- "v2" (K7c): each i-cluster's own list with build-time shifts per entry
  (compute_shifts) and per-lane bit masks (bit a: pair valid for i atom a,
  bit 8+a: not excluded);
- "table": each i-cluster's own list, in-loop minimum image, exclusion
  ids, LJ from the (T, T, 2) table or per-atom sqrt(c6)/sqrt(c12), every
  vdW modifier, exact erfc, and the diagonal virial flavour.
K7a/b/c are geometric-LJ, potential-shift kernels with the erfc
polynomial (energy flavour) and the pmecorrF fit (force flavour), as the
TPU kernels are; the table route is the XLA kernel's arithmetic.

Unlike the TPU kernels, which stream pre-gathered j data, the Hopper
kernel (csrc/nb_cluster.cu) reads the sorted atom planes directly by
cluster id: the per-rebuild pack holds the static planes and the list, the
per-step input is three coordinate planes.  Dispatch goes by the tensors'
device: CPU tensors take the plain PyTorch versions (`k7_plain`,
`cluster_nb_kernel_core`), CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.types import CoulombType, VdwModifier
from . import cuda_lib
from .nb_v2u import (R2_FLOOR, TWO_OVER_SQRT_PI, NbConstants, _COUL_CODE,
                     _check, _erfc_poly, _pmecorr_f_recip)
from .pairlist import CLUSTER, ClusterPairlist

SB = 8                  # i-clusters per supercluster (K7a) and per CTA
LAYOUTS = ("super", "cluster", "v2", "table")
MAX_TYPES = 64          # table mode keeps the (T, T, 2) table in shared
_LAYOUT_CODE = {"super": 0, "cluster": 1, "v2": 2, "table": 3}
_FLAVOUR_CODE = {"F": 0, "VF": 1, "VFV": 2}
_MOD_CODE = {VdwModifier.NONE: 0, VdwModifier.POTENTIAL_SHIFT: 1,
             VdwModifier.FORCE_SWITCH: 2, VdwModifier.POTENTIAL_SWITCH: 3}

# launches of the CUDA kernel, by layout and flavour (F = force only, VF =
# energies, VFV = energies and virial); table_dd: the table route on a
# domain's i-cluster range (PrepCluster.halo), one per domain launch
launches = {"super": {"F": 0, "VF": 0}, "cluster": {"F": 0, "VF": 0},
            "v2": {"F": 0, "VF": 0}, "table": {"F": 0, "VF": 0, "VFV": 0},
            "table_dd": {"F": 0, "VF": 0}}


@dataclasses.dataclass
class PrepCluster:
    """Per-rebuild data of one layout: static planes over n_rows = (C_pad
    + 1) * 8 sorted atoms (C_pad = 8 ceil(C / 8) i-clusters plus the
    trailing dummy cluster that the padded id C may name), and the list.
    Under domain decomposition (parallel/spatial.py, halo=True) the planes
    are a domain's halo-extended plane and the i-clusters the range [i0,
    i0 + n_icl) of it; the list rows, the exclusions of the i atoms and the
    outputs are indexed from i0."""
    layout: str
    n_icl: int                    # C_pad (i-clusters of the range)
    q: torch.Tensor               # (n_rows,) f32 charges (state A)
    pv: torch.Tensor              # (n_rows,) f32 valid * (1 - perturbed)
    nbr: torch.Tensor             # (R, W) i32 j-cluster ids, valid first
    cnt: torch.Tensor             # (R,) i32 valid entries per row
    s6: Optional[torch.Tensor] = None     # (n_rows,) f32 sqrt(c6_ii)
    s12: Optional[torch.Tensor] = None    # (n_rows,) f32 sqrt(c12_ii)
    types: Optional[torch.Tensor] = None  # (n_rows,) i32 (table LJ)
    nbfp: Optional[torch.Tensor] = None   # (T, T, 2) f32 (table LJ)
    excl: Optional[torch.Tensor] = None   # (n_rows, K) i32, -1 pad
    shift: Optional[torch.Tensor] = None  # (R, W, 3) f32 box counts (v2)
    jmask: Optional[torch.Tensor] = None  # (R, W, 8) i32 lane bits (v2)
    img: Optional[torch.Tensor] = None    # (n_pad, 3) f32 image counts (v2)
    i0: int = 0                   # first i-cluster of the planes
    halo: bool = False            # a domain's pack (counted as table_dd)

    @property
    def n_rows(self) -> int:
        return self.q.shape[0]


def _planes(nlist: ClusterPairlist, nbfp, lj_table: bool):
    """Static per-atom planes padded to (C_pad + 1) clusters."""
    n = nlist.inv_perm.shape[0]
    C = nlist.n_clusters
    C_pad = -(-C // SB) * SB
    extra = (C_pad + 1) * CLUSTER - nlist.n_pad
    dev = nbfp.device

    def pad(a, fill=0.0):
        return torch.cat([a, torch.full((extra,), fill, dtype=a.dtype,
                                        device=dev)])
    pv = (nlist.perm < n).to(torch.float32) * (1.0 - nlist.pert)
    K = nlist.excl.shape[1]
    excl = torch.cat([nlist.excl, torch.full((extra, K), -1,
                                             dtype=nlist.excl.dtype,
                                             device=dev)])
    out = dict(n_icl=C_pad, q=pad(nlist.q_a).contiguous(),
               pv=pad(pv).contiguous(),
               excl=excl.to(torch.int32).contiguous())
    if lj_table:
        out.update(types=pad(nlist.t_a, 0).to(torch.int32).contiguous(),
                   nbfp=nbfp.to(torch.float32).contiguous())
    else:
        d6 = torch.sqrt(torch.clamp(torch.diagonal(nbfp[:, :, 0]), min=0.0))
        d12 = torch.sqrt(torch.clamp(torch.diagonal(nbfp[:, :, 1]),
                                     min=0.0))
        out.update(s6=pad(d6[nlist.t_a]).contiguous(),
                   s12=pad(d12[nlist.t_a]).contiguous())
    return out


def _rows(nbr, C, n_rows_out):
    """(n_rows_out, W) i32 ids with pad C (rows past the list: all pad)
    and the (n_rows_out,) count of valid entries."""
    nbr = torch.where(nbr >= 0, nbr, torch.full_like(nbr, C))
    nbr = torch.nn.functional.pad(nbr, (0, 0, 0, n_rows_out - nbr.shape[0]),
                                  value=C)
    cnt = torch.sum(nbr != C, dim=1).to(torch.int32)
    return nbr.to(torch.int32).contiguous(), cnt.contiguous()


def prepare_super(nlist: ClusterPairlist, nbfp) -> PrepCluster:
    """K7a's pack (pallas_prepare): the union rows of 8-cluster blocks.
    nlist must come from build_cluster_pairlist with super_block=8."""
    if nlist.nbr_super is None:
        raise ValueError("the supercluster layout needs the union list "
                         "(build_cluster_pairlist with super_nnbr)")
    p = _planes(nlist, nbfp, lj_table=False)
    S = p["n_icl"] // SB
    if nlist.nbr_super.shape[0] != S:
        raise ValueError("the supercluster layout needs super_block=8")
    nbr, cnt = _rows(nlist.nbr_super, nlist.n_clusters, S)
    return PrepCluster(layout="super", nbr=nbr, cnt=cnt, **p)


def prepare_cluster(nlist: ClusterPairlist, nbfp) -> PrepCluster:
    """K7b's pack (pallas_prepare_cl): each i-cluster's own list."""
    if nlist.nbr is None:
        raise ValueError("the cluster layout needs the per-cluster list "
                         "(build_cluster_pairlist with nnbr > 0)")
    p = _planes(nlist, nbfp, lj_table=False)
    nbr, cnt = _rows(nlist.nbr, nlist.n_clusters, p["n_icl"])
    return PrepCluster(layout="cluster", nbr=nbr, cnt=cnt, **p)


def prepare_table(nlist: ClusterPairlist, nbfp, lj_mode: str
                  ) -> PrepCluster:
    """The table route's pack: each i-cluster's own list; LJ from the
    table (lj_mode "table") or per-atom square roots ("geometric")."""
    if nlist.nbr is None:
        raise ValueError("the table route needs the per-cluster list "
                         "(build_cluster_pairlist with nnbr > 0)")
    p = _planes(nlist, nbfp, lj_table=lj_mode == "table")
    nbr, cnt = _rows(nlist.nbr, nlist.n_clusters, p["n_icl"])
    return PrepCluster(layout="table", nbr=nbr, cnt=cnt, **p)


def prepare_v2(nlist: ClusterPairlist, nbfp) -> PrepCluster:
    """K7c's pack (pallas_prepare_v2): each i-cluster's own list, its
    build-time shifts and the per-lane bit masks.  nlist must come from
    build_cluster_pairlist with nnbr > 0, compute_shifts=True and no union
    list."""
    if nlist.nbr_shift is None:
        raise ValueError("the v2 layout needs per-cluster shifts "
                         "(build_cluster_pairlist with compute_shifts=True "
                         "and no union list)")
    p = _planes(nlist, nbfp, lj_table=False)
    C, C_pad = nlist.n_clusters, p["n_icl"]
    nbr, cnt = _rows(nlist.nbr, C, C_pad)
    W = nbr.shape[1]
    shift = torch.nn.functional.pad(nlist.nbr_shift.to(torch.float32),
                                    (0, 0, 0, 0, 0, C_pad - C))
    dev = nbfp.device
    jid = (nbr.to(torch.int64)[..., None] * CLUSTER
           + torch.arange(CLUSTER, device=dev))              # (C_pad, W, 8)
    pvj = p["pv"][jid] > 0
    iid = torch.arange(C_pad * CLUSTER, device=dev).reshape(C_pad, CLUSTER)
    pvi = p["pv"][:C_pad * CLUSTER].reshape(C_pad, CLUSTER) > 0
    ei = p["excl"][:C_pad * CLUSTER].reshape(C_pad, CLUSTER, -1)
    bits = torch.zeros((C_pad, W, CLUSTER), dtype=torch.int32, device=dev)
    for a in range(CLUSTER):
        ok = pvj & pvi[:, a, None, None] & (jid != iid[:, a, None, None])
        exm = torch.zeros_like(ok)
        for k in range(ei.shape[-1]):
            exm |= jid == ei[:, a, k, None, None]
        bits |= (ok.to(torch.int32) << a) | ((~exm).to(torch.int32)
                                             << (8 + a))
    p.pop("excl")
    return PrepCluster(layout="v2", nbr=nbr, cnt=cnt, shift=shift,
                       jmask=bits, img=nlist.img, **p)


PREPARE = {"super": prepare_super, "cluster": prepare_cluster,
           "v2": prepare_v2}


def gather_planes(x, box, nlist: ClusterPairlist, prep: PrepCluster):
    """Per-step sorted coordinate planes (n_rows,) x3: padding atoms at
    1e4 + i, the trailing dummy cluster at 2e4 + i; for v2 the rebuild's
    image counts are removed (rectangular box), so the build-time shifts
    hold for the whole nstlist window."""
    n = nlist.inv_perm.shape[0]
    n_pad = nlist.n_pad
    dev = x.device
    xs = x[torch.clamp(nlist.perm, max=n - 1)]
    if prep.img is not None:
        xs = xs - prep.img * torch.diagonal(box)
    xs = torch.where((nlist.perm < n)[:, None], xs,
                     1e4 + torch.arange(n_pad, dtype=x.dtype,
                                        device=dev)[:, None])
    dummy = (2e4 + torch.arange(prep.n_rows - n_pad, dtype=x.dtype,
                                device=dev)[:, None]
             * torch.ones(3, dtype=x.dtype, device=dev))
    xs = torch.cat([xs, dummy])
    return [xs[:, d].contiguous() for d in range(3)]


def _icluster_blocks(n_icl: int, block: int):
    for c0 in range(0, n_icl, block):
        yield c0, min(block, n_icl - c0)


def k7_plain(planes, box, prep: PrepCluster, consts: NbConstants,
             compute_energy: bool, block: int = 64):
    """Plain PyTorch version of K7a/b/c: (fx, fy, fz (n_icl * 8,), e
    (n_icl, 2)) with e = per-i-cluster (coulomb, lj) sums over the full
    list (not yet halved; zeros in the force flavour).  The TPU kernels'
    arithmetic: geometric LJ with potential shift; PME real space with the
    erfc polynomial (energies) or the pmecorrF fit (forces only);
    rectangular minimum image floor(d / L + 0.5) per pair (super,
    cluster) or build-time shifts (v2)."""
    if prep.layout not in ("super", "cluster", "v2"):
        raise ValueError(prep.layout)
    xs, ys, zs = planes
    dev = xs.device
    c = consts
    bl = torch.diagonal(box)
    a_sub = torch.arange(CLUSTER, dtype=torch.int32,
                         device=dev).reshape(1, CLUSTER, 1)
    fxyz = torch.zeros((3, prep.n_icl * CLUSTER), dtype=xs.dtype,
                       device=dev)
    e = torch.zeros((prep.n_icl, 2), dtype=xs.dtype, device=dev)
    for c0, B in _icluster_blocks(prep.n_icl, block):
        ci = torch.arange(c0, c0 + B, device=dev)
        row = ci // SB if prep.layout == "super" else ci
        jc = prep.nbr[row].to(torch.int64)                       # (B, W)
        W = jc.shape[1]
        jid = (jc[..., None] * CLUSTER
               + torch.arange(CLUSTER, device=dev)).reshape(B, W * CLUSTER)
        iid = ci[:, None] * CLUSTER + torch.arange(CLUSTER, device=dev)
        d = []
        for a, p in enumerate((xs, ys, zs)):
            pj = p[jid]
            if prep.layout == "v2":
                pj = pj + torch.repeat_interleave(
                    prep.shift[row][..., a] * bl[a], CLUSTER, dim=1)
            da = p[iid][..., None] - pj[:, None, :]
            if prep.layout != "v2":
                da = da - torch.floor(da * (1.0 / bl[a]) + 0.5) * bl[a]
            d.append(da)
        dx, dy, dz = d
        if prep.layout == "v2":
            m = prep.jmask[row].reshape(B, 1, W * CLUSTER)
            pairb = ((m >> a_sub) & 1).to(xs.dtype)
            inclb = ((m >> (a_sub + 8)) & 1).to(xs.dtype)
        else:
            pairb = (prep.pv[iid][..., None] * prep.pv[jid][:, None, :]
                     * (iid[..., None] != jid[:, None, :]))
            ei = prep.excl[iid].to(torch.int64)                  # (B, 8, K)
            exm = torch.zeros(pairb.shape, dtype=torch.bool, device=dev)
            for k in range(ei.shape[-1]):
                exm |= ei[:, :, k, None] == jid[:, None, :]
            inclb = 1.0 - exm.to(xs.dtype)
        r2 = torch.clamp(dx * dx + dy * dy + dz * dz, R2_FLOOR, 1e6)
        rinv = torch.rsqrt(r2)
        rinv2 = rinv * rinv
        in_c = torch.where(r2 < c.rc2, pairb, 0.0)
        in_v = torch.where(r2 < c.rv2, pairb * inclb, 0.0)
        c6 = prep.s6[iid][..., None] * prep.s6[jid][:, None, :]
        c12 = prep.s12[iid][..., None] * prep.s12[jid][:, None, :]
        rinv6 = torch.clamp(rinv2 * rinv2 * rinv2, max=1e15)
        rinv12 = rinv6 * rinv6
        f_lj = (12.0 * c12 * rinv12 - 6.0 * c6 * rinv6) * rinv2 * in_v
        qq = c.epsfac * prep.q[iid][..., None] * prep.q[jid][:, None, :]
        if c.coulomb == CoulombType.REACTION_FIELD:
            f_c = qq * (inclb * rinv2 * rinv - 2.0 * c.krf) * in_c
        elif c.coulomb == CoulombType.PME:
            if compute_energy:
                br = c.beta * (r2 * rinv)
                erfc_t = _erfc_poly(br)
                f_c = (qq * rinv2 * ((inclb - (1.0 - erfc_t)) * rinv
                                     + c.beta * TWO_OVER_SQRT_PI
                                     * torch.exp(-br * br)) * in_c)
            else:
                f_c = (qq * (inclb * rinv2 * rinv + c.beta ** 3
                             * _pmecorr_f_recip(c.beta ** 2 * r2)) * in_c)
        else:
            f_c = qq * inclb * rinv2 * rinv * in_c
        fscal = f_lj + f_c
        sl = slice(c0 * CLUSTER, (c0 + B) * CLUSTER)
        for a, da in enumerate((dx, dy, dz)):
            fxyz[a, sl] = torch.sum(fscal * da, dim=2).reshape(-1)
        if compute_energy:
            e_lj = (c12 * rinv12 - c6 * rinv6
                    - (c12 * c.rcinv6 * c.rcinv6 - c6 * c.rcinv6)) * in_v
            if c.coulomb == CoulombType.REACTION_FIELD:
                e_c = qq * (inclb * rinv + c.krf * r2 - c.crf) * in_c
            elif c.coulomb == CoulombType.PME:
                e_c = qq * rinv * (erfc_t - (1.0 - inclb)) * in_c
            else:
                e_c = qq * inclb * (rinv - c.inv_rc) * in_c
            e[c0:c0 + B, 0] = torch.sum(e_c, dim=(1, 2))
            e[c0:c0 + B, 1] = torch.sum(e_lj, dim=(1, 2))
    return fxyz[0], fxyz[1], fxyz[2], e


def cluster_nb_kernel_core(xs_pad, qs_pad, pv_pad, excl_pad, nbr_p, box,
                           consts: NbConstants, s6_pad=None, s12_pad=None,
                           ts_pad=None, nbfp=None,
                           compute_energy: bool = True,
                           compute_virial: bool = False, block: int = 64,
                           i0: int = 0):
    """Plain PyTorch version of the table route: the XLA kernel of
    cluster_nb.py (cluster_nb_kernel_core) over sorted padded rows.
    xs_pad (n_rows, 3), qs_pad, pv_pad = valid * (1 - perturbed), excl_pad
    (n_rows, K) sorted ids; nbr_p (n_icl, W) j-cluster ids into those
    rows.  LJ from the (T, T, 2) table nbfp at the types ts_pad, or, when
    nbfp is None, geometric from the per-atom square roots s6_pad/s12_pad.
    Returns (f (n_icl * 8, 3), e (n_icl, ne)): per-i-cluster (coulomb,
    lj[, vir_xx, vir_yy, vir_zz]) sums over the full list, not yet halved
    or scaled (zeros in the force flavour).  Every vdW modifier; exact
    erfc; rectangular minimum image round(d / L) (the XLA kernel's
    triclinic sequence on a rectangular box).  The rows may be float64.
    i0: the i-clusters are [i0, i0 + n_icl) of the rows (the JAX core's
    block_offset); nbr_p, excl_pad and the outputs count from i0."""
    if compute_virial and not compute_energy:
        raise ValueError("the virial rides the energy flavour")
    c = consts
    dev, dt = xs_pad.device, xs_pad.dtype
    n_icl, W = nbr_p.shape
    bl = torch.diagonal(box)
    ne = 5 if compute_virial else 2
    f = torch.zeros((n_icl * CLUSTER, 3), dtype=dt, device=dev)
    e = torch.zeros((n_icl, ne), dtype=dt, device=dev)
    if c.modifier == VdwModifier.FORCE_SWITCH:
        c2d, c3d, cp6, c2r, c3r, cp12 = c.fsw
    for c0, B in _icluster_blocks(n_icl, block):
        lid = (torch.arange(c0, c0 + B, device=dev)[:, None] * CLUSTER
               + torch.arange(CLUSTER, device=dev))              # (B, 8)
        iid = lid + i0 * CLUSTER
        jc = nbr_p[c0:c0 + B].to(torch.int64)
        jid = (jc[..., None] * CLUSTER
               + torch.arange(CLUSTER, device=dev)).reshape(B, W * CLUSTER)
        d = []
        for a in range(3):
            da = xs_pad[iid, a][..., None] - xs_pad[jid, a][:, None, :]
            d.append(da - torch.round(da / bl[a]) * bl[a])
        dx, dy, dz = d
        r2 = torch.clamp(dx * dx + dy * dy + dz * dz, min=R2_FLOOR)
        rinv = torch.rsqrt(r2)
        rinv2 = rinv * rinv
        pairm = (pv_pad[iid][..., None] * pv_pad[jid][:, None, :]
                 * (iid[..., None] != jid[:, None, :]))
        ei = excl_pad[lid].to(torch.int64)
        exm = torch.zeros(pairm.shape, dtype=torch.bool, device=dev)
        for k in range(ei.shape[-1]):
            exm |= ei[:, :, k, None] == jid[:, None, :]
        incl = 1.0 - exm.to(dt)
        in_c = (r2 < c.rc2).to(dt) * pairm
        in_v = (r2 < c.rv2).to(dt) * pairm * incl
        if nbfp is None:
            c6 = s6_pad[iid][..., None] * s6_pad[jid][:, None, :]
            c12 = s12_pad[iid][..., None] * s12_pad[jid][:, None, :]
        else:
            T = nbfp.shape[0]
            tt = (ts_pad[iid].to(torch.int64)[..., None] * T
                  + ts_pad[jid].to(torch.int64)[:, None, :])
            flat = nbfp.reshape(T * T, 2).to(dt)
            c6, c12 = flat[tt, 0], flat[tt, 1]
        rinv6 = torch.clamp(rinv2 * rinv2 * rinv2, max=1e15)
        rinv12 = rinv6 * rinv6
        e_lj = c12 * rinv12 - c6 * rinv6
        f_lj = (12.0 * c12 * rinv12 - 6.0 * c6 * rinv6) * rinv2
        if c.modifier == VdwModifier.POTENTIAL_SHIFT:
            e_lj = e_lj - (c12 * c.rcinv6 * c.rcinv6 - c6 * c.rcinv6)
        elif c.modifier == VdwModifier.FORCE_SWITCH:
            rs = torch.clamp(r2 * rinv - c.rsw, min=0.0)
            rs3 = rs * rs * rs
            e_lj = (e_lj + c12 * (-4.0 * c2r * rs3 - 3.0 * c3r * rs3 * rs
                                  + cp12)
                    - c6 * (-2.0 * c2d * rs3 - 1.5 * c3d * rs3 * rs + cp6))
            f_lj = f_lj + (12.0 * c12 * (c2r + c3r * rs)
                           - 6.0 * c6 * (c2d + c3d * rs)) * rs * rs * rinv
        elif c.modifier == VdwModifier.POTENTIAL_SWITCH:
            dsw_d = c.rvdw - c.rsw
            t = torch.clamp((r2 * rinv - c.rsw) / dsw_d, 0.0, 1.0)
            sw = 1.0 + t ** 3 * (-10.0 + t * (15.0 - 6.0 * t))
            dsw = (t ** 2 * (-30.0 + t * (60.0 - 30.0 * t))) / dsw_d
            f_lj = f_lj * sw - e_lj * dsw * rinv
            e_lj = e_lj * sw
        e_lj = e_lj * in_v
        f_lj = f_lj * in_v
        qq = c.epsfac * qs_pad[iid][..., None] * qs_pad[jid][:, None, :]
        if c.coulomb == CoulombType.REACTION_FIELD:
            e_c = qq * (incl * rinv + c.krf * r2 - c.crf) * in_c
            f_c = qq * (incl * rinv2 * rinv - 2.0 * c.krf) * in_c
        elif c.coulomb == CoulombType.PME:
            br = c.beta * (r2 * rinv)
            erfc_t = torch.special.erfc(br)
            e_c = qq * rinv * (erfc_t - (1.0 - incl)) * in_c
            f_c = (qq * rinv2 * ((incl - (1.0 - erfc_t)) * rinv
                                 + c.beta * TWO_OVER_SQRT_PI
                                 * torch.exp(-br * br)) * in_c)
        else:
            e_c = qq * incl * (rinv - c.inv_rc) * in_c
            f_c = qq * incl * rinv2 * rinv * in_c
        fscal = f_lj + f_c
        sl = slice(c0 * CLUSTER, (c0 + B) * CLUSTER)
        f[sl] = torch.stack([torch.sum(fscal * da, dim=2).reshape(-1)
                             for da in (dx, dy, dz)], dim=-1)
        if compute_energy:
            e[c0:c0 + B, 0] = torch.sum(e_c, dim=(1, 2))
            e[c0:c0 + B, 1] = torch.sum(e_lj, dim=(1, 2))
        if compute_virial:
            for a, da in enumerate((dx, dy, dz)):
                e[c0:c0 + B, 2 + a] = torch.sum(fscal * da * da, dim=(1, 2))
    return f, e


def table_plain(planes, box, prep: PrepCluster, consts: NbConstants,
                compute_energy: bool, compute_virial: bool = False):
    """The table route's plain version on the kernel's inputs:
    cluster_nb_kernel_core over the pack's planes; same outputs as
    k7_plain, with ne = 5 in the virial flavour."""
    f, e = cluster_nb_kernel_core(
        torch.stack(planes, dim=-1), prep.q, prep.pv, prep.excl, prep.nbr,
        box, consts, s6_pad=prep.s6, s12_pad=prep.s12, ts_pad=prep.types,
        nbfp=prep.nbfp, compute_energy=compute_energy,
        compute_virial=compute_virial, i0=prep.i0)
    return f[:, 0], f[:, 1], f[:, 2], e


def nb_cluster_cuda(planes, box, prep: PrepCluster, consts: NbConstants,
                    compute_energy: bool, compute_virial: bool = False):
    """Launch csrc/nb_cluster.cu on the current stream for the pack's
    layout; same outputs as its plain version."""
    layout = prep.layout
    if compute_virial and (layout != "table" or not compute_energy):
        raise ValueError("the virial flavour is the table route's, with "
                         "energies")
    if layout != "table" and consts.modifier != VdwModifier.POTENTIAL_SHIFT:
        raise ValueError(f"the {layout} layout is a potential-shift kernel")
    f32, i32 = torch.float32, torch.int32
    n_rows, n_icl = prep.n_rows, prep.n_icl
    R, W = prep.nbr.shape
    for k, t in enumerate(planes):
        _check(t, f"coordinate plane {k}", f32, (n_rows,))
    _check(prep.q, "q", f32, (n_rows,))
    _check(prep.pv, "pv", f32, (n_rows,))
    _check(prep.nbr, "nbr", i32, (R, W))
    _check(prep.cnt, "cnt", i32, (R,))
    _check(box, "box", f32, (3, 3))
    lj_table = prep.nbfp is not None
    T = K = 0
    if lj_table:
        T = prep.nbfp.shape[0]
        if T > MAX_TYPES:
            raise NotImplementedError(
                f"the table kernel holds at most {MAX_TYPES} atom types "
                f"in shared memory, the system has {T}")
        _check(prep.types, "types", i32, (n_rows,))
        _check(prep.nbfp, "nbfp", f32, (T, T, 2))
    else:
        _check(prep.s6, "s6", f32, (n_rows,))
        _check(prep.s12, "s12", f32, (n_rows,))
    if layout == "v2":
        _check(prep.shift, "shift", f32, (R, W, 3))
        _check(prep.jmask, "jmask", i32, (R, W, CLUSTER))
    else:
        K = prep.excl.shape[1]
        _check(prep.excl, "excl", i32, (prep.excl.shape[0], K))
        if prep.excl.shape[0] < n_icl * CLUSTER:
            raise ValueError("excl: fewer rows than the range's i atoms")
    if prep.i0 < 0 or (prep.i0 + n_icl) * CLUSTER > n_rows:
        raise ValueError(f"i-clusters [{prep.i0}, {prep.i0 + n_icl}) do "
                         f"not lie in planes of {n_rows} rows")
    dev = planes[0].device
    fx = torch.empty((n_icl * CLUSTER,), dtype=f32, device=dev)
    fy, fz = torch.empty_like(fx), torch.empty_like(fx)
    flavour = "VFV" if compute_virial else "VF" if compute_energy else "F"
    e = torch.empty((n_icl, 5 if compute_virial else 2), dtype=f32,
                    device=dev)
    c = consts

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = cuda_lib.library("nb_cluster")
    code = lib.nb_cluster_launch(
        *(t.data_ptr() for t in planes), prep.q.data_ptr(),
        prep.pv.data_ptr(), ptr(prep.s6), ptr(prep.s12), ptr(prep.types),
        ptr(prep.nbfp), ptr(prep.excl if layout != "v2" else None),
        prep.nbr.data_ptr(), prep.cnt.data_ptr(), ptr(prep.shift),
        ptr(prep.jmask), fx.data_ptr(), fy.data_ptr(), fz.data_ptr(),
        e.data_ptr(), box.data_ptr(), T, K, W, prep.i0, n_icl,
        _LAYOUT_CODE[layout],
        int(lj_table), _FLAVOUR_CODE[flavour], _COUL_CODE[c.coulomb],
        _MOD_CODE[c.modifier], c.epsfac, c.beta, c.rc2, c.rv2, c.krf, c.crf,
        c.rcinv6, c.inv_rc, c.rsw, c.rvdw, *c.fsw,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, f"nb_cluster ({layout})")
    launches["table_dd" if prep.halo else layout][flavour] += 1
    return fx, fy, fz, e


def nb_cluster_plain(planes, box, prep: PrepCluster, consts: NbConstants,
                     compute_energy: bool, compute_virial: bool = False):
    """The pack's layout's plain version: k7_plain for K7a/b/c,
    table_plain for the table route."""
    if prep.layout == "table":
        return table_plain(planes, box, prep, consts, compute_energy,
                           compute_virial)
    if compute_virial:
        raise ValueError("the virial flavour is the table route's")
    return k7_plain(planes, box, prep, consts, compute_energy)


def nb_cluster_forces(planes, box, prep: PrepCluster, consts: NbConstants,
                      compute_energy: bool, compute_virial: bool = False):
    """Kernel dispatch by device: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors."""
    fn = nb_cluster_plain if planes[0].device.type == "cpu" \
        else nb_cluster_cuda
    return fn(planes, box, prep, consts, compute_energy, compute_virial)


def cluster_forces(x, box, nlist: ClusterPairlist, prep: PrepCluster,
                   consts: NbConstants, compute_energy: bool = True,
                   compute_virial: bool = False):
    """(f_sorted (n_pad, 3), e_coul, e_lj) over the pack's list — the
    counterpart of pallas_cluster_forces{,_cl,_v2} and of the XLA
    cluster_nb_kernel; with compute_virial (table route) also the (3,)
    diagonal pair virial Xi_aa = -1/4 sum fscal d_a^2 (each pair counted
    twice).  Per-i-cluster partials are summed in float64."""
    planes = gather_planes(x, box, nlist, prep)
    fx, fy, fz, e = nb_cluster_forces(planes, box, prep, consts,
                                      compute_energy, compute_virial)
    n_pad = nlist.n_pad
    f_sorted = torch.stack([fx[:n_pad], fy[:n_pad], fz[:n_pad]], dim=-1)
    e64 = e.to(torch.float64)
    out = (f_sorted, (0.5 * e64[:, 0].sum()).to(e.dtype),
           (0.5 * e64[:, 1].sum()).to(e.dtype))
    if compute_virial:
        return out + ((-0.25 * e64[:, 2:5].sum(0)).to(e.dtype),)
    return out
