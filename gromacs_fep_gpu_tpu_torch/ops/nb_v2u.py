"""v2u cluster-pair non-bonded kernel (K1) — PyTorch/CUDA counterpart of
gromacs_fep_gpu_tpu/ops/pallas_nb.py for the v2u layout only
(_erfc_poly, _pmecorr_f_recip, PallasPrepV2U, pallas_prepare_v2u,
pallas_cluster_forces_v2u and the kernel body _make_kernel_v2u).

Data contract (unchanged from the TPU kernel): S i-blocks of BU=4
Hilbert-sorted 8-atom clusters (32 i atoms); each block walks its union
j-stream in G groups of GJU=32 j-clusters (256 j lanes) with build-time
periodic shifts; per-lane 32-bit pair and exclusion masks (bit c*8+a for i
atom a of cluster c); `ng` trip counts.  Perturbed atoms are masked out
here and handled by the FEP list.

Three flavours, as in the TPU kernel: F (forces), VF (forces and the
per-block energies) and VF+virial (compute_virial, the pressure steps of an
NPT run: also the per-block sums of fscal * d_a^2 per axis, which the
caller turns into the diagonal pair virial Xi_aa = -1/4 sum).

Two routes of `cluster_forces_v2u`, chosen by the tensors' device:
- CPU: `gather_coordinates` materialises the i planes (S, BU, 8) and the
  j planes (S, G, 256) with the shifts folded in, as the JAX package does,
  and `nb_v2u_plain` evaluates them (the plain version, bit for bit the
  route the tests hold against JAX);
- CUDA: only the sorted coordinate plane (3, (S * BU + 1) * 8) is built
  (`sorted_plane`: the image removal and the dummy rows of
  `gather_coordinates`), and the kernel of csrc/nb_v2u.cu reads each j
  lane from it by cluster id (`PrepV2U.nbr32`, an int32 copy of `nbr2`
  made once per rebuild) plus its baked shift; no j plane is built.  A CUDA
  tensor launches the kernel or raises.
The kernel culls whole (4 i atoms x 8 j atoms) tiles whose bounding boxes
lie beyond the cut-off; `cull_tiles_plain` is the plain mirror of that
cull, for the tests (nothing on the CUDA path calls it).

K6, the same body under domain decomposition (the JAX package's
parallel/spatial.py make_dd_v2u_override), is `nb_v2u_dd_forces`: one
domain's i-blocks on its halo-extended ("cat") coordinate plane, each j
lane read from that plane by cat-space cluster id plus its baked shift;
its plain version is `nb_v2u_dd_plain`, `gather_cat` followed by
`nb_v2u_plain`.  K1's CUDA route is the same launch with i_off = 0 on the
sorted plane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import CoulombType, MdParams, VdwModifier
from ..core.units import ONE_4PI_EPS0
from . import cuda_lib
from .nonbonded_ref import forceswitch_constants, rf_constants
from .pairlist import CLUSTER, ClusterPairlist

R2_FLOOR = 1e-6
TWO_OVER_SQRT_PI = 1.1283791670955126
BU = 4          # i-clusters per union block (32 atoms)
GJU = 32        # j-clusters per group (256 lanes)
LANES = GJU * CLUSTER
# the kernel skips a tile only where its box distance^2 exceeds
# rmax2 * (1 + CULL_MARGIN): a few ulp of rounding between the box test and
# the pair's r^2 can never cull a pair inside the cut-off
CULL_MARGIN = 1e-5
# the split fills this many waves of resident CTAs (split_count): on an
# NVIDIA H100 80GB HBM3 at 700 W, K1 at 12,290 atoms ran fastest at split 5
# (3.6 waves) of 1-10, and K6 per domain launch at a split near its ng max
# (chip_smoke.py's K1 rows print the unsplit time beside the split one)
SPLIT_WAVES = 3
_COUL_CODE = {CoulombType.CUTOFF: 0, CoulombType.REACTION_FIELD: 1,
              CoulombType.PME: 2}

# launches of the CUDA kernel, by flavor (F = force only, VF = energies,
# VFV = energies and virial; DD_F and DD_VF: K6, one per domain launch)
launches = {"F": 0, "VF": 0, "VFV": 0, "DD_F": 0, "DD_VF": 0}


def _erfc_poly(x):
    """erfc for x >= 0, Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7)."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return poly * torch.exp(-x * x)


def _pmecorr_f_recip(z2):
    """Rational fit of the Ewald force correction (reference:
    nbnxm_cuda_kernel_utils.cuh pmecorrF); the reciprocal is refined by one
    Newton step as in the TPU kernel."""
    FN = (-1.7357322914161492954e-8, 1.4703624142580877519e-6,
          -0.000053401640219807709149, 0.0010054721316683106153,
          -0.019278317264888380590, 0.069670166153766424023,
          -0.75225204789749321333)
    FD = (0.0011193462567257629232, 0.014866955030185295499,
          0.11583842382862377919, 0.50736591960530292870, 1.0)
    z4 = z2 * z2
    poly_fd0 = FD[0] * z4 + FD[2]
    poly_fd1 = FD[1] * z4 + FD[3]
    poly_fd0 = poly_fd0 * z4 + FD[4]
    poly_fd0 = poly_fd1 * z2 + poly_fd0
    poly_fn0 = FN[0] * z4 + FN[2]
    poly_fn1 = FN[1] * z4 + FN[3]
    poly_fn0 = poly_fn0 * z4 + FN[4]
    poly_fn1 = poly_fn1 * z4 + FN[5]
    poly_fn0 = poly_fn0 * z4 + FN[6]
    poly_fn0 = poly_fn1 * z2 + poly_fn0
    r = 1.0 / poly_fd0
    r = r * (2.0 - poly_fd0 * r)
    return poly_fn0 * r


@dataclasses.dataclass(frozen=True)
class NbConstants:
    """Scalar parameters of the kernels, derived once from MdParams.  The
    vdW modifier and its constants are read by the table route
    (ops/nb_cluster.py) only: K1 and K7a/b/c are potential-shift kernels."""
    coulomb: CoulombType
    epsfac: float
    beta: float
    rc2: float
    rv2: float
    krf: float
    crf: float
    rcinv6: float
    inv_rc: float
    modifier: VdwModifier = VdwModifier.POTENTIAL_SHIFT
    rsw: float = 0.0            # rvdw-switch
    rvdw: float = 1.0
    # force-switch (c2, c3, cpot) of r^-6 then of r^-12
    fsw: Tuple[float, ...] = (0.0,) * 6

    @staticmethod
    def from_params(params: MdParams, beta: Optional[float]):
        krf, crf = (rf_constants(params)
                    if params.coulomb == CoulombType.REACTION_FIELD
                    else (0.0, 0.0))
        fsw = (0.0,) * 6
        if params.vdw_modifier == VdwModifier.FORCE_SWITCH:
            fsw = (forceswitch_constants(6.0, params.rvdw_switch, params.rvdw)
                   + forceswitch_constants(12.0, params.rvdw_switch,
                                           params.rvdw))
        return NbConstants(
            coulomb=params.coulomb,
            epsfac=float(ONE_4PI_EPS0 / params.epsilon_r),
            beta=float(beta or 0.0), rc2=params.rcoulomb ** 2,
            rv2=params.rvdw ** 2, krf=krf, crf=crf,
            rcinv6=1.0 / params.rvdw ** 6, inv_rc=1.0 / params.rcoulomb,
            modifier=params.vdw_modifier, rsw=params.rvdw_switch,
            rvdw=params.rvdw, fsw=tuple(float(v) for v in fsw))


@dataclasses.dataclass
class PrepV2U:
    """Per-rebuild data of the union-stream kernel (PallasPrepV2U)."""
    iq: torch.Tensor       # (S, BU, 8) f32
    is6: torch.Tensor
    is12: torch.Tensor
    ng: torch.Tensor       # (S,) i32 j-group trip count
    ng_max: int            # ng.max(), read once per rebuild (the split)
    nbr2: torch.Tensor     # (S, G, GJU) i64 union j-cluster ids (pad C)
    nbr32: torch.Tensor    # (S, G, GJU) i32 copy of nbr2, read by the kernel
    jq: torch.Tensor       # (S, G, 256) f32
    js6: torch.Tensor
    js12: torch.Tensor
    pair_m: torch.Tensor   # (S, G, 256) i32, bit c*8+a = pair valid
    excl_m: torch.Tensor   # (S, G, 256) i32, bit c*8+a = not excluded
    # (S, G, GJU, 3) i8 build-time shifts in box-vector counts; None when
    # the kernel resolves the minimum image per pair (small boxes)
    shift: Optional[torch.Tensor]


def prepare_v2u(nlist: ClusterPairlist, nbfp: torch.Tensor,
                g_cap: Optional[int] = None) -> PrepV2U:
    """Pack the union-of-4 lists, shifts and bitmasks (the non-duo branch
    of pallas_prepare_v2u).  nlist must come from build_cluster_pairlist
    with super_block=4; with compute_shifts=True the shifts are baked."""
    dev = nbfp.device
    n = nlist.inv_perm.shape[0]
    n_pad = nlist.n_pad
    C = nlist.n_clusters
    S, nnbr = nlist.nbr_super.shape
    C_pad = S * BU
    K = nlist.excl.shape[1]
    ncl = C_pad + 1
    extra = ncl * CLUSTER - n_pad
    nnbr_pad = -(-nnbr // GJU) * GJU
    G = nnbr_pad // GJU
    if g_cap is not None and g_cap < G:
        nnbr_pad = g_cap * GJU
        nnbr = min(nnbr, nnbr_pad)
        G = g_cap

    def plane(a, fill=0.0):
        pad = torch.full((extra,), fill, dtype=a.dtype, device=dev)
        return torch.cat([a, pad]).reshape(ncl, CLUSTER)

    diag6 = torch.sqrt(torch.clamp(torch.diagonal(nbfp[:, :, 0]), min=0.0))
    diag12 = torch.sqrt(torch.clamp(torch.diagonal(nbfp[:, :, 1]), min=0.0))
    valid = (nlist.perm < n).to(torch.float32)
    pv = valid * (1.0 - nlist.pert)
    q = plane(nlist.q_a)
    s6 = plane(diag6[nlist.t_a])
    s12 = plane(diag12[nlist.t_a])
    pvp = plane(pv)

    nbr_src = nlist.nbr_super[:, :nnbr]
    nbr_p = torch.nn.functional.pad(
        torch.where(nbr_src >= 0, nbr_src, torch.full_like(nbr_src, C)),
        (0, nnbr_pad - nnbr), value=C)
    count = torch.sum(nbr_p != C, dim=1)
    ng = (-(-count // GJU)).to(torch.int32)
    nbr2 = nbr_p.reshape(S, G, GJU)

    def jgather(a):
        return plane(a)[nbr2].reshape(S, G, LANES)

    jid = (nbr2[..., None] * CLUSTER
           + torch.arange(CLUSTER, device=dev)).reshape(S, G, LANES)
    pvj = jgather(pv)
    shift = None
    if nlist.super_shift is not None:
        shift = torch.nn.functional.pad(
            nlist.super_shift[:, :nnbr], (0, 0, 0, nnbr_pad - nnbr)
        ).reshape(S, G, GJU, 3)
    pvi = pvp[:C_pad].reshape(S, BU * CLUSTER)
    iid = torch.arange(C_pad * CLUSTER, device=dev).reshape(S, BU * CLUSTER)
    excl = torch.cat([nlist.excl, torch.full((extra, K), -1,
                                             dtype=nlist.excl.dtype,
                                             device=dev)])
    ei = excl[:C_pad * CLUSTER].reshape(S, BU * CLUSTER, K)

    # masks built in int64 and wrapped to int32 (bit 31 is the sign bit)
    pair_m = torch.zeros((S, G, LANES), dtype=torch.int64, device=dev)
    excl_m = torch.zeros((S, G, LANES), dtype=torch.int64, device=dev)
    pvj_ok = pvj > 0
    for b in range(BU * CLUSTER):
        pair = (pvj_ok & (pvi[:, b] > 0)[:, None, None]
                & (jid != iid[:, b][:, None, None]))
        pair_m |= pair.to(torch.int64) << b
        exm = torch.zeros_like(pvj_ok)
        for k in range(K):
            exm |= jid == ei[:, b, k][:, None, None]
        excl_m |= (~exm).to(torch.int64) << b

    def i3(a):
        return a[:C_pad].reshape(S, BU, CLUSTER)

    return PrepV2U(iq=i3(q), is6=i3(s6), is12=i3(s12), ng=ng,
                   ng_max=int(ng.max()) if S else 0, nbr2=nbr2,
                   nbr32=nbr2.to(torch.int32).contiguous(),
                   jq=jgather(nlist.q_a), js6=jgather(diag6[nlist.t_a]),
                   js12=jgather(diag12[nlist.t_a]),
                   pair_m=pair_m.to(torch.int32),
                   excl_m=excl_m.to(torch.int32), shift=shift)


def sorted_plane(x, box, nlist: ClusterPairlist, prep: PrepV2U):
    """The per-step sorted coordinate plane (3, (S * BU + 1) * 8) that both
    routes read: the atoms in cluster order, the padding rows at 1e4 + i,
    with baked shifts the rebuild's image counts removed
    (pallas_cluster_forces_v2u:1524-1584), then the dummy cluster (the pad
    id of nbr2 past the last block) at 2e4 + i.  Box-row expansions are
    elementwise, never a matrix product."""
    n = nlist.inv_perm.shape[0]
    n_pad = nlist.n_pad
    ncl = prep.nbr2.shape[0] * BU + 1
    dev = x.device
    valid_atom = nlist.perm < n
    xs = torch.where(
        valid_atom[:, None], x[torch.clamp(nlist.perm, max=n - 1)],
        1e4 + torch.arange(n_pad, dtype=x.dtype, device=dev)[:, None])
    if prep.shift is not None:
        img = nlist.img
        xs = xs - (img[:, 0:1] * box[0] + img[:, 1:2] * box[1]
                   + img[:, 2:3] * box[2])
    n_rows = ncl * CLUSTER
    dummy = (2e4 + torch.arange(n_rows - n_pad, dtype=x.dtype,
                                device=dev)[:, None]
             * torch.ones(3, dtype=x.dtype, device=dev))
    return torch.cat([xs, dummy]).t().contiguous()


def plane_gather(plane, box, prep: PrepV2U):
    """i planes (S, BU, 8) and j planes (S, G, 256) of a sorted plane, the
    shifts folded into j by box rows (pallas_cluster_forces_v2u:1524-1584)."""
    S, G = prep.nbr2.shape[:2]
    ncl = plane.shape[1] // CLUSTER
    planes = [plane[d].reshape(ncl, CLUSTER) for d in range(3)]
    g = torch.cat(planes, dim=1)[prep.nbr2]                  # (S,G,GJU,24)
    if prep.shift is not None:
        sh = prep.shift.to(plane.dtype)
        sL = (sh[..., 0:1] * box[0] + sh[..., 1:2] * box[1]
              + sh[..., 2:3] * box[2])                       # (S,G,GJU,3)
        g = g + torch.repeat_interleave(sL, CLUSTER, dim=-1)
    j = [g[..., d * CLUSTER:(d + 1) * CLUSTER].reshape(S, G, LANES)
         .contiguous() for d in range(3)]
    i = [p[:S * BU].reshape(S, BU, CLUSTER).contiguous() for p in planes]
    return i, j


def gather_coordinates(x, box, nlist: ClusterPairlist, prep: PrepV2U):
    """Per-step i planes (S, BU, 8) and j planes (S, G, 256) of the
    coordinates, the CPU route's input to nb_v2u_plain: plane_gather of
    sorted_plane."""
    return plane_gather(sorted_plane(x, box, nlist, prep), box, prep)


def cull_tiles_plain(plane, i_off: int, box, prep: PrepV2U,
                     consts: "NbConstants"):
    """Plain mirror of the kernel's tile cull, for the tests: (S, G, 8, 32)
    bool, True where the kernel evaluates the tile of i half-cluster h
    (block atoms 4h .. 4h+3) and j cluster k of group g.  The boxes come
    from the coordinates the kernel reads (gather_cat: plane rows plus the
    shift, rounded as the kernel); a tile is skipped only where its
    box-to-box distance^2 exceeds rmax2 * (1 + CULL_MARGIN) in float32 and
    neither box holds a non-finite coordinate.  Without baked shifts the
    kernel resolves the minimum image per pair and culls nothing.  Groups
    at or past ng are reported too (the kernel never visits them)."""
    S, G = prep.nbr2.shape[:2]
    if prep.shift is None:
        return torch.ones((S, G, 2 * BU, GJU), dtype=torch.bool,
                          device=plane.device)
    i_planes, j_planes = gather_cat(plane, i_off, box, prep)
    ic = torch.stack([p.reshape(S, 2 * BU, 4) for p in i_planes], -1)
    jc = torch.stack([p.reshape(S, G, GJU, CLUSTER) for p in j_planes], -1)
    ilo, ihi = ic.amin(2), ic.amax(2)                     # (S, 8, 3)
    jlo, jhi = jc.amin(3), jc.amax(3)                     # (S, G, 32, 3)
    d = torch.clamp(torch.maximum(jlo[:, :, None] - ihi[:, None, :, None],
                                  ilo[:, None, :, None] - jhi[:, :, None]),
                    min=0.0)                              # (S, G, 8, 32, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    f32 = np.float32
    lim = float(f32(max(f32(consts.rc2), f32(consts.rv2)))
                * (f32(1.0) + f32(CULL_MARGIN)))
    i_bad = ~torch.isfinite(ic).all(-1).all(-1)          # (S, 8)
    j_bad = ~torch.isfinite(jc).all(-1).all(-1)          # (S, G, 32)
    return ~(d2 > lim) | i_bad[:, None, :, None] | j_bad[:, :, None, :]


def nb_v2u_plain(i_planes, j_planes, box, prep: PrepV2U,
                 consts: NbConstants, compute_energy: bool,
                 compute_virial: bool = False):
    """Plain PyTorch version of the kernel: (fx, fy, fz (S, 32), e (S, ne))
    with e = per-block (coulomb, lj) sums over the full list (not yet
    halved), ne = 2; with compute_virial, ne = 5 and e[:, 2:5] the
    per-block sums of fscal * (dx^2, dy^2, dz^2) (not yet scaled by
    -1/4).  Same arithmetic as the TPU kernel, one j group at a time;
    without baked shifts (prep.shift None) the rectangular minimum image
    is resolved per pair."""
    if compute_virial and not compute_energy:
        raise ValueError("the virial rides the energy flavour")
    ix, iy, iz = (p.reshape(-1, BU * CLUSTER, 1) for p in i_planes)
    jx, jy, jz = j_planes
    S, G = jx.shape[:2]
    dev = jx.device
    c = consts
    qi = prep.iq.reshape(S, -1, 1) * c.epsfac
    s6i = prep.is6.reshape(S, -1, 1)
    s12i = prep.is12.reshape(S, -1, 1)
    if not compute_energy:
        s6i, s12i = s6i * 6.0, s12i * 12.0
    bit = torch.arange(BU * CLUSTER, dtype=torch.int32,
                       device=dev).reshape(1, -1, 1)
    same_cut = c.rc2 == c.rv2
    min_image = prep.shift is None
    bl = torch.diagonal(box)
    fx = torch.zeros((S, BU * CLUSTER), dtype=torch.float32, device=dev)
    fy, fz = torch.zeros_like(fx), torch.zeros_like(fx)
    e_c = torch.zeros((S,), dtype=torch.float32, device=dev)
    e_lj = torch.zeros_like(e_c)
    vir = [torch.zeros_like(e_c) for _ in range(3)]
    for g in range(G):
        live = (g < prep.ng.to(torch.int64)).to(torch.float32)[:, None, None]
        pairb = ((prep.pair_m[:, g, None, :] >> bit) & 1).to(
            torch.float32) * live
        inclb = ((prep.excl_m[:, g, None, :] >> bit) & 1).to(torch.float32)
        dx = ix - jx[:, g, None, :]
        dy = iy - jy[:, g, None, :]
        dz = iz - jz[:, g, None, :]
        if min_image:
            dx = dx - torch.floor(dx * (1.0 / bl[0]) + 0.5) * bl[0]
            dy = dy - torch.floor(dy * (1.0 / bl[1]) + 0.5) * bl[1]
            dz = dz - torch.floor(dz * (1.0 / bl[2]) + 0.5) * bl[2]
        r2 = torch.clamp(dx * dx + dy * dy + dz * dz, R2_FLOOR, 1e6)
        rinv = torch.rsqrt(r2)
        rinv2 = rinv * rinv
        in_c = torch.where(r2 < c.rc2, pairb, 0.0)
        in_v = (in_c * inclb if same_cut
                else torch.where(r2 < c.rv2, pairb * inclb, 0.0))
        c6 = s6i * prep.js6[:, g, None, :]
        c12 = s12i * prep.js12[:, g, None, :]
        rinv6 = torch.clamp(rinv2 * rinv2 * rinv2, max=1e15)
        rinv12 = rinv6 * rinv6
        if compute_energy:
            f_lj = (12.0 * c12 * rinv12 - 6.0 * c6 * rinv6) * rinv2 * in_v
        else:
            f_lj = (c12 * rinv12 - c6 * rinv6) * rinv2 * in_v
        qq = qi * prep.jq[:, g, None, :]
        if c.coulomb == CoulombType.REACTION_FIELD:
            f_c = qq * (inclb * rinv2 * rinv - 2.0 * c.krf) * in_c
        elif c.coulomb == CoulombType.PME:
            if compute_energy:
                br = c.beta * (r2 * rinv)
                erfc_t = _erfc_poly(br)
                gauss = torch.exp(-br * br)
                f_c = (qq * rinv2 * ((inclb - (1.0 - erfc_t)) * rinv
                                     + c.beta * TWO_OVER_SQRT_PI * gauss)
                       * in_c)
            else:
                f_c = (qq * (inclb * rinv2 * rinv + c.beta ** 3
                             * _pmecorr_f_recip(c.beta ** 2 * r2)) * in_c)
        else:
            f_c = qq * inclb * rinv2 * rinv * in_c
        fscal = f_lj + f_c
        fx += torch.sum(fscal * dx, dim=2)
        fy += torch.sum(fscal * dy, dim=2)
        fz += torch.sum(fscal * dz, dim=2)
        if compute_virial:
            for a, d in enumerate((dx, dy, dz)):
                vir[a] += torch.sum(fscal * d * d, dim=(1, 2))
        if compute_energy:
            e_lj += torch.sum(
                (c12 * rinv12 - c6 * rinv6
                 - (c12 * c.rcinv6 * c.rcinv6 - c6 * c.rcinv6)) * in_v,
                dim=(1, 2))
            if c.coulomb == CoulombType.REACTION_FIELD:
                e_pair = qq * (inclb * rinv + c.krf * r2 - c.crf) * in_c
            elif c.coulomb == CoulombType.PME:
                e_pair = qq * rinv * (erfc_t - (1.0 - inclb)) * in_c
            else:
                e_pair = qq * inclb * (rinv - c.inv_rc) * in_c
            e_c += torch.sum(e_pair, dim=(1, 2))
    e = [e_c, e_lj] + (vir if compute_virial else [])
    return fx, fy, fz, torch.stack(e, dim=1)


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def split_count(S: int, ng_max: int, n_sm: int, ctas_per_sm: int) -> int:
    """CTAs per i-block: 1 when the S blocks fill SPLIT_WAVES waves of
    resident CTAs (n_sm x ctas_per_sm), else as many as fill them, at most
    ng_max (CTA k of a block walks its groups k, k + split, ...)."""
    target = SPLIT_WAVES * n_sm * ctas_per_sm
    if S <= 0 or S >= target:
        return 1
    return max(1, min(ng_max, -(-target // S)))


_ctas_per_sm = {}


def launch_split(plane, prep: PrepV2U, consts: NbConstants,
                 compute_energy: bool, compute_virial: bool = False) -> int:
    """The split that a launch of this flavour on plane's card takes:
    split_count of S, prep.ng_max, the card's SM count and the kernel's
    occupancy (queried once per card and flavour)."""
    dev = plane.device
    flav = (_COUL_CODE[consts.coulomb], int(compute_energy),
            int(compute_virial), int(prep.shift is None))
    key = (dev.index, flav)
    per_sm = _ctas_per_sm.get(key)
    if per_sm is None:
        with torch.cuda.device(dev):
            per_sm = cuda_lib.library("nb_v2u").nb_v2u_ctas_per_sm(*flav)
        if per_sm <= 0:
            raise RuntimeError(f"nb_v2u: occupancy query failed ({per_sm})")
        _ctas_per_sm[key] = per_sm
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return split_count(prep.nbr2.shape[0], prep.ng_max, n_sm, per_sm)


def _launch(plane, i_off: int, box, prep: PrepV2U, consts: NbConstants,
            compute_energy: bool, compute_virial: bool, split=None):
    """Launch csrc/nb_v2u.cu on the current stream over prep's S blocks:
    the i atoms from cluster i_off of `plane` (3, rows), the j lanes by
    prep.nbr32; split None takes launch_split.  Counts nothing (the
    wrappers count their launches)."""
    if compute_virial and not compute_energy:
        raise ValueError("the virial rides the energy flavour")
    S, G = prep.nbr2.shape[:2]
    f32, i32 = torch.float32, torch.int32
    n_rows = plane.shape[1]
    _check(plane, "plane", f32, (3, n_rows))
    if n_rows % CLUSTER or (i_off + S * BU) * CLUSTER > n_rows:
        raise ValueError(f"i-blocks [{i_off}, {i_off + S * BU}) do not lie "
                         f"in a plane of {n_rows} rows")
    for k, t in enumerate((prep.iq, prep.is6, prep.is12)):
        _check(t, f"i plane {k}", f32, (S, BU, CLUSTER))
    for k, t in enumerate((prep.jq, prep.js6, prep.js12)):
        _check(t, f"j plane {k}", f32, (S, G, LANES))
    _check(prep.nbr32, "nbr32", i32, (S, G, GJU))
    if prep.shift is not None:
        _check(prep.shift, "shift", torch.int8, (S, G, GJU, 3))
    _check(prep.pair_m, "pair_m", i32, (S, G, LANES))
    _check(prep.excl_m, "excl_m", i32, (S, G, LANES))
    _check(prep.ng, "ng", i32, (S,))
    _check(box, "box", f32, (3, 3))
    if split is None:
        split = launch_split(plane, prep, consts, compute_energy,
                             compute_virial)
    dev = plane.device
    ne = 5 if compute_virial else 2
    n_i = S * BU * CLUSTER
    # one buffer, zeroed (one memset) only where split CTAs add into it
    out = (torch.zeros if split > 1 else torch.empty)(
        3 * n_i + S * ne, dtype=f32, device=dev)
    fx, fy, fz = (out[k * n_i:(k + 1) * n_i].view(S, BU * CLUSTER)
                  for k in range(3))
    e = out[3 * n_i:].view(S, ne)
    c = consts
    code = cuda_lib.library("nb_v2u").nb_v2u_launch(
        plane[0].data_ptr(), plane[1].data_ptr(), plane[2].data_ptr(),
        prep.iq.data_ptr(), prep.is6.data_ptr(), prep.is12.data_ptr(),
        prep.nbr32.data_ptr(),
        None if prep.shift is None else prep.shift.data_ptr(),
        prep.jq.data_ptr(), prep.js6.data_ptr(), prep.js12.data_ptr(),
        prep.pair_m.data_ptr(), prep.excl_m.data_ptr(), prep.ng.data_ptr(),
        fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), e.data_ptr(),
        box.data_ptr(), i_off, S, G, split, _COUL_CODE[c.coulomb],
        int(compute_energy), int(compute_virial), int(prep.shift is None),
        c.epsfac, c.beta, c.rc2, c.rv2, c.krf, c.crf, c.rcinv6, c.inv_rc,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, "nb_v2u")
    return fx, fy, fz, e


def nb_v2u_cuda(plane, box, prep: PrepV2U, consts: NbConstants,
                compute_energy: bool, compute_virial: bool = False):
    """K1: csrc/nb_v2u.cu on the sorted plane (sorted_plane), on the
    current stream; same outputs as nb_v2u_plain on plane_gather(plane)."""
    out = _launch(plane, 0, box, prep, consts, compute_energy,
                  compute_virial)
    launches["VFV" if compute_virial
             else "VF" if compute_energy else "F"] += 1
    return out


def nb_v2u_forces(plane, box, prep: PrepV2U, consts: NbConstants,
                  compute_energy: bool, compute_virial: bool = False):
    """Kernel dispatch by device: the plain version on CPU tensors (the
    plane gathered into i and j planes), the CUDA kernel on CUDA tensors."""
    if plane.device.type == "cpu":
        i_planes, j_planes = plane_gather(plane, box, prep)
        return nb_v2u_plain(i_planes, j_planes, box, prep, consts,
                            compute_energy, compute_virial)
    return nb_v2u_cuda(plane, box, prep, consts, compute_energy,
                       compute_virial)


def cluster_forces_v2u(x, box, nlist: ClusterPairlist, prep: PrepV2U,
                       consts: NbConstants, compute_energy: bool = True,
                       compute_virial: bool = False):
    """(f_sorted (n_pad, 3), e_coul, e_lj) over the union lists — the
    counterpart of pallas_cluster_forces_v2u; with compute_virial also the
    (3,) diagonal pair virial Xi_aa = -1/4 sum fscal d_a^2 (each pair is
    counted twice), its per-block partials summed in float64.  The only
    per-step coordinate array it builds is the sorted plane; on CUDA the
    kernel gathers the j lanes from it."""
    fx, fy, fz, e = nb_v2u_forces(sorted_plane(x, box, nlist, prep), box,
                                  prep, consts, compute_energy,
                                  compute_virial)
    n_pad = nlist.n_pad
    f_sorted = torch.stack([fx.reshape(-1)[:n_pad], fy.reshape(-1)[:n_pad],
                            fz.reshape(-1)[:n_pad]], dim=-1)
    out = (f_sorted, 0.5 * torch.sum(e[:, 0]), 0.5 * torch.sum(e[:, 1]))
    if compute_virial:
        vir = -0.25 * torch.sum(e[:, 2:5].to(torch.float64), dim=0)
        return out + (vir.to(e.dtype),)
    return out


def gather_cat(cat_planes, i_off: int, box, prep: PrepV2U):
    """The gather that the kernel does, in plain PyTorch: i planes (S, BU,
    8) from the plane's clusters [i_off, i_off + S * BU), j planes (S, G,
    256) from its cluster ids prep.nbr2 plus shift * box diagonal, rounded
    as the kernel rounds it (the JAX make_dd_v2u_override:486-504).  K6's
    plain version on a domain's cat plane; on the sorted plane with
    i_off = 0 it equals gather_coordinates bit for bit (rectangular
    boxes).  cat_planes: (3, n_rows)."""
    S, G = prep.nbr2.shape[:2]
    packed = cat_planes.reshape(3, -1, CLUSTER)
    g = packed[:, prep.nbr2.to(torch.int64)]              # (3, S, G, GJU, 8)
    if prep.shift is not None:
        sL = prep.shift.to(cat_planes.dtype) * torch.diagonal(box)
        g = g + sL.permute(3, 0, 1, 2)[..., None]
    j = [g[d].reshape(S, G, LANES).contiguous() for d in range(3)]
    i = [packed[d, i_off:i_off + S * BU].reshape(S, BU, CLUSTER)
         .contiguous() for d in range(3)]
    return i, j


def nb_v2u_dd_plain(cat_planes, i_off: int, box, prep: PrepV2U,
                    consts: NbConstants, compute_energy: bool):
    """Plain version of K6: gather_cat then nb_v2u_plain; same outputs as
    nb_v2u_plain on the domain's S blocks."""
    i_planes, j_planes = gather_cat(cat_planes, i_off, box, prep)
    return nb_v2u_plain(i_planes, j_planes, box, prep, consts,
                        compute_energy)


def nb_v2u_dd_cuda(cat_planes, i_off: int, box, prep: PrepV2U,
                   consts: NbConstants, compute_energy: bool):
    """K6: csrc/nb_v2u.cu on one domain's cat plane (3, n_cat_rows), its
    i-blocks from cluster i_off, prep.nbr32 holding cat-space ids, on the
    current stream; same outputs as nb_v2u_dd_plain."""
    out = _launch(cat_planes, i_off, box, prep, consts, compute_energy,
                  False)
    launches["DD_VF" if compute_energy else "DD_F"] += 1
    return out


def nb_v2u_dd_forces(cat_planes, i_off: int, box, prep: PrepV2U,
                     consts: NbConstants, compute_energy: bool):
    """K6 dispatch by device: the plain version on CPU tensors, the CUDA
    kernel on CUDA tensors."""
    fn = nb_v2u_dd_plain if cat_planes.device.type == "cpu" \
        else nb_v2u_dd_cuda
    return fn(cat_planes, i_off, box, prep, consts, compute_energy)
