"""v2u cluster-pair non-bonded kernel (K1) — PyTorch/CUDA counterpart of
gromacs_fep_gpu_tpu/ops/pallas_nb.py for the v2u layout only
(_erfc_poly, _pmecorr_f_recip, PallasPrepV2U, pallas_prepare_v2u,
pallas_cluster_forces_v2u and the kernel body _make_kernel_v2u).

Data contract (unchanged from the TPU kernel): S i-blocks of BU=4
Hilbert-sorted 8-atom clusters (32 i atoms); each block walks its union
j-stream in G groups of GJU=32 j-clusters (256 j lanes) with build-time
periodic shifts baked into the gathered j coordinates; per-lane 32-bit
pair and exclusion masks (bit c*8+a for i atom a of cluster c); `ng` trip
counts.  Perturbed atoms are masked out here and handled by the FEP list.

`nb_v2u_forces` dispatches by the tensors' device: CPU tensors take the
plain PyTorch version `nb_v2u_plain`; CUDA tensors launch the kernel of
csrc/nb_v2u.cu or raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.types import CoulombType, MdParams
from ..core.units import ONE_4PI_EPS0
from . import cuda_lib
from .fep import rf_constants
from .pairlist import CLUSTER, ClusterPairlist

R2_FLOOR = 1e-6
TWO_OVER_SQRT_PI = 1.1283791670955126
BU = 4          # i-clusters per union block (32 atoms)
GJU = 32        # j-clusters per group (256 lanes)
LANES = GJU * CLUSTER
_COUL_CODE = {CoulombType.CUTOFF: 0, CoulombType.REACTION_FIELD: 1,
              CoulombType.PME: 2}

# launches of the CUDA kernel, by flavor (F = force only, VF = energies)
launches = {"F": 0, "VF": 0}


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
    """Scalar parameters of the kernel, derived once from MdParams."""
    coulomb: CoulombType
    epsfac: float
    beta: float
    rc2: float
    rv2: float
    krf: float
    crf: float
    rcinv6: float
    inv_rc: float

    @staticmethod
    def from_params(params: MdParams, beta: Optional[float]):
        krf, crf = (rf_constants(params)
                    if params.coulomb == CoulombType.REACTION_FIELD
                    else (0.0, 0.0))
        return NbConstants(
            coulomb=params.coulomb,
            epsfac=float(ONE_4PI_EPS0 / params.epsilon_r),
            beta=float(beta or 0.0), rc2=params.rcoulomb ** 2,
            rv2=params.rvdw ** 2, krf=krf, crf=crf,
            rcinv6=1.0 / params.rvdw ** 6, inv_rc=1.0 / params.rcoulomb)


@dataclasses.dataclass
class PrepV2U:
    """Per-rebuild data of the union-stream kernel (PallasPrepV2U)."""
    iq: torch.Tensor       # (S, BU, 8) f32
    is6: torch.Tensor
    is12: torch.Tensor
    ng: torch.Tensor       # (S,) i32 j-group trip count
    nbr2: torch.Tensor     # (S, G, GJU) i64 union j-cluster ids (pad C)
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

    return PrepV2U(iq=i3(q), is6=i3(s6), is12=i3(s12), ng=ng, nbr2=nbr2,
                   jq=jgather(nlist.q_a), js6=jgather(diag6[nlist.t_a]),
                   js12=jgather(diag12[nlist.t_a]),
                   pair_m=pair_m.to(torch.int32),
                   excl_m=excl_m.to(torch.int32), shift=shift)


def gather_coordinates(x, box, nlist: ClusterPairlist, prep: PrepV2U):
    """Per-step i planes (S, BU, 8) and j planes (S, G, 256) of the
    coordinates; with baked shifts, the rebuild's image counts are removed
    and the shifts folded into j (pallas_cluster_forces_v2u:1524-1584).
    Box-row expansions are elementwise, never a matrix product."""
    n = nlist.inv_perm.shape[0]
    n_pad = nlist.n_pad
    S, G = prep.nbr2.shape[:2]
    C_pad = S * BU
    ncl = C_pad + 1
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
    xs = torch.cat([xs, dummy])
    planes = [xs[:, d].reshape(ncl, CLUSTER) for d in range(3)]
    g = torch.cat(planes, dim=1)[prep.nbr2]                  # (S,G,GJU,24)
    if prep.shift is not None:
        sh = prep.shift.to(x.dtype)
        sL = (sh[..., 0:1] * box[0] + sh[..., 1:2] * box[1]
              + sh[..., 2:3] * box[2])                       # (S,G,GJU,3)
        g = g + torch.repeat_interleave(sL, CLUSTER, dim=-1)
    j = [g[..., d * CLUSTER:(d + 1) * CLUSTER].reshape(S, G, LANES)
         .contiguous() for d in range(3)]
    i = [p[:C_pad].reshape(S, BU, CLUSTER).contiguous() for p in planes]
    return i, j


def nb_v2u_plain(i_planes, j_planes, box, prep: PrepV2U,
                 consts: NbConstants, compute_energy: bool):
    """Plain PyTorch version of the kernel: (fx, fy, fz (S, 32), e (S, 2))
    with e = per-block (coulomb, lj) sums over the full list (not yet
    halved).  Same arithmetic as the TPU kernel, one j group at a time;
    without baked shifts (prep.shift None) the rectangular minimum image
    is resolved per pair."""
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
    return fx, fy, fz, torch.stack([e_c, e_lj], dim=1)


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nb_v2u_cuda(i_planes, j_planes, box, prep: PrepV2U,
                consts: NbConstants, compute_energy: bool):
    """Launch csrc/nb_v2u.cu on the current stream; same outputs as
    nb_v2u_plain."""
    S, G = j_planes[0].shape[:2]
    f32, i32 = torch.float32, torch.int32
    i_in = list(i_planes) + [prep.iq, prep.is6, prep.is12]
    j_in = list(j_planes) + [prep.jq, prep.js6, prep.js12]
    for k, t in enumerate(i_in):
        _check(t, f"i plane {k}", f32, (S, BU, CLUSTER))
    for k, t in enumerate(j_in):
        _check(t, f"j plane {k}", f32, (S, G, LANES))
    _check(prep.pair_m, "pair_m", i32, (S, G, LANES))
    _check(prep.excl_m, "excl_m", i32, (S, G, LANES))
    _check(prep.ng, "ng", i32, (S,))
    _check(box, "box", f32, (3, 3))
    dev = j_planes[0].device
    fx = torch.empty((S, BU * CLUSTER), dtype=f32, device=dev)
    fy, fz = torch.empty_like(fx), torch.empty_like(fx)
    e = torch.empty((S, 2), dtype=f32, device=dev)
    c = consts
    lib = cuda_lib.library("nb_v2u")
    code = lib.nb_v2u_launch(
        *(t.data_ptr() for t in i_in), *(t.data_ptr() for t in j_in),
        prep.pair_m.data_ptr(), prep.excl_m.data_ptr(), prep.ng.data_ptr(),
        fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), e.data_ptr(),
        box.data_ptr(), S, G, _COUL_CODE[c.coulomb], int(compute_energy),
        int(prep.shift is None),
        c.epsfac, c.beta, c.rc2, c.rv2, c.krf, c.crf, c.rcinv6, c.inv_rc,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, "nb_v2u")
    launches["VF" if compute_energy else "F"] += 1
    return fx, fy, fz, e


def nb_v2u_forces(i_planes, j_planes, box, prep: PrepV2U,
                  consts: NbConstants, compute_energy: bool):
    """Kernel dispatch by device: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors."""
    if j_planes[0].device.type == "cpu":
        return nb_v2u_plain(i_planes, j_planes, box, prep, consts,
                            compute_energy)
    return nb_v2u_cuda(i_planes, j_planes, box, prep, consts,
                       compute_energy)


def cluster_forces_v2u(x, box, nlist: ClusterPairlist, prep: PrepV2U,
                       consts: NbConstants, compute_energy: bool = True):
    """(f_sorted (n_pad, 3), e_coul, e_lj) over the union lists — the
    counterpart of pallas_cluster_forces_v2u."""
    i_planes, j_planes = gather_coordinates(x, box, nlist, prep)
    fx, fy, fz, e = nb_v2u_forces(i_planes, j_planes, box, prep, consts,
                                  compute_energy)
    n_pad = nlist.n_pad
    f_sorted = torch.stack([fx.reshape(-1)[:n_pad], fy.reshape(-1)[:n_pad],
                            fz.reshape(-1)[:n_pad]], dim=-1)
    return f_sorted, 0.5 * torch.sum(e[:, 0]), 0.5 * torch.sum(e[:, 1])
