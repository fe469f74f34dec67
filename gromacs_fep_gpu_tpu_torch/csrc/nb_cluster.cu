// Per-i-cluster-list non-bonded kernel for Hopper (sm_90a): the table
// route and the three non-default NB layouts K7a, K7b and K7c.
//
// Replaces, on one templated body:
// - K7a, gromacs_fep_gpu_tpu/ops/pallas_nb.py _make_kernel (launched by
//   pallas_cluster_forces): 8-cluster (64-atom) superclusters that share
//   one union j list; in-loop rectangular minimum image; exclusion ids;
// - K7b, pallas_nb.py _make_kernel_cl (pallas_cluster_forces_cl): each
//   i-cluster's own j list; in-loop minimum image; exclusion ids;
// - K7c, pallas_nb.py _make_kernel_v2 (pallas_cluster_forces_v2): each
//   i-cluster's own j list with build-time periodic shifts per entry and
//   per-lane bit masks (bit a: pair valid for i atom a, bit 8+a: not
//   excluded);
// - the table route, the XLA kernel gromacs_fep_gpu_tpu/ops/cluster_nb.py
//   cluster_nb_kernel (not a pallas_call, but on the card it needs a
//   kernel): each i-cluster's own list, in-loop minimum image, exclusion
//   ids, LJ from the (T, T, 2) c6/c12 table held in shared memory or from
//   per-atom sqrt(c6)/sqrt(c12), every vdW modifier (none,
//   potential-shift, force-switch, potential-switch), exact erfc, and the
//   diagonal virial flavour.
// K7a/b/c are the TPU kernels' geometric-LJ, potential-shift kernels with
// the erfc polynomial (VF) and the pmecorrF fit (F), as in csrc/nb_v2u.cu.
//
// The full list holds each pair twice, so only i forces are written (no
// atomics); the energy partials (one row per i-cluster) are halved and the
// virial partials scaled by -1/4 on the host, summed there in float64.
//
// What bounds it on the H100: the work the function needs.  Each entry of
// a list brings one j-cluster (8 atoms x 6-7 floats, ~200 B, mostly from
// L1 or L2: every j-cluster is read by every i-cluster near it), and ~80
// flops for each of the ~20-45 % of its 64 pair slots that fall inside the
// cut-off.  At 12,290 atoms with the CHARMM cut-offs (rlist ~1.3 nm) the
// per-cluster lists hold ~20 M pair slots and ~9 M ordered pairs in the
// cut-off, each unique pair twice.  The forces need each unique pair once
// plus a 6-flop j update: ~4.5 M x 86 flops, ~0.38 GFLOP, ~6 us at the
// 67 TFLOP/s fp32 peak, against ~3 MB of compulsory bytes (<1 us at 3.35
// TB/s).  So the bound is operations; this simple design runs the full
// list (twice the pair math, no atomics) and is bound by issue and
// divergence: every slot is tested (mask, r^2) before the expensive math.
//
// Design: one warp per i-cluster (8 warps, 8 consecutive i-clusters per
// CTA: for K7a, one supercluster and its union row).  Lane l owns j atom
// l % 8 of the current j-cluster and i atoms l / 8 and l / 8 + 4, so one
// entry is 64 pairs, two per lane; the i atoms stay in registers, the j
// atom is one load per plane per entry (four lanes read the same word).
// Out-of-mask and out-of-cut-off pairs are skipped before the math.  The
// 8 partial forces of an i atom sit in 8 consecutive lanes and are reduced
// with shuffles; energies and virial sums reduce over the warp.  Exclusion
// ids are tested only for j ids inside the i atom's [min, max] partner
// range, so the K compares run for few pairs.
//
// An i-cluster range [i0, i0 + n_icl) of the planes: the table route under
// domain decomposition (gromacs_fep_gpu_tpu/ops/cluster_nb.py
// cluster_nb_kernel_core with block_offset / n_blocks, as
// parallel/spatial.py make_halo_cluster_force calls it) runs a domain's own
// i-clusters on its halo-extended plane.  Coordinates and j data are read
// by plane id; the list rows, the exclusions of the i atoms and the
// outputs are indexed from i0 (i0 = 0 outside domain decomposition).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // i-clusters per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kCluster = 8;
constexpr int kMaxTypes = 64;        // table mode: (T, T, 2) in shared
constexpr float kR2Floor = 1e-6f;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

enum Layout { kSuper = 0, kCl = 1, kV2 = 2, kTable = 3 };
enum Flavour { kF = 0, kVF = 1, kVFV = 2 };
enum Coulomb { kCutoff = 0, kReactionField = 1, kPme = 2 };
enum Modifier { kNone = 0, kPotShift = 1, kForceSwitch = 2, kPotSwitch = 3 };

struct Consts {
  float epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc;
  float rsw, rvdw, c2d, c3d, cp6, c2r, c3r, cp12;
};

__device__ __forceinline__ float erfc_poly(float x) {
  // Abramowitz & Stegun 7.1.26, as nb_v2u.py _erfc_poly
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly = t * (0.254829592f + t * (-0.284496736f
      + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * expf(-x * x);
}

__device__ __forceinline__ float pmecorr_f(float z2) {
  // rational fit of the Ewald force correction, as nb_v2u.py
  // _pmecorr_f_recip
  const float z4 = z2 * z2;
  float fd0 = 0.0011193462567257629232f * z4 + 0.11583842382862377919f;
  const float fd1 = 0.014866955030185295499f * z4 + 0.50736591960530292870f;
  fd0 = fd0 * z4 + 1.0f;
  fd0 = fd1 * z2 + fd0;
  float fn0 = -1.7357322914161492954e-8f * z4 - 0.000053401640219807709149f;
  float fn1 = 1.4703624142580877519e-6f * z4 + 0.0010054721316683106153f;
  fn0 = fn0 * z4 - 0.019278317264888380590f;
  fn1 = fn1 * z4 + 0.069670166153766424023f;
  fn0 = fn0 * z4 - 0.75225204789749321333f;
  fn0 = fn1 * z2 + fn0;
  return fn0 / fd0;
}

// One i atom held by a lane.
struct IAtom {
  float x, y, z, q, s6, s12, pv;
  int id, lid, type, ex_lo, ex_hi;   // plane id, id from the range start
  float fx, fy, fz;
};

struct Acc {
  float e_c, e_lj, vxx, vyy, vzz;
};

template <int kLayout, int kFlav, bool kTableLj>
__device__ __forceinline__ void pair(
    IAtom& a, int ia, float xj, float yj, float zj, float qj, float s6j,
    float s12j, float pvj, int tj, int jid, unsigned lane_mask,
    const int* __restrict__ excl, int K, const float* s_nbfp, int T,
    float bx, float by, float bz, float ibx, float iby, float ibz,
    int coul, int modifier, const Consts& c, Acc& acc) {
  constexpr bool kEnergy = kFlav != kF;
  constexpr bool kVirial = kFlav == kVFV;
  constexpr bool kMasks = kLayout == kV2;
  constexpr bool kExact = kLayout == kTable;
  if (kMasks) {
    if (((lane_mask >> ia) & 1u) == 0u) return;
  } else {
    if (a.pv == 0.f || pvj == 0.f || a.id == jid) return;
  }
  float dx = a.x - xj, dy = a.y - yj, dz = a.z - zj;
  if (kLayout == kTable) {
    dx -= rintf(dx * ibx) * bx;
    dy -= rintf(dy * iby) * by;
    dz -= rintf(dz * ibz) * bz;
  } else if (kLayout != kV2) {
    dx -= floorf(dx * ibx + 0.5f) * bx;
    dy -= floorf(dy * iby + 0.5f) * by;
    dz -= floorf(dz * ibz + 0.5f) * bz;
  }
  const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, kR2Floor);
  if (r2 >= fmaxf(c.rc2, c.rv2)) return;
  float inclb = 1.f;
  if (kMasks) {
    inclb = (float)((lane_mask >> (8 + ia)) & 1u);
  } else if (jid >= a.ex_lo && jid <= a.ex_hi) {
    for (int k = 0; k < K; ++k)
      if (excl[(size_t)a.lid * K + k] == jid) inclb = 0.f;
  }
  const float rinv = rsqrtf(r2);
  const float rinv2 = rinv * rinv;
  float fscal = 0.f;
  if (r2 < c.rv2 && inclb != 0.f) {
    float c6, c12;
    if (kTableLj) {
      c6 = s_nbfp[(a.type * T + tj) * 2];
      c12 = s_nbfp[(a.type * T + tj) * 2 + 1];
    } else {
      c6 = a.s6 * s6j;
      c12 = a.s12 * s12j;
    }
    const float rinv6 = fminf(rinv2 * rinv2 * rinv2, 1e15f);
    const float rinv12 = rinv6 * rinv6;
    float e_lj = c12 * rinv12 - c6 * rinv6;
    float f_lj = (12.0f * c12 * rinv12 - 6.0f * c6 * rinv6) * rinv2;
    if (modifier == kPotShift) {
      e_lj -= c12 * c.rcinv6 * c.rcinv6 - c6 * c.rcinv6;
    } else if (modifier == kForceSwitch) {
      // cluster_nb.py force-switch branch (forceswitch_constants)
      const float r = r2 * rinv;
      const float rs = fmaxf(r - c.rsw, 0.f);
      const float rs3 = rs * rs * rs;
      e_lj += c12 * (-4.0f * c.c2r * rs3 - 3.0f * c.c3r * rs3 * rs + c.cp12)
              - c6 * (-2.0f * c.c2d * rs3 - 1.5f * c.c3d * rs3 * rs + c.cp6);
      f_lj += (12.0f * c12 * (c.c2r + c.c3r * rs)
               - 6.0f * c6 * (c.c2d + c.c3d * rs)) * rs * rs * rinv;
    } else if (modifier == kPotSwitch) {
      const float r = r2 * rinv;
      const float d = c.rvdw - c.rsw;
      const float t = fminf(fmaxf((r - c.rsw) / d, 0.f), 1.f);
      const float sw = 1.0f + t * t * t * (-10.0f + t * (15.0f - 6.0f * t));
      const float dsw = (t * t * (-30.0f + t * (60.0f - 30.0f * t))) / d;
      f_lj = f_lj * sw - e_lj * dsw * rinv;
      e_lj *= sw;
    }
    fscal = f_lj;
    if (kEnergy) acc.e_lj += e_lj;
  }
  if (r2 < c.rc2) {
    const float qq = a.q * qj;
    float f_c, e_c = 0.f;
    if (coul == kReactionField) {
      f_c = qq * (inclb * rinv2 * rinv - 2.0f * c.krf);
      if (kEnergy) e_c = qq * (inclb * rinv + c.krf * r2 - c.crf);
    } else if (coul == kPme) {
      const float br = c.beta * (r2 * rinv);
      if (kEnergy || kExact) {
        const float erfc_t = kExact ? erfcf(br) : erfc_poly(br);
        const float gauss = expf(-br * br);
        f_c = qq * rinv2 * ((inclb - (1.0f - erfc_t)) * rinv
                            + c.beta * kTwoOverSqrtPi * gauss);
        if (kEnergy) e_c = qq * rinv * (erfc_t - (1.0f - inclb));
      } else {
        f_c = qq * (inclb * rinv2 * rinv + c.beta * c.beta * c.beta
                    * pmecorr_f(c.beta * c.beta * r2));
      }
    } else {
      f_c = qq * inclb * rinv2 * rinv;
      if (kEnergy) e_c = qq * inclb * (rinv - c.inv_rc);
    }
    fscal += f_c;
    if (kEnergy) acc.e_c += e_c;
  }
  a.fx += fscal * dx;
  a.fy += fscal * dy;
  a.fz += fscal * dz;
  if (kVirial) {
    acc.vxx += fscal * dx * dx;
    acc.vyy += fscal * dy * dy;
    acc.vzz += fscal * dz * dz;
  }
}

template <int kLayout, int kFlav, bool kTableLj>
__global__ void __launch_bounds__(kThreads)
nb_cluster_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ zs, const float* __restrict__ qs,
                  const float* __restrict__ pvs,
                  const float* __restrict__ s6s,
                  const float* __restrict__ s12s,
                  const int* __restrict__ types,
                  const float* __restrict__ nbfp, int T,
                  const int* __restrict__ excl, int K,
                  const int* __restrict__ nbr, const int* __restrict__ cnt,
                  int W, const float* __restrict__ shift,
                  const int* __restrict__ jmask, float* __restrict__ fx_out,
                  float* __restrict__ fy_out, float* __restrict__ fz_out,
                  float* __restrict__ e_out, const float* __restrict__ box,
                  int i0, int n_icl, int coul, int modifier, Consts c) {
  constexpr int kNe = kFlav == kVFV ? 5 : 2;   // floats per i-cluster
  extern __shared__ float s_nbfp[];
  if (kTableLj) {
    for (int k = threadIdx.x; k < T * T * 2; k += kThreads)
      s_nbfp[k] = nbfp[k];
    __syncthreads();
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cl = blockIdx.x * kWarps + warp;   // i-cluster of the range
  if (cl >= n_icl) return;
  const int ci = i0 + cl;                      // i-cluster of the planes
  // K7a reads its supercluster's union row, the others their own row
  const int row = kLayout == kSuper ? blockIdx.x : cl;
  const int ja = lane % kCluster;
  const int ia0 = lane / kCluster;     // i atoms ia0 and ia0 + 4

  const float bx = box[0], by = box[4], bz = box[8];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;

  IAtom a[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int id = ci * kCluster + ia0 + 4 * h;
    IAtom& t = a[h];
    t.id = id;
    t.lid = cl * kCluster + ia0 + 4 * h;
    t.x = xs[id];
    t.y = ys[id];
    t.z = zs[id];
    t.q = qs[id] * c.epsfac;
    t.pv = kLayout == kV2 ? 1.f : pvs[id];
    t.s6 = kTableLj ? 0.f : s6s[id];
    t.s12 = kTableLj ? 0.f : s12s[id];
    t.type = kTableLj ? types[id] : 0;
    t.ex_lo = 0x7fffffff;
    t.ex_hi = -1;
    if (kLayout != kV2) {
      for (int k = 0; k < K; ++k) {
        const int e = excl[(size_t)t.lid * K + k];
        if (e >= 0) {
          t.ex_lo = min(t.ex_lo, e);
          t.ex_hi = max(t.ex_hi, e);
        }
      }
    }
    t.fx = t.fy = t.fz = 0.f;
  }
  Acc acc{0.f, 0.f, 0.f, 0.f, 0.f};

  const int n_ent = min(cnt[row], W);
  for (int e = 0; e < n_ent; ++e) {
    const size_t ent = (size_t)row * W + e;
    const int jc = nbr[ent];
    const int jid = jc * kCluster + ja;
    float xj = xs[jid], yj = ys[jid], zj = zs[jid];
    unsigned lane_mask = 0u;
    if (kLayout == kV2) {
      xj += shift[ent * 3] * bx;
      yj += shift[ent * 3 + 1] * by;
      zj += shift[ent * 3 + 2] * bz;
      lane_mask = (unsigned)jmask[ent * kCluster + ja];
    }
    const float qj = qs[jid];
    const float pvj = kLayout == kV2 ? 1.f : pvs[jid];
    const float s6j = kTableLj ? 0.f : s6s[jid];
    const float s12j = kTableLj ? 0.f : s12s[jid];
    const int tj = kTableLj ? types[jid] : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pair<kLayout, kFlav, kTableLj>(
          a[h], ia0 + 4 * h, xj, yj, zj, qj, s6j, s12j, pvj, tj, jid,
          lane_mask, excl, K, s_nbfp, T, bx, by, bz, ibx, iby, ibz, coul,
          modifier, c, acc);
  }

  // the 8 partial forces of an i atom: 8 consecutive lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = kCluster / 2; off > 0; off /= 2) {
      a[h].fx += __shfl_xor_sync(0xffffffffu, a[h].fx, off);
      a[h].fy += __shfl_xor_sync(0xffffffffu, a[h].fy, off);
      a[h].fz += __shfl_xor_sync(0xffffffffu, a[h].fz, off);
    }
    if (ja == 0) {
      fx_out[a[h].lid] = a[h].fx;
      fy_out[a[h].lid] = a[h].fy;
      fz_out[a[h].lid] = a[h].fz;
    }
  }
  float part[kNe];
  part[0] = acc.e_c;
  part[1] = acc.e_lj;
  if constexpr (kNe == 5) {
    part[2] = acc.vxx;
    part[3] = acc.vyy;
    part[4] = acc.vzz;
  }
#pragma unroll
  for (int k = 0; k < kNe; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
    if (lane == 0) e_out[(size_t)cl * kNe + k] = part[k];
  }
}

template <int kLayout, int kFlav, bool kTableLj>
int launch(int i0, int n_icl, cudaStream_t st, const float* const* p, const int* ty,
           const float* nbfp, int T, const int* excl, int K, const int* nbr,
           const int* cnt, int W, const float* shift, const int* jmask,
           float* fx, float* fy, float* fz, float* e, const float* box,
           int coul, int modifier, const Consts& c) {
  const int blocks = (n_icl + kWarps - 1) / kWarps;
  const size_t smem = kTableLj ? sizeof(float) * T * T * 2 : 0;
  nb_cluster_kernel<kLayout, kFlav, kTableLj><<<blocks, kThreads, smem, st>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], ty, nbfp, T, excl, K, nbr,
      cnt, W, shift, jmask, fx, fy, fz, e, box, i0, n_icl, coul, modifier,
      c);
  return (int)cudaGetLastError();
}

}  // namespace

// layout: 0 K7a (super), 1 K7b (cluster), 2 K7c (v2), 3 the table route;
// flavour: 0 F, 1 VF, 2 VF+virial (table route only); lj_table: LJ from
// the (T, T, 2) table (table route only); i0: first i-cluster of the
// planes (the range [i0, i0 + n_icl)).  Unused pointers may be null.
extern "C" int nb_cluster_launch(
    const float* x, const float* y, const float* z, const float* q,
    const float* pv, const float* s6, const float* s12, const int* types,
    const float* nbfp, const int* excl, const int* nbr, const int* cnt,
    const float* shift, const int* jmask, float* fx, float* fy, float* fz,
    float* e, const float* box, int T, int K, int W, int i0, int n_icl,
    int layout,
    int lj_table, int flavour, int coulomb, int modifier, float epsfac,
    float beta, float rc2, float rv2, float krf, float crf, float rcinv6,
    float inv_rc, float rsw, float rvdw, float c2d, float c3d, float cp6,
    float c2r, float c3r, float cp12, void* stream) {
  const float* planes[7] = {x, y, z, q, pv, s6, s12};
  Consts c{epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc,
           rsw, rvdw, c2d, c3d, cp6, c2r, c3r, cp12};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_icl <= 0) return 0;
  // K7a's CTA is one supercluster: whole CTAs only
  if ((layout == kSuper && n_icl % kWarps != 0) || i0 < 0
      || (lj_table && (T <= 0 || T > kMaxTypes)))
    return (int)cudaErrorInvalidValue;
  if (layout != kTable && (lj_table || flavour == kVFV))
    return (int)cudaErrorInvalidValue;
#define ARGS i0, n_icl, st, planes, types, nbfp, T, excl, K, nbr, cnt, W, shift, \
    jmask, fx, fy, fz, e, box, coulomb, modifier, c
  switch (layout * 3 + flavour) {
    case kSuper * 3 + kF: return launch<kSuper, kF, false>(ARGS);
    case kSuper * 3 + kVF: return launch<kSuper, kVF, false>(ARGS);
    case kCl * 3 + kF: return launch<kCl, kF, false>(ARGS);
    case kCl * 3 + kVF: return launch<kCl, kVF, false>(ARGS);
    case kV2 * 3 + kF: return launch<kV2, kF, false>(ARGS);
    case kV2 * 3 + kVF: return launch<kV2, kVF, false>(ARGS);
    case kTable * 3 + kF:
      return lj_table ? launch<kTable, kF, true>(ARGS)
                      : launch<kTable, kF, false>(ARGS);
    case kTable * 3 + kVF:
      return lj_table ? launch<kTable, kVF, true>(ARGS)
                      : launch<kTable, kVF, false>(ARGS);
    case kTable * 3 + kVFV:
      return lj_table ? launch<kTable, kVFV, true>(ARGS)
                      : launch<kTable, kVFV, false>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
