// v2u cluster-pair non-bonded kernel (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel gromacs_fep_gpu_tpu/ops/pallas_nb.py
// _make_kernel_v2u (launched by pallas_cluster_forces_v2u) in its F
// (force only) and VF (forces + energies) flavours, on the same data
// contract: S i-blocks of 32 atoms (4 clusters x 8), each walking ng[s]
// groups of 256 j lanes whose coordinates arrive with the build-time
// periodic shifts baked in; per-lane 32-bit pair and exclusion masks
// (bit c*8+a = i atom a of cluster c).  Without baked shifts (small
// boxes, where build-time shifts are ambiguous) the kernel resolves the
// rectangular minimum image per pair instead.  LJ uses the geometric rule from
// per-atom sqrt(c6)/sqrt(c12) with potential shift; Coulomb is PME real
// space (erfc polynomial in VF, the pmecorrF rational fit in F), reaction
// field or plain cutoff.  Over the full list the i-side sums are the
// forces; the per-block energy partials are halved by the caller.
//
// What bounds it on the H100: by the work the list needs, bytes.  At
// 12,290 atoms the j streams of the live groups are ~29 MB (9 us at
// 3.35 TB/s) against ~3.8 M in-cut-off pairs x 66 flops (4 us at the
// fp32 peak).  But the packed list holds ~28 M pair slots, and every slot
// is tested (mask bit, r^2) before the ~10% inside the cut-off take the
// pair math, so this simple design is bound by instruction issue and
// divergence, several times above either bound (chip_smoke.py prints
// both).
//
// Design: one CTA of 256 threads per i-block.  Each j group (256 lanes x
// 8 streams = 8 KB) is staged in shared memory with one coalesced load per
// thread; thread t then owns i atom t/8 and j lanes t%8, t%8+8, ...  (32
// pairs per group), so it tests one fixed mask bit, keeps its i atom in
// registers and accumulates three force components.  Out-of-mask and
// out-of-cut-off pairs are skipped before the expensive math.  The 8
// partial forces of an i atom sit in 8 consecutive lanes of one warp and
// are reduced with shuffles; no atomics, no scratch memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 256;       // j lanes per group (32 clusters x 8)
constexpr int kIAtoms = 32;       // i atoms per block (4 clusters x 8)
constexpr int kSlices = kLanes / kIAtoms;   // j slices per i atom = 8
constexpr float kR2Floor = 1e-6f;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

enum Coulomb { kCutoff = 0, kReactionField = 1, kPme = 2 };

struct Consts {
  float epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc;
};

__device__ __forceinline__ float erfc_poly(float x) {
  // Abramowitz & Stegun 7.1.26, as _erfc_poly
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly = t * (0.254829592f + t * (-0.284496736f
      + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * expf(-x * x);
}

__device__ __forceinline__ float pmecorr_f(float z2) {
  // rational fit of the Ewald force correction, as _pmecorr_f_recip
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

template <bool kEnergy, int kCoul, bool kMinImage>
__global__ void __launch_bounds__(kLanes)
nb_v2u_kernel(const float* __restrict__ ix, const float* __restrict__ iy,
              const float* __restrict__ iz, const float* __restrict__ iq,
              const float* __restrict__ is6, const float* __restrict__ is12,
              const float* __restrict__ jx, const float* __restrict__ jy,
              const float* __restrict__ jz, const float* __restrict__ jq,
              const float* __restrict__ js6, const float* __restrict__ js12,
              const int* __restrict__ pair_m, const int* __restrict__ excl_m,
              const int* __restrict__ ng, float* __restrict__ fx_out,
              float* __restrict__ fy_out, float* __restrict__ fz_out,
              float* __restrict__ e_out, const float* __restrict__ box,
              int G, Consts c) {
  __shared__ float s_x[kLanes], s_y[kLanes], s_z[kLanes], s_q[kLanes];
  __shared__ float s_6[kLanes], s_12[kLanes];
  __shared__ unsigned s_pm[kLanes], s_em[kLanes];
  __shared__ float s_red[2][kLanes / 32];

  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int ia = t / kSlices;        // i atom = mask bit c*8+a
  const int slice = t % kSlices;
  const int ii = s * kIAtoms + ia;
  const float xi = ix[ii], yi = iy[ii], zi = iz[ii];
  const float qi = iq[ii] * c.epsfac;
  // force-only flavour folds the 6/12 prefactors into the i side once
  const float s6i = kEnergy ? is6[ii] : 6.0f * is6[ii];
  const float s12i = kEnergy ? is12[ii] : 12.0f * is12[ii];
  const bool same_cut = c.rc2 == c.rv2;
  const float rmax2 = fmaxf(c.rc2, c.rv2);
  // in-loop rectangular minimum image, only without baked shifts
  const float bx = kMinImage ? box[0] : 0.f, by = kMinImage ? box[4] : 0.f,
              bz = kMinImage ? box[8] : 0.f;
  const float ibx = kMinImage ? 1.0f / bx : 0.f,
              iby = kMinImage ? 1.0f / by : 0.f,
              ibz = kMinImage ? 1.0f / bz : 0.f;

  float fx = 0.f, fy = 0.f, fz = 0.f, e_c = 0.f, e_lj = 0.f;
  const int ngroups = min(ng[s], G);
  for (int g = 0; g < ngroups; ++g) {
    const size_t base = ((size_t)s * G + g) * kLanes + t;
    __syncthreads();                 // previous group fully consumed
    s_x[t] = jx[base];
    s_y[t] = jy[base];
    s_z[t] = jz[base];
    s_q[t] = jq[base];
    s_6[t] = js6[base];
    s_12[t] = js12[base];
    s_pm[t] = (unsigned)pair_m[base];
    s_em[t] = (unsigned)excl_m[base];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kLanes / kSlices; ++k) {
      const int l = slice + k * kSlices;
      if (((s_pm[l] >> ia) & 1u) == 0u) continue;
      float dx = xi - s_x[l];
      float dy = yi - s_y[l];
      float dz = zi - s_z[l];
      if (kMinImage) {
        dx -= floorf(dx * ibx + 0.5f) * bx;
        dy -= floorf(dy * iby + 0.5f) * by;
        dz -= floorf(dz * ibz + 0.5f) * bz;
      }
      const float r2 = fminf(fmaxf(dx * dx + dy * dy + dz * dz, kR2Floor),
                             1e6f);
      if (r2 >= rmax2) continue;     // both masks are zero: no contribution
      const float inclb = (float)((s_em[l] >> ia) & 1u);
      const float rinv = rsqrtf(r2);
      const float rinv2 = rinv * rinv;
      const float in_c = r2 < c.rc2 ? 1.0f : 0.0f;
      const float in_v = same_cut ? in_c * inclb
                                  : (r2 < c.rv2 ? inclb : 0.0f);
      const float c6 = s6i * s_6[l];
      const float c12 = s12i * s_12[l];
      const float rinv6 = fminf(rinv2 * rinv2 * rinv2, 1e15f);
      const float rinv12 = rinv6 * rinv6;
      const float f_lj = kEnergy
          ? (12.0f * c12 * rinv12 - 6.0f * c6 * rinv6) * rinv2 * in_v
          : (c12 * rinv12 - c6 * rinv6) * rinv2 * in_v;
      const float qq = qi * s_q[l];
      float f_c, e_pair = 0.f;
      if (kCoul == kReactionField) {
        f_c = qq * (inclb * rinv2 * rinv - 2.0f * c.krf) * in_c;
        if (kEnergy) e_pair = qq * (inclb * rinv + c.krf * r2 - c.crf) * in_c;
      } else if (kCoul == kPme) {
        if (kEnergy) {
          const float br = c.beta * (r2 * rinv);
          const float erfc_t = erfc_poly(br);
          const float gauss = expf(-br * br);
          f_c = qq * rinv2 * ((inclb - (1.0f - erfc_t)) * rinv
                              + c.beta * kTwoOverSqrtPi * gauss) * in_c;
          e_pair = qq * rinv * (erfc_t - (1.0f - inclb)) * in_c;
        } else {
          f_c = qq * (inclb * rinv2 * rinv + c.beta * c.beta * c.beta
                      * pmecorr_f(c.beta * c.beta * r2)) * in_c;
        }
      } else {
        f_c = qq * inclb * rinv2 * rinv * in_c;
        if (kEnergy) e_pair = qq * inclb * (rinv - c.inv_rc) * in_c;
      }
      const float fscal = f_lj + f_c;
      fx += fscal * dx;
      fy += fscal * dy;
      fz += fscal * dz;
      if (kEnergy) {
        e_lj += (c12 * rinv12 - c6 * rinv6
                 - (c12 * c.rcinv6 * c.rcinv6 - c6 * c.rcinv6)) * in_v;
        e_c += e_pair;
      }
    }
  }

  // reduce the 8 j slices of each i atom: 8 consecutive lanes of a warp
#pragma unroll
  for (int off = kSlices / 2; off > 0; off /= 2) {
    fx += __shfl_xor_sync(0xffffffffu, fx, off);
    fy += __shfl_xor_sync(0xffffffffu, fy, off);
    fz += __shfl_xor_sync(0xffffffffu, fz, off);
  }
  if (slice == 0) {
    fx_out[ii] = fx;
    fy_out[ii] = fy;
    fz_out[ii] = fz;
  }
  if (kEnergy) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      e_c += __shfl_xor_sync(0xffffffffu, e_c, off);
      e_lj += __shfl_xor_sync(0xffffffffu, e_lj, off);
    }
    if (t % 32 == 0) {
      s_red[0][t / 32] = e_c;
      s_red[1][t / 32] = e_lj;
    }
    __syncthreads();
    if (t == 0) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kLanes / 32; ++w) {
        a += s_red[0][w];
        b += s_red[1][w];
      }
      e_out[2 * s] = a;
      e_out[2 * s + 1] = b;
    }
  } else if (t == 0) {
    e_out[2 * s] = 0.f;
    e_out[2 * s + 1] = 0.f;
  }
}

template <bool kEnergy, bool kMinImage>
void launch_flavour(int coul, dim3 grid, cudaStream_t st,
                    const float* const* p, const int* pm, const int* em,
                    const int* ng, float* fx, float* fy, float* fz, float* e,
                    const float* box, int G, Consts c) {
#define NB_ARGS p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], \
    p[10], p[11], pm, em, ng, fx, fy, fz, e, box, G, c
  if (coul == kPme)
    nb_v2u_kernel<kEnergy, kPme, kMinImage><<<grid, kLanes, 0, st>>>(
        NB_ARGS);
  else if (coul == kReactionField)
    nb_v2u_kernel<kEnergy, kReactionField, kMinImage>
        <<<grid, kLanes, 0, st>>>(NB_ARGS);
  else
    nb_v2u_kernel<kEnergy, kCutoff, kMinImage><<<grid, kLanes, 0, st>>>(
        NB_ARGS);
#undef NB_ARGS
}

}  // namespace

extern "C" int nb_v2u_launch(
    const float* ix, const float* iy, const float* iz, const float* iq,
    const float* is6, const float* is12, const float* jx, const float* jy,
    const float* jz, const float* jq, const float* js6, const float* js12,
    const int* pair_m, const int* excl_m, const int* ng, float* fx,
    float* fy, float* fz, float* e, const float* box, int S, int G,
    int coulomb, int compute_energy, int min_image, float epsfac, float beta,
    float rc2, float rv2, float krf, float crf, float rcinv6, float inv_rc,
    void* stream) {
  const float* planes[12] = {ix, iy, iz, iq, is6, is12,
                             jx, jy, jz, jq, js6, js12};
  Consts c{epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  dim3 grid(S);
#define FLAVOUR_ARGS coulomb, grid, st, planes, pair_m, excl_m, ng, fx, fy, \
    fz, e, box, G, c
  if (compute_energy && min_image)
    launch_flavour<true, true>(FLAVOUR_ARGS);
  else if (compute_energy)
    launch_flavour<true, false>(FLAVOUR_ARGS);
  else if (min_image)
    launch_flavour<false, true>(FLAVOUR_ARGS);
  else
    launch_flavour<false, false>(FLAVOUR_ARGS);
#undef FLAVOUR_ARGS
  return (int)cudaGetLastError();
}
