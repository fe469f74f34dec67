// v2u cluster-pair non-bonded kernel (K1, and K6 on the same body) for
// Hopper (sm_90a).
//
// Replaces the TPU kernels gromacs_fep_gpu_tpu/ops/pallas_nb.py
// _make_kernel_v2u (launched by pallas_cluster_forces_v2u; F, VF and
// VF+virial) and gromacs_fep_gpu_tpu/parallel/spatial.py
// make_dd_v2u_override (its body per domain; F and VF), on the same lists:
// S i-blocks of 32 atoms (4 clusters x 8), each walking ng[s] groups of 32
// j clusters (256 lanes); per-lane 32-bit pair and exclusion masks (bit
// c*8+a = i atom a of cluster c).  LJ uses the geometric rule from per-atom
// sqrt(c6)/sqrt(c12) with potential shift; Coulomb is PME real space (erfc
// polynomial in VF, the pmecorrF rational fit in F), reaction field or
// plain cutoff.  Over the full list the i-side sums are the forces; the
// per-block energy partials are halved by the caller.  The virial flavour
// also sums fscal * d_a * d_a per axis a with the same d the force uses;
// the caller scales the per-block sums by -0.25 (pairs counted twice).
//
// Both entry points read coordinates from one sorted (3, rows) plane: the
// i atoms of block s are rows (i_off + 4 s) * 8 + 0..31, j lane l of group
// g is row nbr[s, g, l / 8] * 8 + l % 8, plus the group entry's baked shift
// times the box diagonal, rounded as the plain gather: x + (shift * L) with
// __fmul_rn/__fadd_rn.  K1 passes the whole system's plane with i_off 0;
// K6 a domain's halo-extended ("cat") plane with its own block offset.
// The charges, sqrt(c6), sqrt(c12) and both masks stay per-rebuild
// (S, G, 256) streams.
//
// What bounds it.  The work the list needs is bytes: at 12,290 atoms the
// live groups' five streams, cluster ids and shifts, the plane rows they
// address, the i blocks and the outputs are 17.5 MB (5.2 us at 3.35 TB/s)
// against 1.83 M unique in-cut-off pairs x 72 flops (2.0 us at the fp32
// peak).  But the union list holds 26 M pair slots, 14 % of them inside
// the cut-off, so a kernel that tests every slot is bound by instruction
// issue and divergence, several times above both.  This design removes
// whole tiles instead of slots: a warp's iteration is one tile of 4 i atoms
// (half an i cluster) x one 8-atom j cluster, 32 pairs, and 0.40 of the
// live groups' tiles come within the cut-off.  What remains is the issue
// of the kept tiles (about a third of their slots are inside the cut-off,
// and a warp runs the pair math when any lane needs it) and, on a split
// grid, each CTA's exposed load latency (chip_smoke.py prints the kept
// share, both bounds, and the time with and without the split).
//
// The cull.  Each warp keeps the bounding box of its 4 i atoms in registers.
// For each staged group, lane k of every warp builds the box of j cluster k
// from the shifted coordinates (the x, y, z rows are skewed by one word per
// 8 lanes so those reads are free of bank conflicts) and tests the
// box-to-box distance^2 d2 against lim = rmax2 * (1 + 1e-5); one ballot
// gives the warp its tiles, and the warp loops over the kept ones only, so
// a skipped tile costs no instruction and no divergence.  Exact: every pair
// in a skipped tile has r^2 >= d2 (rounding is monotone and the box bounds
// are the coordinates themselves), and the 1e-5 margin covers the few ulp
// by which d2 and the pair's r^2 (summed in another order, possibly with
// FMA) can differ, so no pair with r^2 < rmax2 is ever skipped, and the
// kernel adds nothing for a pair with r^2 >= rmax2.
//
// Fail hard.  fminf/fmaxf drop a NaN, so a box would lose a NaN atom: each
// i half and each j cluster carries a non-finite flag, a flagged tile is
// never skipped, and the test is written `skip if d2 > lim`, which a NaN d2
// never passes.  The plain version evaluates every (i atom, j lane) slot of
// a block, so one NaN coordinate makes NaN the force of the NaN i atom, the
// forces of all 32 i atoms when it sits in a j lane of a live group, and
// the block's energy row; the kernel reproduces exactly that pattern (a
// NaN seen while staging or in the i atoms is OR-ed over the CTA).
// Minimum image: without baked shifts (small boxes, and the DD sort's wide
// clusters, so K6 on the main path) the kernel resolves the rectangular
// minimum image per pair, as before, and culls nothing.
//
// Staging.  A two-stage ring in shared memory: while the warps compute
// group g, cp.async (4-byte copies; the coordinates are a gather by cluster
// id, so TMA does not apply) fills the other stage with the block's next
// group; the one barrier per group is the ring's (wait for the copies,
// then __syncthreads, after which the freed stage is refilled).  Before
// the barrier each thread adds its own lane's baked shift in place, so the
// boxes and the pairs read shifted coordinates; the cluster ids and the
// shifts are read one group further ahead into registers.
//
// The split.  A grid of S CTAs is under one wave when S is small (a K6
// domain launch: 50 blocks on 132 SMs; K1 at 12,290 atoms: 385 blocks,
// 4 resident per SM), and its time is then its slowest CTA's.  The wrapper
// (ops/nb_v2u.py split_count) computes from S, the largest ng and the
// card's SM count and occupancy a split p that fills three waves, and the
// grid becomes (S, p): CTA (s, k) walks groups k, k + p, ...  With p > 1
// the i forces and the per-block energy and virial rows are added with
// atomicAdd into outputs that the wrapper zeroes, so the order of those
// sums changes from run to run (the forces' last bits and the energies'
// with them); with p = 1 the kernel writes as before, no atomics, no
// memset.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 256;       // j lanes per group (32 clusters x 8)
constexpr int kIAtoms = 32;       // i atoms per block (4 clusters x 8)
constexpr int kSlices = kLanes / kIAtoms;   // j slices per i atom = 8
constexpr int kSkew = kLanes + kLanes / 8;  // x/y/z rows, one pad per cluster
constexpr float kR2Floor = 1e-6f;
constexpr float kCullMargin = 1e-5f;        // ops/nb_v2u.py CULL_MARGIN
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
constexpr unsigned kFull = 0xffffffffu;

enum Coulomb { kCutoff = 0, kReactionField = 1, kPme = 2 };

struct Consts {
  float epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc;
};

// one stage of the ring: a j group of 256 lanes
struct Stage {
  float x[kSkew], y[kSkew], z[kSkew];       // lane l at l + l / 8
  float q[kLanes], c6[kLanes], c12[kLanes];
  unsigned pm[kLanes], em[kLanes];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return fabsf(x) <= FLT_MAX && fabsf(y) <= FLT_MAX && fabsf(z) <= FLT_MAX;
}

__device__ __forceinline__ bool nan3(float x, float y, float z) {
  return isnan(x) || isnan(y) || isnan(z);
}

__device__ __forceinline__ float erfc_poly(float x) {
  // Abramowitz & Stegun 7.1.26, as _erfc_poly
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly = t * (0.254829592f + t * (-0.284496736f
      + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * expf(-x * x);
}

__device__ __forceinline__ float pmecorr_f(float z2) {
  // rational fit of the Ewald force correction, as _pmecorr_f_recip; the
  // quotient by the fast division (2 ulp, where _pmecorr_f_recip refines
  // a reciprocal by one Newton step): z2 <= (beta rc)^2 keeps fd0 small
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
  return __fdividef(fn0, fd0);
}

struct Args {
  const float *x, *y, *z;                  // the plane's coordinate rows
  const float *iq, *is6, *is12;            // (S, 32)
  const int* nbr;                          // (S, G, 32) plane cluster ids
  const signed char* shift;                // (S, G, 32, 3) or null
  const float *jq, *js6, *js12;            // (S, G, 256)
  const int *pair_m, *excl_m;              // (S, G, 256)
  const int* ng;                           // (S,)
  float *fx, *fy, *fz, *e;                 // (S, 32) x 3, (S, ne)
  const float* box;                        // (3, 3)
  int i_off, G;
  Consts c;
};

// issue the copies of group g into stage st (thread t: lane t)
__device__ __forceinline__ void stage_group(Stage& st, const Args& a, int s,
                                            int g, int t, int nid) {
  const size_t ent = (size_t)s * a.G + g;
  const size_t row = (size_t)nid * 8 + (t & 7);
  const int d = t + (t >> 3);
  cp_async4(&st.x[d], a.x + row);
  cp_async4(&st.y[d], a.y + row);
  cp_async4(&st.z[d], a.z + row);
  const size_t lane = ent * kLanes + t;
  cp_async4(&st.q[t], a.jq + lane);
  cp_async4(&st.c6[t], a.js6 + lane);
  cp_async4(&st.c12[t], a.js12 + lane);
  cp_async4(&st.pm[t], a.pair_m + lane);
  cp_async4(&st.em[t], a.excl_m + lane);
}

template <bool kEnergy, int kCoul, bool kMinImage, bool kVirial>
__global__ void __launch_bounds__(kLanes)
nb_v2u_kernel(const Args a) {
  static_assert(kEnergy || !kVirial, "the virial rides the energy flavour");
  constexpr int kNe = kVirial ? 5 : 2;   // floats per block in e
  __shared__ Stage ring[2];
  __shared__ float s_red[kNe][kLanes / 32];

  const int s = blockIdx.x;
  const int part = blockIdx.y, nparts = gridDim.y;
  const int ngroups = min(a.ng[s], a.G);
  // a split CTA without groups has nothing to add (part 0 always runs: it
  // writes the block's rows, NaN included)
  if (part > 0 && part >= ngroups) return;
  const bool split = nparts > 1;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int ia = t / kSlices;        // i atom = mask bit c*8+a
  const int slice = t % kSlices;
  const int ii = s * kIAtoms + ia;
  const size_t irow = (size_t)a.i_off * 8 + ii;
  const float xi = a.x[irow], yi = a.y[irow], zi = a.z[irow];
  const Consts c = a.c;
  const float qi = a.iq[ii] * c.epsfac;
  // force-only flavour folds the 6/12 prefactors into the i side once
  const float s6i = kEnergy ? a.is6[ii] : 6.0f * a.is6[ii];
  const float s12i = kEnergy ? a.is12[ii] : 12.0f * a.is12[ii];
  const bool same_cut = c.rc2 == c.rv2;
  const float rmax2 = fmaxf(c.rc2, c.rv2);
  const float lim = rmax2 * (1.0f + kCullMargin);
  const float bx = a.box[0], by = a.box[4], bz = a.box[8];
  // in-loop rectangular minimum image, only without baked shifts
  const float ibx = kMinImage ? 1.0f / bx : 0.f,
              iby = kMinImage ? 1.0f / by : 0.f,
              ibz = kMinImage ? 1.0f / bz : 0.f;

  // the box of this warp's 4 i atoms (lanes 8m .. 8m+7 hold atom m)
  float ilx = xi, ihx = xi, ily = yi, ihy = yi, ilz = zi, ihz = zi;
#pragma unroll
  for (int off = 8; off < 32; off *= 2) {
    ilx = fminf(ilx, __shfl_xor_sync(kFull, ilx, off));
    ihx = fmaxf(ihx, __shfl_xor_sync(kFull, ihx, off));
    ily = fminf(ily, __shfl_xor_sync(kFull, ily, off));
    ihy = fmaxf(ihy, __shfl_xor_sync(kFull, ihy, off));
    ilz = fminf(ilz, __shfl_xor_sync(kFull, ilz, off));
    ihz = fmaxf(ihz, __shfl_xor_sync(kFull, ihz, off));
  }
  const bool i_bad = __any_sync(kFull, !finite3(xi, yi, zi));
  const bool i_nan = nan3(xi, yi, zi);
  bool j_nan = false;               // a NaN in the lanes this thread staged

  float fx = 0.f, fy = 0.f, fz = 0.f, e_c = 0.f, e_lj = 0.f;
  float vxx = 0.f, vyy = 0.f, vzz = 0.f;
  const int* ids = a.nbr + (size_t)s * a.G * (kLanes / 8) + t / 8;
  // the baked shift of this thread's lane, read a group ahead
  const signed char* shifts = kMinImage ? nullptr
      : a.shift + ((size_t)s * a.G * (kLanes / 8) + t / 8) * 3;
  int sh0 = 0, sh1 = 0, sh2 = 0;
  int g = part;
  if (g < ngroups) {
    stage_group(ring[0], a, s, g, t, ids[g * 32]);
    if (!kMinImage) {
      sh0 = shifts[g * 96];
      sh1 = shifts[g * 96 + 1];
      sh2 = shifts[g * 96 + 2];
    }
  }
  cp_async_commit();
  int g_next = g + nparts;
  int nid_next = g_next < ngroups ? ids[g_next * 32] : 0;
  for (int b = 0; g < ngroups; b ^= 1, g = g_next, g_next += nparts) {
    cp_async_wait_all();             // this thread's lane of group g
    {
      // its shift, rounded as the plain gather: x + (shift * L), no fused
      // multiply; every later read of the lane sees the shifted value
      Stage& mine = ring[b];
      const int d = t + (t >> 3);
      if (!kMinImage) {
        mine.x[d] = __fadd_rn(mine.x[d], __fmul_rn((float)sh0, bx));
        mine.y[d] = __fadd_rn(mine.y[d], __fmul_rn((float)sh1, by));
        mine.z[d] = __fadd_rn(mine.z[d], __fmul_rn((float)sh2, bz));
      }
      j_nan |= nan3(mine.x[d], mine.y[d], mine.z[d]);
    }
    __syncthreads();                 // group g staged; stage b ^ 1 free
    if (g_next < ngroups) {
      stage_group(ring[b ^ 1], a, s, g_next, t, nid_next);
      cp_async_commit();
      if (!kMinImage) {
        sh0 = shifts[g_next * 96];
        sh1 = shifts[g_next * 96 + 1];
        sh2 = shifts[g_next * 96 + 2];
      }
      const int g_after = g_next + nparts;
      if (g_after < ngroups) nid_next = ids[g_after * 32];
    }
    const Stage& st = ring[b];
    unsigned keep = kFull;
    if (!kMinImage) {
      // lane k: j cluster k's bounding box
      float lx = FLT_MAX, hx = -FLT_MAX, ly = FLT_MAX, hy = -FLT_MAX,
            lz = FLT_MAX, hz = -FLT_MAX;
      bool bad = false;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float xj = st.x[9 * lane + m];
        const float yj = st.y[9 * lane + m];
        const float zj = st.z[9 * lane + m];
        bad |= !finite3(xj, yj, zj);
        lx = fminf(lx, xj);
        hx = fmaxf(hx, xj);
        ly = fminf(ly, yj);
        hy = fmaxf(hy, yj);
        lz = fminf(lz, zj);
        hz = fmaxf(hz, zj);
      }
      const float dx = fmaxf(fmaxf(lx - ihx, ilx - hx), 0.f);
      const float dy = fmaxf(fmaxf(ly - ihy, ily - hy), 0.f);
      const float dz = fmaxf(fmaxf(lz - ihz, ilz - hz), 0.f);
      const float d2 = dx * dx + dy * dy + dz * dz;
      // skip only a finite tile whose boxes lie beyond the margin; a NaN
      // d2 never skips
      keep = __ballot_sync(kFull, i_bad || bad || !(d2 > lim));
    }
    while (keep) {
      const int k = __ffs(keep) - 1;
      keep &= keep - 1;
      const int l = 8 * k + slice;
      if (((st.pm[l] >> ia) & 1u) == 0u) continue;
      const float xj = st.x[l + k], yj = st.y[l + k], zj = st.z[l + k];
      float dx = xi - xj;
      float dy = yi - yj;
      float dz = zi - zj;
      if (kMinImage) {
        dx -= floorf(dx * ibx + 0.5f) * bx;
        dy -= floorf(dy * iby + 0.5f) * by;
        dz -= floorf(dz * ibz + 0.5f) * bz;
      }
      const float r2 = fminf(fmaxf(dx * dx + dy * dy + dz * dz, kR2Floor),
                             1e6f);
      if (r2 >= rmax2) continue;     // both masks are zero: no contribution
      const float inclb = (float)((st.em[l] >> ia) & 1u);
      const float rinv = rsqrtf(r2);
      const float rinv2 = rinv * rinv;
      const float in_c = r2 < c.rc2 ? 1.0f : 0.0f;
      const float in_v = same_cut ? in_c * inclb
                                  : (r2 < c.rv2 ? inclb : 0.0f);
      const float c6 = s6i * st.c6[l];
      const float c12 = s12i * st.c12[l];
      const float rinv6 = fminf(rinv2 * rinv2 * rinv2, 1e15f);
      const float rinv12 = rinv6 * rinv6;
      const float f_lj = kEnergy
          ? (12.0f * c12 * rinv12 - 6.0f * c6 * rinv6) * rinv2 * in_v
          : (c12 * rinv12 - c6 * rinv6) * rinv2 * in_v;
      const float qq = qi * st.q[l];
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
      if (kVirial) {
        vxx += fscal * dx * dx;
        vyy += fscal * dy * dy;
        vzz += fscal * dz * dz;
      }
    }
  }

  // NaN where the plain version has it: the i atom's own, every i atom's
  // for a NaN j lane, the block's energy row for either
  const bool jn = __syncthreads_or(j_nan);
  const bool any_nan = jn || __syncthreads_or(i_nan);
  const float nan = __int_as_float(0x7fffffff);
  // reduce the 8 j slices of each i atom: 8 consecutive lanes of a warp
#pragma unroll
  for (int off = kSlices / 2; off > 0; off /= 2) {
    fx += __shfl_xor_sync(kFull, fx, off);
    fy += __shfl_xor_sync(kFull, fy, off);
    fz += __shfl_xor_sync(kFull, fz, off);
  }
  if (i_nan || jn) fx = fy = fz = nan;
  if (slice == 0) {
    if (split) {
      atomicAdd(a.fx + ii, fx);
      atomicAdd(a.fy + ii, fy);
      atomicAdd(a.fz + ii, fz);
    } else {
      a.fx[ii] = fx;
      a.fy[ii] = fy;
      a.fz[ii] = fz;
    }
  }
  if (kEnergy) {
    float p[kNe];
    p[0] = e_c;
    p[1] = e_lj;
    if constexpr (kVirial) {
      p[2] = vxx;
      p[3] = vyy;
      p[4] = vzz;
    }
#pragma unroll
    for (int k = 0; k < kNe; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        p[k] += __shfl_xor_sync(kFull, p[k], off);
      if (lane == 0) s_red[k][t / 32] = p[k];
    }
    __syncthreads();
    if (t < kNe) {
      float acc = 0.f;
      for (int w = 0; w < kLanes / 32; ++w) acc += s_red[t][w];
      if (any_nan) acc = nan;
      if (split)
        atomicAdd(a.e + kNe * s + t, acc);
      else
        a.e[kNe * s + t] = acc;
    }
  } else if (t < 2 && !split) {
    a.e[2 * s + t] = 0.f;
  }
}

using Kernel = void (*)(const Args);

template <bool kEnergy, bool kMinImage, bool kVirial>
Kernel pick_coulomb(int coul) {
  if (coul == kPme) return nb_v2u_kernel<kEnergy, kPme, kMinImage, kVirial>;
  if (coul == kReactionField)
    return nb_v2u_kernel<kEnergy, kReactionField, kMinImage, kVirial>;
  return nb_v2u_kernel<kEnergy, kCutoff, kMinImage, kVirial>;
}

Kernel pick(int coul, int energy, int virial, int min_image) {
  if (virial)
    return min_image ? pick_coulomb<true, true, true>(coul)
                     : pick_coulomb<true, false, true>(coul);
  if (energy)
    return min_image ? pick_coulomb<true, true, false>(coul)
                     : pick_coulomb<true, false, false>(coul);
  return min_image ? pick_coulomb<false, true, false>(coul)
                   : pick_coulomb<false, false, false>(coul);
}

}  // namespace

// K1 and K6.  x, y, z: the plane's coordinate rows (K1: the sorted system,
// K6: a domain's cat plane); the i planes start at cluster i_off.  nbr (S,
// G, 32) plane cluster ids; shift (S, G, 32, 3) box-vector counts, or null
// for the in-loop minimum image; iq/is6/is12 (S, 32) and jq/js6/js12,
// pair_m/excl_m (S, G, 256) per-rebuild streams; ng (S,).  split > 1:
// grid (S, split), outputs accumulated with atomicAdd (zeroed by the
// caller); split = 1: written.  e: (S, 2), or (S, 5) with compute_virial.
extern "C" int nb_v2u_launch(
    const float* x, const float* y, const float* z, const float* iq,
    const float* is6, const float* is12, const int* nbr,
    const signed char* shift, const float* jq, const float* js6,
    const float* js12, const int* pair_m, const int* excl_m, const int* ng,
    float* fx, float* fy, float* fz, float* e, const float* box, int i_off,
    int S, int G, int split, int coulomb, int compute_energy,
    int compute_virial, int min_image, float epsfac, float beta, float rc2,
    float rv2, float krf, float crf, float rcinv6, float inv_rc,
    void* stream) {
  if (S <= 0) return 0;
  if ((compute_virial && !compute_energy) || split < 1
      || (!min_image && shift == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x, y, z, iq, is6, is12, nbr, shift, jq, js6, js12, pair_m, excl_m,
         ng, fx, fy, fz, e, box, i_off, G,
         Consts{epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc}};
  const Kernel k = pick(coulomb, compute_energy, compute_virial, min_image);
  k<<<dim3(S, split), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// CTAs of one flavour resident per SM (the split's wave size), or -1.
extern "C" int nb_v2u_ctas_per_sm(int coulomb, int compute_energy,
                                  int compute_virial, int min_image) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, pick(coulomb, compute_energy, compute_virial, min_image),
          kLanes, 0) != cudaSuccess)
    return -1;
  return n;
}
