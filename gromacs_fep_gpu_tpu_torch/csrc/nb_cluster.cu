// Per-i-cluster-list non-bonded kernel for Hopper (sm_90a): one body,
// nb_table_kernel, for every per-i-cluster list of the port, its list
// layout a compile-time trait.  It replaces
// - the table route: the XLA kernel gromacs_fep_gpu_tpu/ops/cluster_nb.py
//   cluster_nb_kernel and its core cluster_nb_kernel_core (not a
//   pallas_call, but on the card it needs a kernel): each i-cluster's own
//   full list of j-clusters, in-loop minimum image rintf(d / L), exclusion
//   ids, LJ from the (T, T, 2) c6/c12 table in shared memory or from
//   per-atom sqrt(c6)/sqrt(c12), every vdW modifier and Coulomb type, F, VF
//   and VF+virial.  Under domain decomposition it runs a domain's i-cluster
//   range [i0, i0 + n_icl) of its halo-extended plane
//   (cluster_nb_kernel_core with block_offset / n_blocks, as
//   parallel/spatial.py make_halo_cluster_force calls it): coordinates and
//   j data are read by plane id, the list rows, the exclusions of the i
//   atoms and the outputs are indexed from i0;
// - K7b (kCl), gromacs_fep_gpu_tpu/ops/pallas_nb.py _make_kernel_cl
//   (pallas_cluster_forces_cl): the table route's structure with the TPU
//   kernel's two formula details, the image floor(d / L + 0.5) and, in VF,
//   the erfc polynomial (erfc_poly);
// - K7a (kSuper), pallas_nb.py _make_kernel (pallas_cluster_forces): as
//   K7b, but every i-cluster of an 8-cluster supercluster reads the
//   supercluster's union row (row = cl >> 3); the cull drops the union
//   entries out of range of the CTA's own i-cluster;
// - K7c (kV2), pallas_nb.py _make_kernel_v2 (pallas_cluster_forces_v2):
//   each i-cluster's own row with build-time periodic shifts per entry (j
//   at x_j + shift L, no minimum image) and per-lane bit masks (bit a: the
//   pair is valid for i atom a; bit 8 + a: it is not excluded) in place of
//   the pv, self-pair and exclusion-id tests.
// K7a/b/c are geometric-LJ, potential-shift kernels in F and VF, as the TPU
// kernels are, and in VF+virial, which the TPU kernels lack (the JAX
// package takes an autograd pressure on those layouts): the virial adds
// fscal d_a^2 of exactly the pairs whose force it adds, fscal being zero
// outside the in_v/in_c masks, so K7a's union entries out of an i-cluster's
// cut-off add nothing and K7c's d is the baked-shift vector.  The full list
// holds each pair twice, so only i forces are written (no atomics); the
// energy partials (one row per i-cluster) are halved and the virial
// partials scaled by -1/4 on the host, summed there in float64, each pair
// counted as the table route counts it.
//
// What bounds it.  The operations: at 12,290 atoms the lists hold 0.27 M
// (K7b/c, rc 0.9) to 0.46 M (the CHARMM path, rlist ~1.3 nm) live entries
// and 1.9 M to 4.5 M unique pairs inside the cut-off, each needed once with
// the j atom's update, against a few MB of compulsory bytes (chip_smoke.py
// prints the counts and the bound).  A full list evaluates every pair
// twice, so twice that bound is this design's floor.  Above it the kernel
// is bound by instruction issue: a warp runs the pair math of a whole (4 i
// x 8 j) tile when any of its 32 slots needs it, and each entry pays for
// the ring, the cull and the loop.  chip_probe_table.py takes the time
// apart (no cull, contiguous chunks, a deeper ring, 32 warps, the exact
// erfc in F; with --k7 the K7 layouts without the cull, at 1-16 warps and
// with erfcf in VF).
//
// Warps per i-cluster.  A CTA is one i-cluster and `warps` warps that share
// its row: the live entries go in pairs (2p, 2p + 1) to the warps in turn,
// warp w taking pairs w, w + warps, ..., so the dense entries near the
// i-cluster are spread over all warps (contiguous chunks were slower on
// both launches).  The wrapper (ops/nb_cluster.py table_warps) takes, once
// per rebuild, the smallest power of two that puts two waves of resident
// warps on the card, at most 16 and at most cnt_max / 8 (cnt_max: the
// longest row, the union rows' for K7a): 8 for the 1,544 i-clusters of the
// 12,290-atom system, 16 for a 200-cluster DD domain on 132 SMs.  At the
// end each warp reduces its 8 j lanes per i atom with shuffles and writes
// its partial forces, energies and virial into shared memory; after one
// barrier, 24 + ne threads add the warps' partials in warp order and write
// the outputs.  The sums are thus in a fixed order: the same bits from run
// to run, no atomics and no memset.
//
// The ring.  A warp takes its entries two at a time: lanes 0-15 work for
// the first and lanes 16-31 for the second.  It reads the ids of its next
// 32 entries in one load (the following 32 when it starts on a batch) and
// gets each id by shuffle.  It stages the j clusters of its next three
// pairs of entries into an eight-slot ring in shared memory with 16-byte
// cp.async copies: a cluster is 8 consecutive words in each of the x, y,
// z, q, pv and type (or s6 and s12) planes, so lanes 2p and 2p + 1 of a
// half-warp copy plane p's two halves, one copy each per step (TMA does not
// apply to a gather by cluster id).  K7c's slot holds the entry's 8 lane
// masks (32 bytes, read by entry) in the pv plane's place and, copied by
// lane 14 of the half-warp, its shift (padded to 16 bytes by the pack)
// after s12.  cp.async.wait_group 3 and a __syncwarp come before a pair is
// read, a __syncwarp before its slots are refilled.  The i atoms'
// coordinates, charges and LJ parameters stay in registers for the whole
// row.  The i-cluster's 8 K exclusion ids sit in shared memory, and the
// range of the clusters that hold them in two registers: only an entry
// whose cluster lies in that range (a few per row: the partners are the
// atom's own molecule) compares a pair's j id with the ids, so any K costs
// the same and the other entries pay one compare.
// __launch_bounds__(512, 2) holds the kernel to 64 registers, 32 resident
// warps per SM (72, 80 and 96 registers were slower).  After one vote that
// skips a tile with no pair inside rmax, the pair math is straight-line
// code with the cut-offs as selects.
//
// The cull.  Lane l owns j atom l % 8 and i atoms l / 8 and l / 8 + 4, so
// one entry is two (4 i x 8 j) tiles, i half 0 and i half 1.  Each CTA
// computes the boxes of its two i halves once, over the atoms with pv != 0,
// as a centre c and half-widths w.  Per pair of entries, lanes 0-7 test j
// atom l of the first against half 0's box, lanes 8-15 against half 1's,
// lanes 16-31 likewise for the second entry, and one ballot gives the four
// tiles: per axis g = |c - x_j| - w, with c - x_j folded by rintf (K7c: x_j
// shifted, not folded), clamped at 0; d2 = g . g.  Every pair of i atom a
// in the half and j atom j has, under the pair's image (a minimum image, or
// K7c's shift), |d_a| >= g on each axis (|x_a - c| <= w), so r^2 >= d2
// however wide the clusters are; a tile is skipped only when every lane of
// its half votes d2 > max(rc2, rv2) (1 + 1e-5) or holds a j atom that takes
// no pair math with the half (pv = 0; K7c: none of the half's 4 mask bits
// set).  The 1e-5 margin covers the few ulp by which d2 and the pair's r^2
// differ in float32 (ops/nb_cluster.py cull_table_tiles_plain mirrors the
// rule on the CPU, for every layout).  This atom-to-box test is tighter
// than a box-to-box test and needs no shuffle for the j side.
//
// Fail hard.  A half with a non-finite coordinate (any atom, pv or not) and
// a j atom with one are never skipped, and the test is written `skip if
// d2 > lim`, which a NaN never passes.  The plain versions evaluate every
// (i atom, j slot) of a row, so one non-finite coordinate makes NaN the
// force of its own i atom, the forces of all 8 i atoms of every row that
// lists its cluster (for K7a: of every i-cluster whose union row lists it),
// and those rows' energies (energy flavours); the kernel writes NaN in
// exactly those rows from flags (the i atom's own, a non-finite j atom seen
// in the row, OR-ed over the CTA at the barrier), whatever its pair math
// added to them.
//
// Erfc.  The table route's energy flavours take the exact erfcf and expf,
// as the XLA kernel does; K7a/b/c's the Abramowitz & Stegun polynomial, as
// the TPU kernels do.  The F flavour takes the rational pmecorrF fit of the
// Ewald force correction (as K1's F flavour): it holds the plain version's
// exact erfc to the gates on every edge case of chip_smoke.py's table phase
// and saves the erfc and the exp of each pair (chip_probe_table.py times
// both).
//
// Instantiations, each with the physics fixed at compile time: the table
// route's 3 flavours x 2 LJ modes x 3 Coulomb types x 4 vdW modifiers = 72,
// and K7a/b/c's 3 layouts x 3 flavours x 3 Coulomb types = 27.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kCluster = 8;
constexpr int kMaxTypes = 64;        // table mode: (T, T, 2) in shared
constexpr float kR2Floor = 1e-6f;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
constexpr unsigned kFull = 0xffffffffu;

// ops/nb_cluster.py _LAYOUT_CODE
enum Layout { kTable = 0, kSuper = 1, kCl = 2, kV2 = 3 };
enum Flavour { kF = 0, kVF = 1, kVFV = 2 };
enum Coulomb { kCutoff = 0, kReactionField = 1, kPme = 2 };
enum Modifier { kNone = 0, kPotShift = 1, kForceSwitch = 2, kPotSwitch = 3 };

struct Consts {
  float epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc;
  float rsw, rvdw, c2d, c3d, cp6, c2r, c3r, cp12;
};

// erfc(x) for x >= 0 by Abramowitz & Stegun 7.1.26, as nb_v2u.py
// _erfc_poly; gauss = expf(-x * x), which the caller needs too
__device__ __forceinline__ float erfc_poly(float x, float gauss) {
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly = t * (0.254829592f + t * (-0.284496736f
      + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * gauss;
}

// rational fit of the Ewald force correction, as nb_v2u.py
// _pmecorr_f_recip, the quotient by the fast division (2 ulp; z2 <=
// (beta rc)^2 keeps the denominator small), as csrc/nb_v2u.cu
__device__ __forceinline__ float pmecorr_f(float z2) {
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

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return fabsf(x) <= FLT_MAX && fabsf(y) <= FLT_MAX && fabsf(z) <= FLT_MAX;
}

constexpr int kMaxWarps = 16;            // warps per i-cluster (one CTA)
constexpr int kTableThreads = 32 * kMaxWarps;
constexpr int kSlots = 8;                // ring slots (entries) per warp
constexpr int kAhead = kSlots / 2 - 1;   // pairs of entries in flight
constexpr float kCullMargin = 1e-5f;     // ops/nb_cluster.py CULL_MARGIN
// the F flavour's Ewald correction: the pmecorrF fit (true) or the exact
// erfcf and expf (false); chip_probe_table.py times both
constexpr bool kFitF = true;
// K7a/b/c's energy flavours: the erfc polynomial (true, as the TPU kernels)
// or erfcf (false); chip_probe_table.py --k7 times both
constexpr bool kPolyErfc = true;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct TableArgs {
  const float *x, *y, *z, *q, *pv, *s6, *s12;   // plane rows
  // the rows a ring slot holds, by plane (x pads); K7c: [4] the lane
  // masks (R, W, 8) and [7] the shifts (R, W, 4), by entry
  const float* staged[8];
  const int* types;
  const float* nbfp;                            // (T, T, 2)
  const int *excl, *nbr, *cnt;                  // from i0 (K7a: by row)
  float *fx, *fy, *fz, *e;                      // from i0
  const float* box;
  int T, K, W, i0;
  int tab;                                      // float2 offset of the table
  float rmax2, lim;                             // the cut-off and the cull's
  Consts c;
};

// One i atom held by a lane, for the whole row.
struct TAtom {
  float x, y, z, q, s6, s12;
  int trow;                          // type * T (LJ table)
  bool ok;                           // pv != 0
  float fx, fy, fz;
};

struct TAcc {
  float e_c, e_lj, vxx, vyy, vzz;
};

// One tile's pair for lane's i atom a and j atom (xj .. jid, K7c's shift
// added); take: the pair takes the pair math (both pv != 0, not the self
// pair; K7c: its mask bit); incl: K7c's not-excluded bit.  After one
// vote that skips a tile with no pair inside rmax, the body is straight
// line: the LJ and Coulomb terms are computed on every lane and selected
// by the cut-offs, so their chains interleave.  A lane's out-of-range
// values never reach a sum, except a non-finite coordinate's, whose row
// the kernel writes as NaN anyway.
template <int kLayout, int kFlav, bool kTableLj, int kCoul, int kMod>
__device__ __forceinline__ void table_pair(
    TAtom& a, bool take, bool incl, float xj, float yj, float zj, float qj,
    float s6j, float s12j, int tj, int jid, const float* s_nbfp,
    bool ex_entry, const int* s_ex, int K, float bx, float by, float bz,
    float ibx, float iby, float ibz, float rmax2, const Consts& c,
    TAcc& acc) {
  constexpr bool kEnergy = kFlav != kF;
  constexpr bool kVirial = kFlav == kVFV;
  float dx = a.x - xj, dy = a.y - yj, dz = a.z - zj;
  if (kLayout == kTable) {
    dx -= rintf(dx * ibx) * bx;
    dy -= rintf(dy * iby) * by;
    dz -= rintf(dz * ibz) * bz;
  } else if (kLayout != kV2) {       // the TPU kernels' image
    dx -= floorf(dx * ibx + 0.5f) * bx;
    dy -= floorf(dy * iby + 0.5f) * by;
    dz -= floorf(dz * ibz + 0.5f) * bz;
  }
  float r2 = dx * dx + dy * dy + dz * dz;
  const bool in = take && r2 < rmax2;
  if (!__any_sync(kFull, in)) return;
  r2 = fmaxf(r2, kR2Floor);
  // the atom's exclusion ids (s_ex: its K ids in shared memory), only on
  // an entry whose cluster holds some exclusion partner of the i-cluster
  bool excluded = kLayout == kV2 && !incl;
  if (kLayout != kV2 && ex_entry)
    for (int k = 0; k < K; ++k) excluded |= s_ex[k] == jid;
  const float inclb = excluded ? 0.f : 1.f;
  const float rinv = rsqrtf(r2);
  const float rinv2 = rinv * rinv;
  float c6, c12;
  if (kTableLj) {
    const float2 p = reinterpret_cast<const float2*>(s_nbfp)[a.trow + tj];
    c6 = p.x;
    c12 = p.y;
  } else {
    c6 = a.s6 * s6j;
    c12 = a.s12 * s12j;
  }
  const float rinv6 = fminf(rinv2 * rinv2 * rinv2, 1e15f);
  const float rinv12 = rinv6 * rinv6;
  float e_lj = c12 * rinv12 - c6 * rinv6;
  float f_lj = (12.0f * c12 * rinv12 - 6.0f * c6 * rinv6) * rinv2;
  if (kMod == kPotShift) {
    e_lj -= c12 * c.rcinv6 * c.rcinv6 - c6 * c.rcinv6;
  } else if (kMod == kForceSwitch) {
    // cluster_nb.py force-switch branch (forceswitch_constants)
    const float r = r2 * rinv;
    const float rs = fmaxf(r - c.rsw, 0.f);
    const float rs3 = rs * rs * rs;
    if (kEnergy)
      e_lj += c12 * (-4.0f * c.c2r * rs3 - 3.0f * c.c3r * rs3 * rs + c.cp12)
              - c6 * (-2.0f * c.c2d * rs3 - 1.5f * c.c3d * rs3 * rs
                      + c.cp6);
    f_lj += (12.0f * c12 * (c.c2r + c.c3r * rs)
             - 6.0f * c6 * (c.c2d + c.c3d * rs)) * rs * rs * rinv;
  } else if (kMod == kPotSwitch) {
    const float r = r2 * rinv;
    const float d = c.rvdw - c.rsw;
    const float t = fminf(fmaxf((r - c.rsw) / d, 0.f), 1.f);
    const float sw = 1.0f + t * t * t * (-10.0f + t * (15.0f - 6.0f * t));
    const float dsw = (t * t * (-30.0f + t * (60.0f - 30.0f * t))) / d;
    f_lj = f_lj * sw - e_lj * dsw * rinv;
    e_lj *= sw;
  }
  const float qq = a.q * qj;
  float f_c, e_c = 0.f;
  if (kCoul == kReactionField) {
    f_c = qq * (inclb * rinv2 * rinv - 2.0f * c.krf);
    if (kEnergy) e_c = qq * (inclb * rinv + c.krf * r2 - c.crf);
  } else if (kCoul == kPme) {
    if (kEnergy || !kFitF) {
      const float br = c.beta * (r2 * rinv);
      const float gauss = expf(-br * br);
      const float erfc_t = kLayout != kTable && kPolyErfc
          ? erfc_poly(br, gauss) : erfcf(br);
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
  const bool in_v = in && r2 < c.rv2 && !excluded;
  const bool in_c = in && r2 < c.rc2;
  const float fscal = (in_v ? f_lj : 0.f) + (in_c ? f_c : 0.f);
  if (kEnergy) {
    acc.e_lj += in_v ? e_lj : 0.f;
    acc.e_c += in_c ? e_c : 0.f;
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

template <int kLayout, int kFlav, bool kTableLj, int kCoul, int kMod>
__global__ void __launch_bounds__(kTableThreads, 2)
nb_table_kernel(const TableArgs a) {
  constexpr bool kShifts = kLayout == kV2;      // baked shifts, lane masks
  constexpr int kNe = kFlav == kVFV ? 5 : 2;    // floats per i-cluster
  constexpr int kPlanes = kTableLj ? 6 : 7;     // x y z q pv, type | s6 s12
  // floats per ring slot; K7c: x y z q masks s6 s12 and the shift (+ pad)
  constexpr int kSlot = (kShifts ? 8 : kPlanes) * kCluster;
  constexpr int kRed = 3 * kCluster + kNe;      // partials per warp
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // [each warp's ring | the i halves' boxes | LJ table | each warp's
  // partials | the i-cluster's exclusion ids]: the ring and the boxes
  // 16-byte aligned, the table at float2 offset a.tab (the host's
  // nwarps * kSlots * kSlot / 2 + 8)
  float* ring = smem + warp * (kSlots * kSlot);
  float4* s_box = reinterpret_cast<float4*>(smem + nwarps * (kSlots * kSlot));
  const float* s_nbfp = smem;        // indexed from a.tab (TAtom.trow)
  const int n_tab = kTableLj ? a.T * a.T * 2 : 0;
  float* s_red = smem + 2 * a.tab + n_tab;
  int* s_ex = reinterpret_cast<int*>(s_red + nwarps * kRed);
  const int cl = blockIdx.x;          // i-cluster of the range
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x)
    smem[2 * a.tab + k] = a.nbfp[k];
  for (int k = threadIdx.x; k < kCluster * a.K; k += blockDim.x)
    s_ex[k] = a.excl[(size_t)cl * kCluster * a.K + k];
  __syncthreads();
  const Consts c = a.c;
  const int ci = a.i0 + cl;           // i-cluster of the planes
  const int ja = lane & 7;
  const int ia0 = lane >> 3;          // i atoms ia0 and ia0 + 4
  const float bx = a.box[0], by = a.box[4], bz = a.box[8];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float kInf = __int_as_float(0x7f800000);

  // the clusters [ex_lo, ex_hi] that hold the i-cluster's exclusion
  // partners: only entries in that range test exclusion ids
  int ex_lo = 0x7fffffff, ex_hi = -1;
  for (int k = lane; k < kCluster * a.K; k += 32) {
    const int e = s_ex[k];
    if (e >= 0) {
      ex_lo = min(ex_lo, e / kCluster);
      ex_hi = max(ex_hi, e / kCluster);
    }
  }
  ex_lo = __reduce_min_sync(kFull, ex_lo);
  ex_hi = __reduce_max_sync(kFull, ex_hi);

  const int ibase = ci * kCluster + ia0;   // plane id of i atom ia0
  TAtom at[2];
  float cen[2][3], hw[2][3];
  bool hok[2], hbad[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    TAtom& t = at[h];
    const int id = ibase + 4 * h;
    t.x = a.x[id];
    t.y = a.y[id];
    t.z = a.z[id];
    t.q = a.q[id] * c.epsfac;
    t.ok = a.pv[id] != 0.f;
    t.s6 = kTableLj ? 0.f : a.s6[id];
    t.s12 = kTableLj ? 0.f : a.s12[id];
    t.trow = kTableLj ? a.tab + a.types[id] * a.T : 0;
    t.fx = t.fy = t.fz = 0.f;
    // half h's box over its atoms with pv != 0 (lane groups 8m hold atom
    // m + 4h), as a centre and half-widths
    const float v[3] = {t.x, t.y, t.z};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float lo = t.ok ? v[d] : kInf, hi = t.ok ? v[d] : -kInf;
#pragma unroll
      for (int off = 8; off < 32; off *= 2) {
        lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
      }
      cen[h][d] = 0.5f * (lo + hi);
      hw[h][d] = 0.5f * (hi - lo);
    }
    hok[h] = __any_sync(kFull, t.ok);
    hbad[h] = __any_sync(kFull, !finite3(t.x, t.y, t.z));
  }
  // the halves' boxes in shared memory, read per entry (registers are the
  // scarce resource); the half this lane tests: lanes 0-7 (and 16-23) half
  // 0, 8-15 (24-31) half 1
  if (threadIdx.x < 2) {
    const int h = threadIdx.x;
    s_box[2 * h] = make_float4(cen[h][0], cen[h][1], cen[h][2], 0.f);
    s_box[2 * h + 1] = make_float4(hw[h][0], hw[h][1], hw[h][2], 0.f);
  }
  const int hb = ia0 & 1;
  const bool h_ok = hb ? hok[1] : hok[0];
  const bool h_bad = hb ? hbad[1] : hbad[0];
  __syncthreads();

  // The list row (K7a: the union row of the i-cluster's supercluster).
  // Its live entries go in pairs, dealt to the warps in turn: local entry
  // t of this warp (pair t / 2, member t % 2) is row entry ent(t); the
  // dense entries near the i-cluster are thus spread over all warps.
  const int rid = kLayout == kSuper ? cl >> 3 : cl;
  const size_t row0 = (size_t)rid * a.W;
  const int n = min(a.cnt[rid], a.W);
  const int n_pairs = (n + 1) >> 1;
  const int t_end = warp < n_pairs
      ? 2 * ((n_pairs - warp + nwarps - 1) / nwarps) : 0;
  auto ent = [&](int t) { return 2 * (warp + (t >> 1) * nwarps) + (t & 1); };
  const int* row = a.nbr + row0;

  // a pair of entries per step: lanes 0-15 stage and test the first,
  // lanes 16-31 the second; lanes 2p, 2p + 1 of a half-warp copy the two
  // halves of plane p of its entry's cluster (K7c: lane 14 its shift)
  const int sub = lane >> 4;
  const int sp = (lane & 15) >> 1;
  const bool stager = kShifts ? sp < 7 || (lane & 1) == 0 : sp < kPlanes;
  const int dst = sp * kCluster + (lane & 1) * 4;
  // K7c's planes read by entry: the lane masks (8 words), the shift (4)
  const bool by_entry = kShifts && (sp == 4 || sp == 7);
  const int ent_words = sp == 4 ? kCluster : 4;

  // ids of local entries [base, base + 32) and [base + 32, base + 64),
  // lane l holding local entry base + l
  int base = 0;
  int ids_cur = ent(lane) < n ? row[ent(lane)] : 0;
  int ids_nxt = ent(32 + lane) < n ? row[ent(32 + lane)] : 0;
  auto stage = [&](int k) {          // the pair k, k + 1; warp-uniform k
    const int r = k + sub - base;
    const int lo = __shfl_sync(kFull, ids_cur, r & 31);
    const int hi = __shfl_sync(kFull, ids_nxt, r & 31);
    const int te = ent(k + sub);
    if (stager && te < n)
      cp_async16(ring + ((k + sub) & (kSlots - 1)) * kSlot + dst,
                 a.staged[sp] + (lane & 1) * 4
                 + (by_entry ? (row0 + te) * ent_words
                             : (size_t)(r < 32 ? lo : hi) * kCluster));
  };
#pragma unroll
  for (int p = 0; p < kAhead; ++p) {
    if (2 * p < t_end) stage(2 * p);
    cp_async_commit();
  }

  TAcc acc{0.f, 0.f, 0.f, 0.f, 0.f};
  bool j_bad = false;                // a non-finite j atom in this row
  for (int e = 0; e < t_end; e += 2) {
    if (e - base == 32) {
      base = e;
      ids_cur = ids_nxt;
      ids_nxt = ent(e + 32 + lane) < n ? row[ent(e + 32 + lane)] : 0;
    }
    __syncwarp();                    // the slots refilled now were read
    if (e + 2 * kAhead < t_end) stage(e + 2 * kAhead);
    cp_async_commit();
    cp_async_wait<kAhead>();         // local entries e and e + 1
    __syncwarp();

    // the cull: j atom ja of local entry e + sub against half hb's box
    // under the minimum image (K7c: at its shift)
    const int ce = e + sub;
    const float* sc = ring + (ce & (kSlots - 1)) * kSlot;
    float xc = sc[ja], yc = sc[8 + ja], zc = sc[16 + ja];
    if (kShifts) {
      xc += sc[56] * bx;
      yc += sc[57] * by;
      zc += sc[58] * bz;
    }
    const float4 cen4 = s_box[2 * hb], hw4 = s_box[2 * hb + 1];
    float gx = cen4.x - xc, gy = cen4.y - yc, gz = cen4.z - zc;
    if (!kShifts) {
      gx -= rintf(gx * ibx) * bx;
      gy -= rintf(gy * iby) * by;
      gz -= rintf(gz * ibz) * bz;
    }
    gx = fmaxf(fabsf(gx) - hw4.x, 0.f);
    gy = fmaxf(fabsf(gy) - hw4.y, 0.f);
    gz = fmaxf(fabsf(gz) - hw4.z, 0.f);
    const float d2 = gx * gx + gy * gy + gz * gz;
    const bool live = ent(ce) < n;
    const bool c_fin = finite3(xc, yc, zc);
    j_bad |= live && !c_fin;
    // j atom ja takes pair math with some atom of the half
    const bool j_in = kShifts
        ? ((__float_as_int(sc[32 + ja]) >> (4 * hb)) & 0xf) != 0
        : h_ok && sc[32 + ja] != 0.f;
    const unsigned keep = __ballot_sync(
        kFull, live && (h_bad || !c_fin || (j_in && !(d2 > a.lim))));

#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const unsigned ku = keep >> (16 * u);     // entry e + u's tiles
      if ((ku & 0xffffu) == 0u) continue;
      const int eu = e + u;
      const float* s = ring + (eu & (kSlots - 1)) * kSlot;
      float xj = s[ja], yj = s[8 + ja], zj = s[16 + ja];
      if (kShifts) {
        xj += s[56] * bx;
        yj += s[57] * by;
        zj += s[58] * bz;
      }
      const float qj = s[24 + ja], pvj = s[32 + ja];
      const int mj = __float_as_int(pvj);       // K7c: the lane masks
      const int tj = kTableLj ? __float_as_int(s[40 + ja]) : 0;
      const float s6j = kTableLj ? 0.f : s[40 + ja];
      const float s12j = kTableLj ? 0.f : s[48 + ja];
      const int jc = __shfl_sync(kFull, ids_cur, eu - base);
      const int jid = jc * kCluster + ja;
      const bool jok = pvj != 0.f;
      const bool ex_entry = jc >= ex_lo && jc <= ex_hi;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if ((ku & (h ? 0xff00u : 0x00ffu)) == 0u) continue;
        const int ia = ia0 + 4 * h;
        table_pair<kLayout, kFlav, kTableLj, kCoul, kMod>(
            at[h], kShifts ? ((mj >> ia) & 1) != 0
                           : at[h].ok && jok && ibase + 4 * h != jid,
            ((mj >> (8 + ia)) & 1) != 0, xj, yj, zj, qj,
            s6j, s12j, tj, jid, s_nbfp, ex_entry,
            s_ex + ia * a.K, a.K, bx, by, bz, ibx, iby, ibz,
            a.rmax2, c, acc);
      }
    }
  }

  // each warp's partials into shared memory, then summed in warp order
  float* red = s_red + warp * kRed;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = kCluster / 2; off > 0; off /= 2) {
      at[h].fx += __shfl_xor_sync(kFull, at[h].fx, off);
      at[h].fy += __shfl_xor_sync(kFull, at[h].fy, off);
      at[h].fz += __shfl_xor_sync(kFull, at[h].fz, off);
    }
    if (ja == 0) {
      const int atom = ia0 + 4 * h;
      red[3 * atom] = at[h].fx;
      red[3 * atom + 1] = at[h].fy;
      red[3 * atom + 2] = at[h].fz;
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
      part[k] += __shfl_xor_sync(kFull, part[k], off);
    if (lane == 0) red[3 * kCluster + k] = part[k];
  }
  const bool row_bad = __syncthreads_or(j_bad);
  const int t = threadIdx.x;
  if (t < kRed) {
    float sum = 0.f;
    for (int w = 0; w < nwarps; ++w) sum += s_red[w * kRed + t];
    const float nan = __int_as_float(0x7fffffff);
    if (t < 3 * kCluster) {
      // NaN where the plain version has it: the atom's own non-finite
      // coordinate, or a non-finite j atom in its row
      const int atom = t / 3, axis = t % 3;
      const int id = ci * kCluster + atom;
      if (row_bad || !finite3(a.x[id], a.y[id], a.z[id])) sum = nan;
      float* out = axis == 0 ? a.fx : axis == 1 ? a.fy : a.fz;
      out[cl * kCluster + atom] = sum;
    } else {
      if (kFlav != kF && (row_bad || hbad[0] || hbad[1])) sum = nan;
      a.e[(size_t)cl * kNe + (t - 3 * kCluster)] = sum;
    }
  }
}

using TableKernel = void (*)(const TableArgs);

// K7a/b/c: potential shift only, no LJ table, F, VF and VF+virial (27
// kernels)
template <int kLayout, int kFlav, bool kTableLj, int kCoul>
TableKernel pick_modifier(int modifier) {
  if constexpr (kLayout != kTable) {
    return modifier == kPotShift
        ? nb_table_kernel<kLayout, kFlav, false, kCoul, kPotShift> : nullptr;
  } else {
    switch (modifier) {
      case kNone:
        return nb_table_kernel<kTable, kFlav, kTableLj, kCoul, kNone>;
      case kPotShift:
        return nb_table_kernel<kTable, kFlav, kTableLj, kCoul, kPotShift>;
      case kForceSwitch:
        return nb_table_kernel<kTable, kFlav, kTableLj, kCoul, kForceSwitch>;
      case kPotSwitch:
        return nb_table_kernel<kTable, kFlav, kTableLj, kCoul, kPotSwitch>;
      default: return nullptr;
    }
  }
}

template <int kLayout, int kFlav, bool kTableLj>
TableKernel pick_coulomb(int coul, int modifier) {
  switch (coul) {
    case kCutoff:
      return pick_modifier<kLayout, kFlav, kTableLj, kCutoff>(modifier);
    case kReactionField:
      return pick_modifier<kLayout, kFlav, kTableLj, kReactionField>(
          modifier);
    case kPme: return pick_modifier<kLayout, kFlav, kTableLj, kPme>(modifier);
    default: return nullptr;
  }
}

template <int kLayout, int kFlav>
TableKernel pick_lj(int lj_table, int coul, int modifier) {
  if constexpr (kLayout != kTable)
    return lj_table ? nullptr
                    : pick_coulomb<kLayout, kFlav, false>(coul, modifier);
  else
    return lj_table ? pick_coulomb<kLayout, kFlav, true>(coul, modifier)
                    : pick_coulomb<kLayout, kFlav, false>(coul, modifier);
}

template <int kLayout>
TableKernel pick_flavour(int flavour, int lj_table, int coul, int modifier) {
  switch (flavour) {
    case kF: return pick_lj<kLayout, kF>(lj_table, coul, modifier);
    case kVF: return pick_lj<kLayout, kVF>(lj_table, coul, modifier);
    case kVFV: return pick_lj<kLayout, kVFV>(lj_table, coul, modifier);
    default: return nullptr;
  }
}

TableKernel pick(int layout, int flavour, int lj_table, int coul,
                 int modifier) {
  switch (layout) {
    case kTable:
      return pick_flavour<kTable>(flavour, lj_table, coul, modifier);
    case kSuper:
      return pick_flavour<kSuper>(flavour, lj_table, coul, modifier);
    case kCl: return pick_flavour<kCl>(flavour, lj_table, coul, modifier);
    case kV2: return pick_flavour<kV2>(flavour, lj_table, coul, modifier);
    default: return nullptr;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

}  // namespace

// Every per-i-cluster list.  layout: 0 the table route, 1 K7a (super), 2
// K7b (cluster), 3 K7c (v2).  x .. s12, types: plane rows (types with
// lj_table, s6 and s12 without; the other pair may be null), each 16-byte
// aligned; nbfp (T, T, 2); excl (n_icl * 8, K; K7c: none, K 0), nbr (R,
// W), cnt (R) with R = n_icl rows (K7a: n_icl / 8 union rows), and the
// outputs fx/fy/fz (n_icl * 8), e (n_icl, 2 or 5) count from i-cluster i0
// of the planes (K7a/b/c: i0 0); K7c's shift (R, W, 4) and jmask (R, W, 8),
// 16-byte aligned, else null; warps: warps per i-cluster (1-16); flavour
// 0 F, 1 VF, 2 VF+virial (every layout).
extern "C" int nb_table_launch(
    const float* x, const float* y, const float* z, const float* q,
    const float* pv, const float* s6, const float* s12, const int* types,
    const float* nbfp, const int* excl, const int* nbr, const int* cnt,
    const float* shift, const int* jmask, float* fx, float* fy, float* fz,
    float* e, const float* box, int T, int K, int W, int i0, int n_icl,
    int warps, int layout, int lj_table, int flavour, int coulomb,
    int modifier, float epsfac, float beta, float rc2,
    float rv2, float krf, float crf, float rcinv6, float inv_rc, float rsw,
    float rvdw, float c2d, float c3d, float cp6, float c2r, float c3r,
    float cp12, void* stream) {
  if (n_icl <= 0) return 0;
  if (i0 < 0 || K < 0 || W < 0 || warps < 1 || warps > kMaxWarps
      || (lj_table && (T <= 0 || T > kMaxTypes || types == nullptr
                       || nbfp == nullptr))
      || (!lj_table && (s6 == nullptr || s12 == nullptr))
      || (layout != kTable && i0 != 0)
      || (layout == kSuper && n_icl % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const TableKernel kern = pick(layout, flavour, lj_table, coulomb, modifier);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const bool shifts = layout == kV2;
  const void* rows[9] = {x, y, z, q, pv, lj_table ? (const void*)types : s6,
                         lj_table ? (const void*)x : s12,
                         shifts ? (const void*)shift : x,
                         shifts ? (const void*)jmask : x};
  for (const void* p : rows)
    if (p == nullptr || !aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int planes = shifts ? 8 : lj_table ? 6 : 7;   // per ring slot
  const int ne = flavour == kVFV ? 5 : 2;
  const int ring = warps * kSlots * planes * kCluster + 16;   // + boxes
  // the cull's limit as ops/nb_cluster.py cull_table_tiles_plain takes it
  const float rmax2 = fmaxf(rc2, rv2);
  const float* types_f = reinterpret_cast<const float*>(types);
  TableArgs a{x, y, z, q, pv, s6, s12,
              {x, y, z, q,
               shifts ? reinterpret_cast<const float*>(jmask) : pv,
               lj_table ? types_f : s6, lj_table ? x : s12,
               shifts ? shift : x},
              types, nbfp, excl, nbr, cnt,
              fx, fy, fz, e, box, T, K, W, i0, ring / 2, rmax2,
              rmax2 * (1.0f + kCullMargin),
              Consts{epsfac, beta, rc2, rv2, krf, crf, rcinv6, inv_rc,
                     rsw, rvdw, c2d, c3d, cp6, c2r, c3r, cp12}};
  const size_t smem = sizeof(float)
      * (ring + (lj_table ? T * T * 2 : 0) + warps * (3 * kCluster + ne))
      + sizeof(int) * kCluster * K;
  // above 48 KB (64 atom types at 16 warps) a CTA opts in to more
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<n_icl, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
