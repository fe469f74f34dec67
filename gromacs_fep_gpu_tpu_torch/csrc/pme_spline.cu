// Order-4 B-spline PME charge spread (K2, K4) and potential gather (K3, K5)
// for Hopper (sm_90a).
//
// Replace the TPU kernels gromacs_fep_gpu_tpu/ops/pme_blocked.py
// _spread_kernel (via blocked_spread_pallas, then _fold_blocks_axis) and
// _gather_kernel (via blocked_phi_gather_pallas), and the small-system pair
// gromacs_fep_gpu_tpu/ops/pme_pallas.py _spread_kernel (via
// spread_charges_pallas) and _gather_kernel (via phi_gather_pallas).  The
// blocked TPU design buckets atoms onto coarse blocks at each pair-list
// rebuild, contracts one-hot spline rows against per-block grid windows on
// the MXU and overlap-adds the windows; the small-system one contracts
// whole-grid one-hot rows in three bf16 passes, because the MXU makes
// O(N K^3) free.  Without tensor cores in fp32 the 4x4x4 support is the
// right work at every size: both kernels touch only it, on the global
// (K1, K2, K3) grid, so there is no bucketing (no stale bucket can drop
// charge) and no size threshold.  The TPU kernels' "fail hard" rule keeps
// its meaning: an atom whose grid coordinate is not finite is spread as
// the plain version spreads it, a NaN charge on the support of u = 0, and
// gathered as a NaN output row, instead of being skipped.
//
// The spread.  What bounds it on the H100 is neither HBM bytes nor flops:
// at 12,290 atoms on a 42^3 grid it reads 0.2 MB, writes the 0.3 MB grid
// and does 2.7 Mflop, well under a microsecond of either.  It is the L2's
// atomic throughput, 64 float atomicAdds per atom (786,560 at 12,290 atoms)
// into the L2-resident grid, plus the grid's memset in the wrapper.  One
// thread per atom issuing its 64 atomics in series left the kernel to the
// latency chain of its slowest threads; the design keeps the atomics in
// flight and lets the L2 merge them:
//   - order^2 = 16 threads per atom, 8 atoms per CTA of 128 threads (1,537
//     CTAs at 12,290 atoms), each thread issuing 4 atomics;
//   - each atom's support (the cell floor(u) and the four weights on each
//     axis) is computed once, by 3 threads per atom, one per axis, and
//     staged in shared memory for the atom's 16 tap threads;
//   - tap thread t owns the (y, z) taps (j, k) = (t / 4, t % 4) and loops
//     over the 4 x taps, as the reference's pme_spread.cu does: the 4
//     threads of one grid row add to 4 neighbouring cells in one
//     instruction, which the L2 takes as one sector request (two where
//     the cells cross a 32-byte sector or the row wraps at K3);
//   - the tail CTA's missing atoms and atoms of zero charge are staged with
//     q = 0 and masked after the barrier, never returned from before it.
// Each tap's value is ((q wx) wy) wz, the plain version's product, so only
// the order of the sums differs from it (atomics, from run to run).
//
// The gather.  It reads the same support from the L2-resident potential
// grid and writes each atom's forces and dE/dq, the outputs of the TPU
// functions.  Bytes do not bound it either (0.2 us at 12,290 atoms on a
// 42^3 grid): its latency and the launch do.  One thread per atom left
// the launch under one wave (97 CTAs of 128 at 12,290 atoms) and each
// thread a chain of three divisions and 64 loads, each warp-wide load
// touching 32 unrelated rows; and the wrapper converted the output to
// forces in some 45 eager launches and a host-to-device copy.  The design:
//   - the spread's layout: 16 tap threads per atom, 8 atoms per CTA of
//     128 (1,537 CTAs at 12,290 atoms), the support staged in shared
//     memory by 3 threads per atom (warp 0), here with the derivative
//     weights and the wrapped cell indices (two compares, no modulus),
//     while one thread of warp 1 computes the box's inverse;
//   - tap thread t owns (j, k) = (t / 4, t % 4) and loops over the 4 x
//     taps: the 4 threads of a grid row read 4 neighbouring cells in one
//     instruction (one sector request, two where the row crosses a sector
//     or wraps at K3), and each thread keeps 4 partial sums (phi w and the
//     three derivative products);
//   - a fixed-order reduction: __shfl_xor_sync over 8, 4, 2, 1 within each
//     16-lane half-warp, so repeats are bit-identical (no atomics, no
//     memset); lane 0 of each atom writes its outputs;
//   - the force conversion F_e = -sum_d q K_d dphi/du_d binv[e, d] inside
//     the kernel, with binv of the lower-triangular box in closed form,
//     staged once per CTA;
//   - a neutral atom is gathered like any other (its dE/dq feeds dV/dl;
//     its force is 0), the tail CTA's missing atoms stage the support of
//     u = 0 and are masked at the store, after the shuffles.
// No grid tile in shared memory: the atoms of a CTA are not spatially
// bucketed.  The layout holds 128 atoms in flight per SM where one thread
// per atom held 2,048, and it spends more instructions per atom (the
// shuffles, the staging): at 81,002 atoms, where one thread per atom
// already fills the card, it is the slower of the two.
//
// Weights: closed-form M4(w + j), j = 0..3 (the _w4 of the TPU kernel),
// tap j at grid cell (floor(u) - j) mod K; derivative taps
// dM4(j) = M3(j) - M3(j - 1).
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Box {
  // lower-triangular box rows a = (ax,0,0), b = (bx,by,0), c = (cx,cy,cz)
  float ax, bx, by, cx, cy, cz;
};

__device__ __forceinline__ Box load_box(const float* box) {
  return Box{box[0], box[3], box[4], box[6], box[7], box[8]};
}

// Grid coordinate u = K * (s - floor(s)) of fractional coordinates s,
// by exact elementwise back-substitution off the lower-triangular box.
__device__ __forceinline__ void grid_coords(const float* x, const Box& b,
                                            int K1, int K2, int K3,
                                            float u[3]) {
  const float s2 = x[2] / b.cz;
  const float s1 = (x[1] - s2 * b.cy) / b.by;
  const float s0 = (x[0] - s1 * b.bx - s2 * b.cx) / b.ax;
  u[0] = (s0 - floorf(s0)) * (float)K1;
  u[1] = (s1 - floorf(s1)) * (float)K2;
  u[2] = (s2 - floorf(s2)) * (float)K3;
}

__device__ __forceinline__ void weights4(float w, float m4[4], float m3[3]) {
  const float m2_0 = w, m2_1 = 1.0f - w;
  m3[0] = 0.5f * w * m2_0;
  m3[1] = 0.5f * ((w + 1.0f) * m2_1 + (2.0f - w) * m2_0);
  m3[2] = 0.5f * (1.0f - w) * m2_1;
  m4[0] = (w * m3[0]) / 3.0f;
  m4[1] = ((w + 1.0f) * m3[1] + (3.0f - w) * m3[0]) / 3.0f;
  m4[2] = ((w + 2.0f) * m3[2] + (2.0f - w) * m3[1]) / 3.0f;
  m4[3] = ((1.0f - w) * m3[2]) / 3.0f;
}

__device__ __forceinline__ int wrap(int i, int K) {
  const int r = i % K;
  return r < 0 ? r + K : r;
}

// wrap() for i in [-3, K], the taps of a cell floor(u), u in [0, K]
__device__ __forceinline__ int wrap_tap(int i, int K) {
  return i < 0 ? i + K : i >= K ? i - K : i;
}

// both kernels: order^2 tap threads per atom, kAtoms atoms per CTA
constexpr int kThreads = 128;
constexpr int kTaps = 16;
constexpr int kAtoms = kThreads / kTaps;

__global__ void __launch_bounds__(kThreads)
pme_spread_kernel(const float* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ box, float* __restrict__ grid,
                  int n, int K1, int K2, int K3) {
  __shared__ int s_g[kAtoms][3];
  __shared__ float s_w[kAtoms][3][4];
  __shared__ float s_q[kAtoms];
  const int a0 = blockIdx.x * kAtoms;
  if (threadIdx.x < 3 * kAtoms) {
    // stage: thread (atom la, axis d) computes that axis of the support
    const int la = threadIdx.x / 3, d = threadIdx.x - 3 * la;
    const int a = a0 + la;
    float qa = 0.0f;              // a missing atom is masked by q = 0
    if (a < n) {
      float u[3];
      grid_coords(x + 3 * a, load_box(box), K1, K2, K3, u);
      const bool finite = isfinite(u[0]) && isfinite(u[1])
                          && isfinite(u[2]);
      // fail hard as spread_plain does: a NaN charge at u = 0
      const float ud = !finite ? 0.0f : d == 0 ? u[0] : d == 1 ? u[1] : u[2];
      const int g = (int)floorf(ud);
      float m3[3];
      weights4(ud - (float)g, s_w[la][d], m3);
      s_g[la][d] = g;
      qa = finite ? q[a] : nanf("");
    }
    if (d == 0) s_q[la] = qa;
  }
  __syncthreads();
  const int la = threadIdx.x / kTaps, t = threadIdx.x % kTaps;
  const float qa = s_q[la];
  if (qa == 0.0f) return;         // neutral or missing: nothing to add
  const int j = t / 4, k = t % 4;
  const float wy = s_w[la][1][j], wz = s_w[la][2][k];
  const size_t K23 = (size_t)K2 * K3;
  const size_t yz = (size_t)wrap(s_g[la][1] - j, K2) * K3
                    + wrap(s_g[la][2] - k, K3);
  const int gx = s_g[la][0];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    atomicAdd(grid + wrap(gx - i, K1) * K23 + yz,
              qa * s_w[la][0][i] * wy * wz);
}

// the gather, on the spread's layout
__global__ void __launch_bounds__(kThreads)
pme_gather_kernel(const float* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ box,
                  const float* __restrict__ phi,
                  float* __restrict__ forces, float* __restrict__ dedq,
                  int n, int K1, int K2, int K3) {
  __shared__ int s_c[kAtoms][3][4];     // wrapped cell of each tap
  __shared__ float s_w[kAtoms][3][4];
  __shared__ float s_dw[kAtoms][3][4];
  __shared__ float s_q[kAtoms];
  __shared__ int s_ok[kAtoms];
  __shared__ float s_binv[6];           // i00, i10, i11, i20, i21, i22
  const int a0 = blockIdx.x * kAtoms;
  if (threadIdx.x < 3 * kAtoms) {
    // stage (warp 0): thread (atom la, axis d) computes that axis of the
    // support
    const int la = threadIdx.x / 3, d = threadIdx.x - 3 * la;
    const int a = a0 + la;
    bool ok = false;
    float ud = 0.0f;              // a missing or non-finite atom: u = 0
    if (a < n) {
      float u[3];
      grid_coords(x + 3 * a, load_box(box), K1, K2, K3, u);
      ok = isfinite(u[0]) && isfinite(u[1]) && isfinite(u[2]);
      if (ok) ud = d == 0 ? u[0] : d == 1 ? u[1] : u[2];
    }
    const int K = d == 0 ? K1 : d == 1 ? K2 : K3;
    const int g = (int)floorf(ud);
    float m3[3];
    weights4(ud - (float)g, s_w[la][d], m3);
    s_dw[la][d][0] = m3[0];
    s_dw[la][d][1] = m3[1] - m3[0];
    s_dw[la][d][2] = m3[2] - m3[1];
    s_dw[la][d][3] = -m3[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s_c[la][d][i] = wrap_tap(g - i, K);
    if (d == 0) {
      s_q[la] = a < n ? q[a] : 0.0f;
      s_ok[la] = ok;
    }
  } else if (threadIdx.x == 32) {
    // meanwhile (warp 1): the inverse of the lower-triangular box in
    // closed form, in gather_plain's order of operations
    const Box b = load_box(box);
    s_binv[0] = 1.0f / b.ax;
    s_binv[1] = -b.bx / (b.ax * b.by);
    s_binv[2] = 1.0f / b.by;
    s_binv[3] = (b.bx * b.cy - b.by * b.cx) / (b.ax * b.by * b.cz);
    s_binv[4] = -b.cy / (b.by * b.cz);
    s_binv[5] = 1.0f / b.cz;
  }
  __syncthreads();
  const int la = threadIdx.x / kTaps, t = threadIdx.x % kTaps;
  const int j = t / 4, k = t % 4;
  // 32-bit cell offsets: the wrapper takes grids of < 2^31 cells
  const int yz = s_c[la][1][j] * K3 + s_c[la][2][k];
  const int K23 = K2 * K3;
  float px = 0.0f, pdx = 0.0f;    // sum over the x taps of w phi, dw phi
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __ldg(phi + s_c[la][0][i] * K23 + yz);
    px += s_w[la][0][i] * v;
    pdx += s_dw[la][0][i] * v;
  }
  const float wy = s_w[la][1][j], wz = s_w[la][2][k];
  float pw = wy * wz * px;                        // phi at the atom
  float fx = wy * wz * pdx;                       // dphi/du_x
  float fy = s_dw[la][1][j] * wz * px;            // dphi/du_y
  float fz = wy * s_dw[la][2][k] * px;            // dphi/du_z
  // fixed-order reduction over the atom's 16 lanes (a half-warp)
#pragma unroll
  for (int m = kTaps / 2; m > 0; m >>= 1) {
    pw += __shfl_xor_sync(0xffffffffu, pw, m);
    fx += __shfl_xor_sync(0xffffffffu, fx, m);
    fy += __shfl_xor_sync(0xffffffffu, fy, m);
    fz += __shfl_xor_sync(0xffffffffu, fz, m);
  }
  const int a = a0 + la;
  if (t != 0 || a >= n) return;
  if (!s_ok[la]) {                // fail hard: NaN in the atom's row
    const float bad = nanf("");
    forces[3 * a] = bad;
    forces[3 * a + 1] = bad;
    forces[3 * a + 2] = bad;
    dedq[a] = bad;
    return;
  }
  // F_e = -sum_d g_d binv[e, d], g_d = q K_d dphi/du_d
  const float qa = s_q[la];
  const float g0 = fx * qa * (float)K1, g1 = fy * qa * (float)K2,
              g2 = fz * qa * (float)K3;
  forces[3 * a] = -(g0 * s_binv[0]);
  forces[3 * a + 1] = -(g0 * s_binv[1] + g1 * s_binv[2]);
  forces[3 * a + 2] = -(g0 * s_binv[3] + g1 * s_binv[4] + g2 * s_binv[5]);
  dedq[a] = pw;
}

}  // namespace

extern "C" int pme_spread_launch(const float* x, const float* q,
                                 const float* box, float* grid, int n,
                                 int K1, int K2, int K3, void* stream) {
  if (n > 0)
    pme_spread_kernel<<<(n + kAtoms - 1) / kAtoms,
                        kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, q, box, grid, n, K1, K2, K3);
  return (int)cudaGetLastError();
}

extern "C" int pme_gather_launch(const float* x, const float* q,
                                 const float* box, const float* phi,
                                 float* forces, float* dedq, int n, int K1,
                                 int K2, int K3, void* stream) {
  if (n > 0)
    pme_gather_kernel<<<(n + kAtoms - 1) / kAtoms,
                        kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, q, box, phi, forces, dedq, n, K1, K2, K3);
  return (int)cudaGetLastError();
}
