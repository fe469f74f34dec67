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
// The gather: one thread per atom reads its 4x4x4 support with plain loads
// (no atomics, 64 loads from the L2-resident potential grid).
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

// the spread: order^2 tap threads per atom, kSpreadAtoms atoms per CTA
constexpr int kSpreadThreads = 128;
constexpr int kTaps = 16;
constexpr int kSpreadAtoms = kSpreadThreads / kTaps;

__global__ void __launch_bounds__(kSpreadThreads)
pme_spread_kernel(const float* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ box, float* __restrict__ grid,
                  int n, int K1, int K2, int K3) {
  __shared__ int s_g[kSpreadAtoms][3];
  __shared__ float s_w[kSpreadAtoms][3][4];
  __shared__ float s_q[kSpreadAtoms];
  const int a0 = blockIdx.x * kSpreadAtoms;
  if (threadIdx.x < 3 * kSpreadAtoms) {
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

__global__ void pme_gather_kernel(const float* __restrict__ x,
                                  const float* __restrict__ q,
                                  const float* __restrict__ box,
                                  const float* __restrict__ phi,
                                  float* __restrict__ out, int n, int K1,
                                  int K2, int K3) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= n) return;
  const Box b = load_box(box);
  float u[3];
  grid_coords(x + 3 * a, b, K1, K2, K3, u);
  if (!(isfinite(u[0]) && isfinite(u[1]) && isfinite(u[2]))) {
    const float bad = nanf("");
    out[4 * a] = bad;
    out[4 * a + 1] = bad;
    out[4 * a + 2] = bad;
    out[4 * a + 3] = bad;
    return;
  }
  const int g0 = (int)floorf(u[0]), g1 = (int)floorf(u[1]),
            g2 = (int)floorf(u[2]);
  float wx[4], wy[4], wz[4], dx[4], dy[4], dz[4], m3[3];
  weights4(u[0] - (float)g0, wx, m3);
  dx[0] = m3[0]; dx[1] = m3[1] - m3[0]; dx[2] = m3[2] - m3[1]; dx[3] = -m3[2];
  weights4(u[1] - (float)g1, wy, m3);
  dy[0] = m3[0]; dy[1] = m3[1] - m3[0]; dy[2] = m3[2] - m3[1]; dy[3] = -m3[2];
  weights4(u[2] - (float)g2, wz, m3);
  dz[0] = m3[0]; dz[1] = m3[1] - m3[0]; dz[2] = m3[2] - m3[1]; dz[3] = -m3[2];
  int iz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) iz[k] = wrap(g2 - k, K3);
  float pw = 0.f, fxu = 0.f, fyu = 0.f, fzu = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rx = wrap(g0 - i, K1) * K2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = phi + (size_t)(rx + wrap(g1 - j, K2)) * K3;
      float p = 0.f, pdz = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = row[iz[k]];
        p += wz[k] * v;
        pdz += dz[k] * v;
      }
      pw += wx[i] * wy[j] * p;
      fxu += dx[i] * wy[j] * p;
      fyu += wx[i] * dy[j] * p;
      fzu += wx[i] * wy[j] * pdz;
    }
  }
  const float qa = q[a];
  out[4 * a] = qa * fxu;
  out[4 * a + 1] = qa * fyu;
  out[4 * a + 2] = qa * fzu;
  out[4 * a + 3] = pw;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int pme_spread_launch(const float* x, const float* q,
                                 const float* box, float* grid, int n,
                                 int K1, int K2, int K3, void* stream) {
  if (n > 0)
    pme_spread_kernel<<<(n + kSpreadAtoms - 1) / kSpreadAtoms,
                        kSpreadThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, q, box, grid, n, K1, K2, K3);
  return (int)cudaGetLastError();
}

extern "C" int pme_gather_launch(const float* x, const float* q,
                                 const float* box, const float* phi,
                                 float* out, int n, int K1, int K2, int K3,
                                 void* stream) {
  if (n > 0)
    pme_gather_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, q, box, phi, out, n, K1, K2, K3);
  return (int)cudaGetLastError();
}
