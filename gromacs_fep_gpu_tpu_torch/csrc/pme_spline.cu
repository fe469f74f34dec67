// Order-4 B-spline PME charge spread (K2) and potential gather (K3) for
// Hopper (sm_90a).
//
// Replace the TPU kernels gromacs_fep_gpu_tpu/ops/pme_blocked.py
// _spread_kernel (via blocked_spread_pallas, then _fold_blocks_axis) and
// _gather_kernel (via blocked_phi_gather_pallas).  The TPU design buckets
// atoms onto coarse blocks at each pair-list rebuild and contracts one-hot
// spline rows against per-block grid windows on the MXU, then overlap-adds
// the windows.  Hopper needs none of that: each thread owns one atom and
// touches exactly its 4x4x4 support of the global (K1, K2, K3) grid,
// spreading with atomicAdd (as the reference's pme_spread.cu does) and
// gathering with plain loads.  There is no bucketing, so no stale bucket
// can drop charge.  The TPU kernels' "fail hard" rule keeps its meaning:
// an atom whose grid coordinate is not finite poisons the grid (spread) or
// its own output row (gather) with NaN instead of being skipped.
//
// What bounds them on the H100: neither bytes nor operations.  At 12,290
// atoms and a 42^3 grid the spread moves ~0.5 MB and does ~3 Mflop, less
// than a microsecond of either resource, so both kernels run at launch
// and atomic latency.  The atomics land in L2 (the 296 KB grid stays
// resident); threads of one warp are neighbours in atom order, so their
// supports overlap little.
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

__global__ void pme_spread_kernel(const float* __restrict__ x,
                                  const float* __restrict__ q,
                                  const float* __restrict__ box,
                                  float* __restrict__ grid, int n, int K1,
                                  int K2, int K3) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= n) return;
  const Box b = load_box(box);
  float u[3];
  grid_coords(x + 3 * a, b, K1, K2, K3, u);
  const float qa = q[a];
  if (!(isfinite(u[0]) && isfinite(u[1]) && isfinite(u[2])
        && isfinite(qa))) {
    atomicAdd(grid, nanf(""));      // fail hard: never drop the charge
    return;
  }
  const int g0 = (int)floorf(u[0]), g1 = (int)floorf(u[1]),
            g2 = (int)floorf(u[2]);
  float wx[4], wy[4], wz[4], m3[3];
  weights4(u[0] - (float)g0, wx, m3);
  weights4(u[1] - (float)g1, wy, m3);
  weights4(u[2] - (float)g2, wz, m3);
  int iz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) iz[k] = wrap(g2 - k, K3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rx = wrap(g0 - i, K1) * K2;
    const float qx = qa * wx[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* row = grid + (size_t)(rx + wrap(g1 - j, K2)) * K3;
      const float qxy = qx * wy[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicAdd(row + iz[k], qxy * wz[k]);
    }
  }
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
    pme_spread_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
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
