// admm_segment_grouped — the ADMM segment of admm_segment.cu for `group`
// scenarios per thread block, each scenario with its own K⁻¹.
//
// Replaces the TPU kernel ironcub_mpc_tpu/ops/pallas_solve.py
// `admm_segment_grouped` (body `_segment_group_kernel`): the batch is cut
// into B/G groups and one program advances the G scenarios of its group
// together through all `length` iterations. Per iteration and scenario, in
// the full padded layout (ρ = 1/ρ = 0 and bounds ±inf_bound outside the box):
//   rhs = σx − q + ρz − y;  x̃ = rhs·K⁻¹   (row-vector form, as on the TPU)
//   x ← αx̃ + (1−α)x;  z_un = αx̃ + (1−α)z + y·ρ⁻¹
//   z ← clip(z_un, lb, ub);  y ← ρ(z_un − z)
//
// What bounds it on an H100: at the head-to-head shape (B = 512, 40
// iterations, P = 128) the 0.67 GFLOP of mat-vecs (10 µs at the fp32 peak)
// and reading the 33.6 MB of K⁻¹ once (10 µs) weigh the same; with the
// vectors counted the bytes are just ahead — but only if K⁻¹ is not read
// again from device memory every iteration.
//
// The TPU program keeps all G matrices in its fast memory (8 × 64 KB). One
// Hopper block has 227 KB of shared memory, so eight do not fit. This
// kernel gives each scenario of the group an equal share of the block's
// shared memory: the first `rows_res` rows of its K⁻¹ stay resident for the
// whole segment (all 128 for G ≤ 3, 112 for G = 4, 55 for G = 8) and the
// remaining rows are streamed every iteration through the read-only path;
// after the first iteration they come from L2 (the whole batch of K⁻¹ at
// B = 512 fits the card's 50 MB L2), never from device memory twice in a
// row. The alternatives weighed: a thread-block cluster of G blocks with one
// resident K⁻¹ each is the single-scenario kernel under another launch shape
// (the scenarios exchange nothing), and K⁻¹ split over shared memory and
// registers still cannot hold 512 KB on one SM (256 KB of registers + 227 KB
// of shared memory). With G = 8 a batch of 512 fills only 64 of the 132 SMs,
// so this kernel is expected to run slower than admm_segment at that shape;
// it is the faithful port of the grouped program, kept with its measured
// time.
//
// Layout: grid B/G, block G·P threads; thread (g, j) owns coordinate j of
// scenario g with x_j, z_j, y_j and its bounds in registers. The P threads of
// one scenario meet at their own named barrier (id g + 1), so the scenarios
// of a group do not wait for each other and one scenario's elementwise phase
// overlaps another's mat-vec. x̃_j = Σ_i rhs_i·K⁻¹[i, j] runs over i in
// ascending order, resident rows first, the same order as admm_segment.cu.
// Plain fp32 FMA on CUDA cores, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB per block on Hopper
constexpr int kMaxThreads = 1024;  // threads per block
constexpr int kMaxBarriers = 15;   // named barriers 1..15 (0 is __syncthreads)

// clip(v, lo, hi) = min(max(v, lo), hi) with NaN propagated, as jnp.clip
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// barrier of the `count` threads that use barrier `id`
__device__ __forceinline__ void scenario_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__global__ void __launch_bounds__(kMaxThreads) admm_segment_grouped_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* __restrict__ xo,
    float* __restrict__ zo, float* __restrict__ yo, int P, int G,
    int rows_res, float sigma, float alpha, float one_minus_alpha,
    int length) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / P;  // scenario within the group
  const int j = threadIdx.x % P;  // coordinate
  float* s_rhs = smem + g * P;                                    // [P]
  float* s_k = smem + G * P + static_cast<size_t>(g) * rows_res * P;
  const size_t b = static_cast<size_t>(blockIdx.x) * G + g;
  const float* kb = kinv + b * P * P;
  const size_t v = b * P + j;
  const int bar = g + 1;

  {
    const float4* src = reinterpret_cast<const float4*>(kb);
    float4* dst = reinterpret_cast<float4*>(s_k);
    for (int e = j; e < rows_res * P / 4; e += P) dst[e] = src[e];
  }
  const float qj = q[v], lbj = lb[v], ubj = ub[v];
  const float rj = rho[v], rij = rhoi[v];
  float x = x0[v], z = z0[v], y = y0[v];
  scenario_sync(bar, P);

  for (int it = 0; it < length; ++it) {
    s_rhs[j] = sigma * x - qj + rj * z - y;
    scenario_sync(bar, P);
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < rows_res; ++i)
      acc = fmaf(s_rhs[i], s_k[i * P + j], acc);
#pragma unroll 8
    for (int i = rows_res; i < P; ++i)
      acc = fmaf(s_rhs[i], __ldg(kb + i * P + j), acc);
    scenario_sync(bar, P);  // s_rhs is rewritten by the next iteration
    const float x_n = alpha * acc + one_minus_alpha * x;
    const float z_un = alpha * acc + one_minus_alpha * z + y * rij;
    const float z_n = clip_nan(z_un, lbj, ubj);
    y = rj * (z_un - z_n);
    x = x_n;
    z = z_n;
  }
  xo[v] = x;
  zo[v] = z;
  yo[v] = y;
}

}  // namespace

// Returns a CUDA error code, or -1 when the shape is outside what the
// kernel takes (the Python wrapper checks the same conditions first).
extern "C" int admm_segment_grouped_launch(
    const float* kinv, const float* q, const float* lb, const float* ub,
    const float* rho, const float* rhoi, const float* x0, const float* z0,
    const float* y0, float* xo, float* zo, float* yo, int B, int P, int G,
    float sigma, float alpha, float one_minus_alpha, int length,
    cudaStream_t stream) {
  if (G < 1 || G > kMaxBarriers || P < 32 || P % 32 || G * P > kMaxThreads ||
      B % G)
    return -1;
  const size_t row_bytes = sizeof(float) * static_cast<size_t>(G) * P;
  int rows_res = static_cast<int>((kMaxSmem - row_bytes) / row_bytes);
  if (rows_res > P) rows_res = P;
  const size_t smem = row_bytes * (1 + rows_res);
  cudaError_t err = cudaFuncSetAttribute(
      admm_segment_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    admm_segment_grouped_kernel<<<B / G, G * P, smem, stream>>>(
        kinv, q, lb, ub, rho, rhoi, x0, z0, y0, xo, zo, yo, P, G, rows_res,
        sigma, alpha, one_minus_alpha, length);
  }
  return static_cast<int>(cudaGetLastError());
}
