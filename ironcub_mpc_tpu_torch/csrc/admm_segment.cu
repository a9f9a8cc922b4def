// admm_segment — `length` over-relaxed ADMM iterations of the condensed
// box QP, one scenario per thread block, K⁻¹ resident in shared memory.
//
// Replaces the TPU kernel ironcub_mpc_tpu/ops/pallas_solve.py
// `admm_segment` (body `_segment_kernel`). Per iteration, in the full
// padded layout (ρ = 1/ρ = 0 and bounds ±inf_bound outside the box):
//   rhs = σx − q + ρz − y;  x̃ = rhs·K⁻¹   (row-vector form, as on the TPU)
//   x ← αx̃ + (1−α)x;  z_un = αx̃ + (1−α)z + y·ρ⁻¹
//   z ← clip(z_un, lb, ub);  y ← ρ(z_un − z)
//
// What bounds it on an H100: the bytes of K⁻¹. Each iteration is a P×P
// mat-vec (2P² FLOP) against a matrix that does not change during the
// segment, so re-reading K⁻¹ from device memory every iteration would make
// the kernel memory-bound `length` times over. The design keeps K⁻¹ in
// shared memory for the whole segment (128·128·4 = 64 KB for the stock
// P = 128), so device memory is read once per segment: at B = 256 that is
// 16.8 MB, about 5 µs at 3.35 TB/s, against 42 MFLOP (under 1 µs at the
// fp32 peak) for length 5. At B = 1 the kernel runs on one SM and is bound
// by the latency of its `length` dependent mat-vecs.
//
// Layout: grid B, one thread per padded coordinate (blockDim = P). Thread j
// keeps x_j, z_j, y_j and its bounds in registers; rhs goes through a [P]
// shared buffer; x̃_j = Σ_i rhs_i·K⁻¹[i, j] reads row i across the block, so
// neighbouring threads read neighbouring words (no bank conflicts). Plain
// fp32 FMA on CUDA cores, no TF32. When K⁻¹ does not fit in shared memory
// (P > 128) it is read from device memory (through L2) instead.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB per block on Hopper

// clip(v, lo, hi) = min(max(v, lo), hi) with NaN propagated, as jnp.clip
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void admm_segment_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* __restrict__ xo,
    float* __restrict__ zo, float* __restrict__ yo, int P, float sigma,
    float alpha, float one_minus_alpha, int length, bool resident) {
  extern __shared__ float smem[];
  float* s_rhs = smem;      // [P]
  float* s_k = smem + P;    // [P, P] when resident
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float* kb = kinv + static_cast<size_t>(b) * P * P;
  const size_t v = static_cast<size_t>(b) * P + j;

  if (resident) {
    const float4* src = reinterpret_cast<const float4*>(kb);
    float4* dst = reinterpret_cast<float4*>(s_k);
    for (int e = j; e < P * P / 4; e += P) dst[e] = src[e];
  }
  const float* K = resident ? s_k : kb;

  const float qj = q[v], lbj = lb[v], ubj = ub[v];
  const float rj = rho[v], rij = rhoi[v];
  float x = x0[v], z = z0[v], y = y0[v];
  __syncthreads();

  for (int it = 0; it < length; ++it) {
    s_rhs[j] = sigma * x - qj + rj * z - y;
    __syncthreads();
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < P; ++i) acc = fmaf(s_rhs[i], K[i * P + j], acc);
    __syncthreads();  // s_rhs is rewritten by the next iteration
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

extern "C" int admm_segment_launch(
    const float* kinv, const float* q, const float* lb, const float* ub,
    const float* rho, const float* rhoi, const float* x0, const float* z0,
    const float* y0, float* xo, float* zo, float* yo, int B, int P,
    float sigma, float alpha, float one_minus_alpha, int length,
    cudaStream_t stream) {
  const size_t resident_bytes = sizeof(float) * (static_cast<size_t>(P) * P + P);
  const bool resident = resident_bytes <= static_cast<size_t>(kMaxSmem);
  const size_t smem = resident ? resident_bytes : sizeof(float) * P;
  cudaError_t err = cudaFuncSetAttribute(
      admm_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    admm_segment_kernel<<<B, P, smem, stream>>>(
        kinv, q, lb, ub, rho, rhoi, x0, z0, y0, xo, zo, yo, P, sigma, alpha,
        one_minus_alpha, length, resident);
  }
  return static_cast<int>(cudaGetLastError());
}
