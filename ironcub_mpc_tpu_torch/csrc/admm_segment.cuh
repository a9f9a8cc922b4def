// Device code shared by admm_segment.cu and admm_segment_grouped.cu: one
// over-relaxed ADMM iteration's vector half and the streamed variant. Per
// iteration, in the full padded layout (ρ = 1/ρ = 0 and bounds ±inf_bound
// outside the box):
//   rhs = σx − q + ρz − y;  x̃ = rhs·K⁻¹   (row-vector form, as on the TPU:
//                                           the recovery inverse is not symmetric)
//   x ← αx̃ + (1−α)x;  z_un = αx̃ + (1−α)z + y·ρ⁻¹
//   z ← clip(z_un, lb, ub);  y ← ρ(z_un − z)
// Plain fp32 FMA on CUDA cores, no TF32.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 dyn_smem_f4[];
  return reinterpret_cast<float*>(dyn_smem_f4);
}

// clip(v, lo, hi) = min(max(v, lo), hi) with NaN propagated, as jnp.clip
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// the vector half of one iteration for one coordinate, from x̃_j
__device__ __forceinline__ void admm_update(float xt, float lb, float ub,
                                            float rho, float rhoi, float alpha,
                                            float one_minus_alpha, float& x,
                                            float& z, float& y) {
  const float x_n = alpha * xt + one_minus_alpha * x;
  const float z_un = alpha * xt + one_minus_alpha * z + y * rhoi;
  const float z_n = clip_nan(z_un, lb, ub);
  y = rho * (z_un - z_n);
  x = x_n;
  z = z_n;
}

// one thread per coordinate, any P a multiple of 32 up to 1024; K⁻¹ is read
// from device memory through L2 every iteration
__global__ void admm_segment_streamed_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* __restrict__ xo,
    float* __restrict__ zo, float* __restrict__ yo, int P, float sigma,
    float alpha, float one_minus_alpha, int length) {
  float* s_rhs = dyn_smem();  // [P]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float* K = kinv + static_cast<size_t>(b) * P * P;
  const size_t v = static_cast<size_t>(b) * P + j;

  const float qj = q[v], lbj = lb[v], ubj = ub[v];
  const float rj = rho[v], rij = rhoi[v];
  float x = x0[v], z = z0[v], y = y0[v];

  for (int it = 0; it < length; ++it) {
    s_rhs[j] = sigma * x - qj + rj * z - y;
    __syncthreads();
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < P; ++i) acc = fmaf(s_rhs[i], K[i * P + j], acc);
    __syncthreads();  // s_rhs is rewritten by the next iteration
    admm_update(acc, lbj, ubj, rj, rij, alpha, one_minus_alpha, x, z, y);
  }
  xo[v] = x;
  zo[v] = z;
  yo[v] = y;
}

}  // namespace
