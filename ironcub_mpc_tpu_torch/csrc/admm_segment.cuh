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

// The variants that stream K⁻¹ from device memory through L2 every
// iteration, for any P a multiple of 32 but the register variant's 128. A
// block of at most 1024 threads takes a scenario; thread t owns the
// coordinates t, t + blockDim.x, ... — ceil(P / 1024) of them
// (streamed_threads). The column sum and the clip/update are per coordinate,
// so a thread runs them for each of its coordinates in turn.
//
// - "streamed" (up to kStreamedMaxCoords coordinates a thread, P ≤ 4096):
//   each coordinate's x, z, y, q, bounds and ρ in registers, rhs in shared
//   memory.
// - "wide" (beyond): x, z and y in the output vectors and rhs in a device
//   scratch of P floats a scenario (streamed_scratch_floats), all in device
//   memory, read back through L1; q, the bounds and ρ likewise. Nothing of
//   the scenario stays in shared memory, so device memory is the only cap
//   (one K⁻¹ is 4·P² bytes). Measured on an H100 (PERF.md), keeping the
//   state in shared memory at every P made P = 256 2.2× slower than
//   registers, hence two variants.
constexpr int kStreamedMaxCoords = 4;

// threads of a streamed block: ceil(P / 1024) coordinates each, the fewest
// warps that cover P
__host__ __device__ inline int streamed_threads(int P) {
  const int per = (P + 1023) / 1024;
  return ((P + per - 1) / per + 31) / 32 * 32;
}

__host__ __device__ inline bool streamed_wide(int P) {
  return (P + 1023) / 1024 > kStreamedMaxCoords;
}

// dynamic shared memory of a streamed block: rhs, or nothing for the wide
// variant
__host__ __device__ inline size_t streamed_smem_bytes(int P) {
  return streamed_wide(P) ? 0 : sizeof(float) * static_cast<size_t>(P);
}

// device scratch a scenario of the wide variant needs (its rhs), in floats
__host__ __device__ inline size_t streamed_scratch_floats(int P) {
  return streamed_wide(P) ? static_cast<size_t>(P) : 0;
}

template <int C>
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
  const int T = blockDim.x;
  const float* K = kinv + static_cast<size_t>(b) * P * P;
  const size_t base = static_cast<size_t>(b) * P;

  float x[C], z[C], y[C], qc[C], lbc[C], ubc[C], rc[C], ric[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = threadIdx.x + c * T;
    const size_t v = base + (j < P ? j : 0);
    x[c] = x0[v];
    z[c] = z0[v];
    y[c] = y0[v];
    qc[c] = q[v];
    lbc[c] = lb[v];
    ubc[c] = ub[v];
    rc[c] = rho[v];
    ric[c] = rhoi[v];
  }
  for (int it = 0; it < length; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = threadIdx.x + c * T;
      if (j < P) s_rhs[j] = sigma * x[c] - qc[c] + rc[c] * z[c] - y[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = threadIdx.x + c * T;
      if (j < P) {
        float acc = 0.0f;
#pragma unroll 8
        for (int i = 0; i < P; ++i) acc = fmaf(s_rhs[i], K[i * P + j], acc);
        admm_update(acc, lbc[c], ubc[c], rc[c], ric[c], alpha,
                    one_minus_alpha, x[c], z[c], y[c]);
      }
    }
    __syncthreads();  // s_rhs is rewritten by the next iteration
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = threadIdx.x + c * T;
    if (j < P) {
      xo[base + j] = x[c];
      zo[base + j] = z[c];
      yo[base + j] = y[c];
    }
  }
}

__global__ void admm_segment_wide_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* xo, float* zo, float* yo,
    float* scratch, int P, float sigma, float alpha, float one_minus_alpha,
    int length) {
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const float* K = kinv + static_cast<size_t>(b) * P * P;
  const size_t base = static_cast<size_t>(b) * P;
  // the state lives in the outputs, rhs in the scratch; a thread alone
  // touches its coordinates' x, z and y, and every thread reads all of rhs
  // after the barrier (which orders the block's device-memory accesses)
  float* x = xo + base;
  float* z = zo + base;
  float* y = yo + base;
  float* rhs = scratch + base;

  for (int j = threadIdx.x; j < P; j += T) {
    x[j] = x0[base + j];
    z[j] = z0[base + j];
    y[j] = y0[base + j];
  }
  for (int it = 0; it < length; ++it) {
    for (int j = threadIdx.x; j < P; j += T)
      rhs[j] = sigma * x[j] - __ldg(q + base + j) +
               __ldg(rho + base + j) * z[j] - y[j];
    __syncthreads();
    for (int j = threadIdx.x; j < P; j += T) {
      float acc = 0.0f;
      const float* col = K + j;
#pragma unroll 8
      for (int i = 0; i < P; ++i)
        acc = fmaf(rhs[i], col[static_cast<size_t>(i) * P], acc);
      float xj = x[j], zj = z[j], yj = y[j];
      admm_update(acc, __ldg(lb + base + j), __ldg(ub + base + j),
                  __ldg(rho + base + j), __ldg(rhoi + base + j), alpha,
                  one_minus_alpha, xj, zj, yj);
      x[j] = xj;
      z[j] = zj;
      y[j] = yj;
    }
    __syncthreads();  // rhs is rewritten by the next iteration
  }
}

// launches the streamed or the wide variant; cudaErrorInvalidValue where
// the wide variant is given no scratch (streamed_scratch_floats(P) a
// scenario)
inline cudaError_t launch_streamed(
    cudaLaunchConfig_t cfg, const float* kinv, const float* q,
    const float* lb, const float* ub, const float* rho, const float* rhoi,
    const float* x0, const float* z0, const float* y0, float* xo, float* zo,
    float* yo, float* scratch, int P, float sigma, float alpha,
    float one_minus_alpha, int length) {
  cfg.blockDim = dim3(streamed_threads(P));
  cfg.dynamicSmemBytes = streamed_smem_bytes(P);
  const int per = (P + 1023) / 1024;
  static_assert(kStreamedMaxCoords == 4, "the cases below instantiate 1..4");
#define ADMM_SEGMENT_ARGS                                                    \
  kinv, q, lb, ub, rho, rhoi, x0, z0, y0, xo, zo, yo, P, sigma, alpha,       \
      one_minus_alpha, length
  switch (per) {
    case 1:
      return cudaLaunchKernelEx(&cfg, admm_segment_streamed_kernel<1>,
                                ADMM_SEGMENT_ARGS);
    case 2:
      return cudaLaunchKernelEx(&cfg, admm_segment_streamed_kernel<2>,
                                ADMM_SEGMENT_ARGS);
    case 3:
      return cudaLaunchKernelEx(&cfg, admm_segment_streamed_kernel<3>,
                                ADMM_SEGMENT_ARGS);
    case 4:
      return cudaLaunchKernelEx(&cfg, admm_segment_streamed_kernel<4>,
                                ADMM_SEGMENT_ARGS);
    default:
      if (scratch == nullptr) return cudaErrorInvalidValue;
      return cudaLaunchKernelEx(&cfg, admm_segment_wide_kernel, kinv, q, lb,
                                ub, rho, rhoi, x0, z0, y0, xo, zo, yo,
                                scratch, P, sigma, alpha, one_minus_alpha,
                                length);
  }
#undef ADMM_SEGMENT_ARGS
}

}  // namespace
