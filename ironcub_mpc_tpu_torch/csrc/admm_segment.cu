// admm_segment — `length` over-relaxed ADMM iterations of the condensed
// box QP, one scenario per thread block, K⁻¹ resident on the SM.
//
// Replaces the TPU kernel ironcub_mpc_tpu/ops/pallas_solve.py
// `admm_segment` (body `_segment_kernel`). Per iteration, in the full
// padded layout (ρ = 1/ρ = 0 and bounds ±inf_bound outside the box):
//   rhs = σx − q + ρz − y;  x̃ = rhs·K⁻¹   (row-vector form, as on the TPU:
//                                           the recovery inverse is not symmetric)
//   x ← αx̃ + (1−α)x;  z_un = αx̃ + (1−α)z + y·ρ⁻¹
//   z ← clip(z_un, lb, ub);  y ← ρ(z_un − z)
//
// What bounds it on an H100: the bytes of K⁻¹ (4·P² a scenario, read once
// a segment) when the card is full, and the latency of `length` dependent
// mat-vecs when it is not (a lone scenario). Three routes, chosen by the
// padded size and the batch (ops/kernels.segment_plan; the launcher takes
// its choice and refuses what the routes do not take):
//
// - "registers" (P = 128): 512 threads a scenario keep K⁻¹ in registers for
//   the whole segment, 32 entries each, loaded straight from device memory
//   with eight 16-byte loads in flight a thread. Warp w owns the columns
//   8w..8w+7, lane l the rows 4l..4l+3. An iteration reads only rhs, one
//   float4 a thread from a double-buffered 512-byte shared array, runs 32
//   FMAs in eight independent accumulators, and sums the 32 row parts of a
//   column with a transposing shuffle reduction (9 shuffles for 8 columns),
//   in a fixed order. The four lanes that end up with column 8w + l/4 all
//   carry its x, z, y, bounds and ρ in registers and update them alike; the
//   first of them writes the next rhs. One __syncthreads() an iteration.
//   ~1 KB of shared memory and at most 64 registers: two blocks an SM, so
//   256 scenarios are one wave.
// - "cluster" (P up to 640 where a cluster's shared memory holds K⁻¹): a
//   scenario on a cluster of C blocks, each with a column strip of K⁻¹ in
//   its shared memory or registers for the whole segment, rhs pushed into
//   every block before one cluster barrier an iteration.
// - "spread" (beyond): a strip of 32, 16 or 8 columns a block over the
//   whole card, one launch an iteration, rhs in a device scratch of 2·B·P floats that the
//   caller passes (`scratch` is not read by the other routes).
// Both are in admm_segment.cuh, shared with admm_segment_grouped.cu, as is
// the iteration's vector half.
// Plain fp32 FMA on CUDA cores throughout, no TF32.

#include "admm_segment.cuh"

namespace {

constexpr int kRegP = 128;        // padded size of the register variant
constexpr int kRegThreads = 512;  // 16 warps x (8 columns, 32 row parts)

__global__ void __launch_bounds__(kRegThreads, 2) admm_segment_reg_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* __restrict__ xo,
    float* __restrict__ zo, float* __restrict__ yo, float sigma, float alpha,
    float one_minus_alpha, int length) {
  __shared__ float4 s_rhs[2][kRegP / 4];
  const unsigned kFull = 0xffffffffu;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* kb = kinv + static_cast<size_t>(b) * kRegP * kRegP;

  // K⁻¹[4·lane + a, 8·warp .. 8·warp + 7], a = 0..3
  float4 k[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4* row = reinterpret_cast<const float4*>(
        kb + (4 * lane + a) * kRegP + 8 * warp);
    k[a][0] = __ldg(row);
    k[a][1] = __ldg(row + 1);
  }

  // the coordinate whose column sum the reduction leaves in this lane
  const int j = 8 * warp + (lane >> 2);
  const bool writer = (lane & 3) == 0;
  const size_t v = static_cast<size_t>(b) * kRegP + j;
  const float qj = q[v], lbj = lb[v], ubj = ub[v];
  const float rj = rho[v], rij = rhoi[v];
  float x = x0[v], z = z0[v], y = y0[v];
  const bool up16 = (lane & 16) != 0, up8 = (lane & 8) != 0,
             up4 = (lane & 4) != 0;

  for (int it = 0; it < length; ++it) {
    float* rhs_w = reinterpret_cast<float*>(s_rhs[it & 1]);
    if (writer) rhs_w[j] = sigma * x - qj + rj * z - y;
    __syncthreads();
    const float4 r = s_rhs[it & 1][lane];
    const float rr[4] = {r.x, r.y, r.z, r.w};
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[0] = fmaf(rr[a], k[a][0].x, acc[0]);
      acc[1] = fmaf(rr[a], k[a][0].y, acc[1]);
      acc[2] = fmaf(rr[a], k[a][0].z, acc[2]);
      acc[3] = fmaf(rr[a], k[a][0].w, acc[3]);
      acc[4] = fmaf(rr[a], k[a][1].x, acc[4]);
      acc[5] = fmaf(rr[a], k[a][1].y, acc[5]);
      acc[6] = fmaf(rr[a], k[a][1].z, acc[6]);
      acc[7] = fmaf(rr[a], k[a][1].w, acc[7]);
    }
    // sum over the 32 lanes, halving the columns a lane keeps at each of the
    // first three steps: lane l ends with column l / 4
    float v4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up16 ? acc[i] : acc[i + 4];
      const float keep = up16 ? acc[i + 4] : acc[i];
      v4[i] = keep + __shfl_xor_sync(kFull, send, 16);
    }
    float v2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up8 ? v4[i] : v4[i + 2];
      const float keep = up8 ? v4[i + 2] : v4[i];
      v2[i] = keep + __shfl_xor_sync(kFull, send, 8);
    }
    const float send = up4 ? v2[0] : v2[1];
    const float keep = up4 ? v2[1] : v2[0];
    float xt = keep + __shfl_xor_sync(kFull, send, 4);
    xt += __shfl_xor_sync(kFull, xt, 2);
    xt += __shfl_xor_sync(kFull, xt, 1);
    admm_update(xt, lbj, ubj, rj, rij, alpha, one_minus_alpha, x, z, y);
  }
  if (writer) {
    xo[v] = x;
    zo[v] = z;
    yo[v] = y;
  }
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue where the shape or the
// route is outside what the kernels take (the Python wrapper checks the
// same first). `cluster` (1, 2, 4 or 8 blocks a scenario; 0 for the spread
// route), `kinv_regs` and `spread_cols` (8, 16 or 32 columns a spread
// block) are segment_plan's; the register route at P = 128 reads none.
extern "C" int admm_segment_launch(
    const float* kinv, const float* q, const float* lb, const float* ub,
    const float* rho, const float* rhoi, const float* x0, const float* z0,
    const float* y0, float* xo, float* zo, float* yo, float* scratch, int B,
    int P, float sigma, float alpha, float one_minus_alpha, int length,
    int cluster, int kinv_regs, int spread_cols, cudaStream_t stream) {
  if (P < 32 || P % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (P == kRegP) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B);
    cfg.blockDim = dim3(kRegThreads);
    cfg.stream = stream;
    err = cudaLaunchKernelEx(&cfg, admm_segment_reg_kernel, kinv, q, lb, ub,
                             rho, rhoi, x0, z0, y0, xo, zo, yo, sigma, alpha,
                             one_minus_alpha, length);
  } else {
    err = launch_segment_routes(B, stream, kinv, q, lb, ub, rho, rhoi, x0, z0,
                                y0, xo, zo, yo, scratch, P, sigma, alpha,
                                one_minus_alpha, length, cluster, kinv_regs,
                                spread_cols);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory in bytes of a block of the cluster route at (P, C,
// kinv_regs), or -1 where the route does not take them (ops/kernels
// .segment_cluster_smem_bytes and segment_cluster_takes mirror both)
extern "C" long admm_segment_cluster_smem_bytes(int P, int cluster,
                                                int kinv_regs) {
  const int regs = kinv_regs ? 1 : 0;
  if (P < 32 || P % 32 || !seg_cluster_takes(P, cluster, regs)) return -1;
  return static_cast<long>(seg_cluster_smem_bytes(P, cluster, regs));
}
