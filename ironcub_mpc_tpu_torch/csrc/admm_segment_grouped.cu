// admm_segment_grouped — the ADMM segment of admm_segment.cu over a whole
// batch, every scenario's K⁻¹ on chip for all `length` iterations.
//
// Replaces the TPU kernel ironcub_mpc_tpu/ops/pallas_solve.py
// `admm_segment_grouped` (body `_segment_group_kernel`). Per iteration and
// scenario, in the full padded layout (ρ = 1/ρ = 0 and bounds ±inf_bound
// outside the box):
//   rhs = σx − q + ρz − y;  x̃ = rhs·K⁻¹   (row-vector form, as on the TPU)
//   x ← αx̃ + (1−α)x;  z_un = αx̃ + (1−α)z + y·ρ⁻¹
//   z ← clip(z_un, lb, ub);  y ← ρ(z_un − z)
//
// On the TPU `group` sets how many scenarios one program tiles through its
// fast memory. Here the placement follows the card, not `group`: the wrapper
// keeps only its contract (B divisible by group, the same result for every
// group), and the launcher chooses the variant by P (ops/kernels.grouped_plan
// mirrors it).
//
// What bounds it on an H100: not the bytes. Each K⁻¹ is read from device
// memory once (64 KB a scenario at P = 128; 33.6 MB at B = 512 is 10 µs at
// 3.35 TB/s), in however many waves the batch takes, so a second wave
// re-reads nothing. What sets the time is the chain of one iteration — the
// block's barrier, the FMAs, the reduction of a column's partial sums across
// lanes — and the instructions 32 warps an SM execute for it. Two variants:
//
// - "registers" (P = 128): one scenario a block of 512 threads with K⁻¹ in
//   their registers (32 floats a thread, ≤ 64 registers, two blocks an SM,
//   264 scenarios a wave), in a layout of its own (grouped_reg_kernel) whose
//   reduction takes 5 shuffles a column where admm_segment's takes 9.
//   Tried and dropped (PERF.md §6): a second K⁻¹ a block in shared memory
//   ("paired", four scenarios an SM, one wave at B = 512): reading 64 KB of
//   shared memory a scenario-iteration costs more than a second wave;
//   one column of 32 rows a thread (8 rhs float4 reads a thread, 4-way bank
//   conflicts) and 16 rows × 2 columns (no faster than 8 × 4).
// - "streamed" (any other P, a multiple of 32 up to 1024): one thread per
//   coordinate, K⁻¹ re-read through L2 every iteration — admm_segment's
//   streamed kernel (admm_segment.cuh).
// Plain fp32 FMA on CUDA cores, no TF32; __syncthreads() only.

#include "admm_segment.cuh"

namespace {

constexpr int kRegP = 128;        // padded size of the registers variant
constexpr int kThreads = 512;     // 16 warps x 2 halves x 16 lanes
constexpr int kMaxP = 1024;       // the streamed variant: a thread a coordinate

// One scenario a block, K⁻¹ in registers. Half h of warp w owns the columns
// 8w + 4h .. +3; its lane l' = lane mod 16 holds rows 4l'..4l'+3 and
// 64 + 4l'..64 + 4l'+3 of them (32 floats). An iteration reads the lane's
// eight rhs entries as two float4 (a half-warp reads 256 contiguous bytes),
// runs 32 FMAs in four accumulators (one a column, rows in ascending order),
// and sums each column over the 16 lanes of the half: two transposing steps
// halve the columns a lane keeps (lane l ends with column 8w + l/4), two more
// shuffles add the four lanes that share it — 5 shuffles and 6 selects where
// admm_segment's layout (4 rows × 8 columns, 32 lanes a column) needs 9 and
// 14. The four lanes then update x̃_c alike, the first writes the next rhs.
// One __syncthreads() an iteration.
__global__ void __launch_bounds__(kThreads, 2) grouped_reg_kernel(
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
  const int lh = lane & 15;
  const float* kb = kinv + static_cast<size_t>(b) * kRegP * kRegP +
                    8 * warp + 4 * (lane >> 4);

  // K⁻¹[row(a), 8w + 4h .. +3], row(a) = 4l' + a, then 64 + 4l' + a − 4
  float4 k[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = (a < 4 ? 0 : 64) + 4 * lh + (a & 3);
    k[a] = __ldg(reinterpret_cast<const float4*>(kb + row * kRegP));
  }

  const int c = 8 * warp + (lane >> 2);
  const bool writer = (lane & 3) == 0;
  const size_t v = static_cast<size_t>(b) * kRegP + c;
  const float qc = q[v], lbc = lb[v], ubc = ub[v];
  const float rc = rho[v], ric = rhoi[v];
  float x = x0[v], z = z0[v], y = y0[v];
  const bool up8 = (lane & 8) != 0, up4 = (lane & 4) != 0;

  for (int it = 0; it < length; ++it) {
    float* rhs_w = reinterpret_cast<float*>(s_rhs[it & 1]);
    if (writer) rhs_w[c] = sigma * x - qc + rc * z - y;
    __syncthreads();
    const float4 r0 = s_rhs[it & 1][lh], r1 = s_rhs[it & 1][16 + lh];
    const float rr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      acc[0] = fmaf(rr[a], k[a].x, acc[0]);
      acc[1] = fmaf(rr[a], k[a].y, acc[1]);
      acc[2] = fmaf(rr[a], k[a].z, acc[2]);
      acc[3] = fmaf(rr[a], k[a].w, acc[3]);
    }
    float v2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up8 ? acc[i] : acc[i + 2];
      const float keep = up8 ? acc[i + 2] : acc[i];
      v2[i] = keep + __shfl_xor_sync(kFull, send, 8);
    }
    const float send = up4 ? v2[0] : v2[1];
    const float keep = up4 ? v2[1] : v2[0];
    float xt = keep + __shfl_xor_sync(kFull, send, 4);
    xt += __shfl_xor_sync(kFull, xt, 2);
    xt += __shfl_xor_sync(kFull, xt, 1);
    admm_update(xt, lbc, ubc, rc, ric, alpha, one_minus_alpha, x, z, y);
  }
  if (writer) {
    xo[v] = x;
    zo[v] = z;
    yo[v] = y;
  }
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue where the shape is
// outside what the kernel takes (the Python wrapper checks the same first).
// `group` is checked, not used: the placement is chosen by P alone, as
// ops/kernels.grouped_plan says.
extern "C" int admm_segment_grouped_launch(
    const float* kinv, const float* q, const float* lb, const float* ub,
    const float* rho, const float* rhoi, const float* x0, const float* z0,
    const float* y0, float* xo, float* zo, float* yo, int B, int P, int G,
    float sigma, float alpha, float one_minus_alpha, int length,
    cudaStream_t stream) {
  if (G < 1 || B % G || P < 32 || P % 32 || P > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.stream = stream;
  cudaError_t err;
  if (P == kRegP) {
    cfg.blockDim = dim3(kThreads);
    err = cudaLaunchKernelEx(&cfg, grouped_reg_kernel, kinv, q, lb, ub, rho,
                             rhoi, x0, z0, y0, xo, zo, yo, sigma, alpha,
                             one_minus_alpha, length);
  } else {
    cfg.blockDim = dim3(P);
    cfg.dynamicSmemBytes = sizeof(float) * P;
    err = cudaLaunchKernelEx(&cfg, admm_segment_streamed_kernel, kinv, q, lb,
                             ub, rho, rhoi, x0, z0, y0, xo, zo, yo, P, sigma,
                             alpha, one_minus_alpha, length);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
