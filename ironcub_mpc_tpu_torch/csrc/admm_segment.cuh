// Device code shared by admm_segment.cu and admm_segment_grouped.cu: one
// over-relaxed ADMM iteration's vector half, and the cluster and spread
// routes. Per iteration, in the full padded layout (ρ = 1/ρ = 0 and bounds
// ±inf_bound outside the box):
//   rhs = σx − q + ρz − y;  x̃ = rhs·K⁻¹   (row-vector form, as on the TPU:
//                                           the recovery inverse is not symmetric)
//   x ← αx̃ + (1−α)x;  z_un = αx̃ + (1−α)z + y·ρ⁻¹
//   z ← clip(z_un, lb, ub);  y ← ρ(z_un − z)
// Plain fp32 FMA on CUDA cores, no TF32.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// The two routes for every P but the register route's 128 (any multiple of
// 32), both spreading a scenario's mat-vec x̃ = rhs·K⁻¹ over several SMs by
// columns: each column's whole sum is taken inside one block, in a fixed
// order, so no partial sum crosses a block.
//
// - "cluster": a scenario is a cluster of C blocks (C = 1, 2, 4 or 8, the
//   portable sizes). Block r owns the column strip [rW, rW + W), W = P / C,
//   and loads it once a segment: into shared memory with cp.async (rows
//   padded to W + 4 floats, so that the 16-byte reads of eight rows meet no
//   bank twice), or, at P = 256, into registers (kinv_regs). A warp owns
//   kSegCols = 8 columns of the strip; lane l takes the rows l, l + 32, ...
//   and sums the eight columns in eight accumulators, then a transposing
//   shuffle reduction (9 shuffles) leaves column l / 4 in lanes 4(l/4) ..
//   +3, which all carry its x, z, y, bounds and ρ in registers and update
//   it alike. The first of them writes the next rhs entry into every
//   block's double-buffered rhs array (cluster.map_shared_rank) before the
//   iteration's one cluster.sync(): no block reads another's shared memory
//   after the barrier. Measured on an H100 (PERF.md §6), the strip in
//   registers beats shared memory at P = 256 by 9–16 %, and a cluster of 8
//   holding a third of each strip at P = 1152 (the rest re-read from L2)
//   lost 4.7× to the spread route, so the route takes only strips held
//   whole (P up to 640).
// - "spread": B·P/W blocks of 256 threads, each a strip of W = 32, 16 or 8
//   columns of one scenario (the widest whose blocks cover at least half
//   the card's SMs), one launch an iteration, so that the iterations meet at
//   kernel boundaries (a cooperative grid.sync() would deadlock the CPU
//   stand-in of tests/cuda_emu, which runs a grid one cluster at a time).
//   A launch streams its strip from L2 or HBM with 16 16-byte loads in
//   flight a thread (whole row segments a warp instruction), reads rhs
//   from a device scratch (the first launch forms it from x0, q, ρ, z0 and
//   y0), sums each column over its warps in a fixed order, updates its W
//   coordinates (state in the outputs) and writes their next rhs into the
//   other half of the double-buffered scratch (2·B·P floats). Device
//   memory is the only cap.
// ops/kernels.segment_plan chooses the route, the cluster and the place of
// K⁻¹; the launchers refuse what these kernels do not take.
constexpr int kSegCols = 8;            // columns a warp of a cluster block owns
constexpr int kSegPad = 4;             // floats a strip row is padded by
constexpr int kSegMaxThreads = 1024;
constexpr int kSegMaxSmem = 232448;    // dynamic shared memory of a block
constexpr int kSegRegRows = 8;         // rows a lane holds in registers
constexpr int kSegRegP = 32 * kSegRegRows;  // the P of the register strip
constexpr int kSegRegMaxThreads = 512;
constexpr int kSpreadThreads = 256;
constexpr int kSpreadWarps = kSpreadThreads / 32;
constexpr int kSpreadUnroll = 16;      // 16-byte loads in flight a thread
#ifdef ADMM_SEGMENT_NO_MATVEC
constexpr bool kSegNoMatvec = true;    // a timing build: see the cluster kernel
#else
constexpr bool kSegNoMatvec = false;
#endif

// dynamic shared memory of a cluster block, in bytes: rhs [2, P] and, but
// where K⁻¹ lies in registers, the strip [P, P / C + kSegPad]
__host__ __device__ inline size_t seg_cluster_smem_bytes(int P, int C,
                                                         int regs) {
  const size_t rows = regs ? 0 : static_cast<size_t>(P);
  return sizeof(float) * (2 * static_cast<size_t>(P) +
                          rows * (P / C + kSegPad));
}

// whether the cluster route takes (P, C, regs): a strip a multiple of 8
// columns, at most 1024 threads (512 with K⁻¹ in registers, which holds only
// P = 256), the whole strip and rhs on chip
__host__ __device__ inline bool seg_cluster_takes(int P, int C, int regs) {
  if (C != 1 && C != 2 && C != 4 && C != 8) return false;
  if (P % C || (P / C) % kSegCols) return false;
  const int threads = 32 * (P / C) / kSegCols;
  if (threads > (regs ? kSegRegMaxThreads : kSegMaxThreads)) return false;
  if (regs && P != kSegRegP) return false;
  return seg_cluster_smem_bytes(P, C, regs) <= kSegMaxSmem;
}

// the sum over a warp of acc[c], c < kSegCols, left in lanes 4c .. 4c + 3:
// three transposing steps halve the columns a lane keeps, two more shuffles
// add the four lanes that share one
__device__ __forceinline__ float seg_column_sum(float (&acc)[kSegCols],
                                                int lane) {
  const unsigned kFull = 0xffffffffu;
#pragma unroll
  for (int n = kSegCols / 2, bit = 16; n >= 1; n /= 2, bit /= 2) {
    const bool up = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? acc[i] : acc[i + n];
      const float keep = up ? acc[i + n] : acc[i];
      acc[i] = keep + __shfl_xor_sync(kFull, send, bit);
    }
  }
  float s = acc[0];
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

__device__ __forceinline__ void seg_fma8(float (&acc)[kSegCols], float r,
                                         float4 a, float4 b) {
  acc[0] = fmaf(r, a.x, acc[0]);
  acc[1] = fmaf(r, a.y, acc[1]);
  acc[2] = fmaf(r, a.z, acc[2]);
  acc[3] = fmaf(r, a.w, acc[3]);
  acc[4] = fmaf(r, b.x, acc[4]);
  acc[5] = fmaf(r, b.y, acc[5]);
  acc[6] = fmaf(r, b.z, acc[6]);
  acc[7] = fmaf(r, b.w, acc[7]);
}

__device__ __forceinline__ void seg_cluster_sync(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// A scenario on a cluster of C blocks (see above). RL = 0: the strip in
// shared memory; RL > 0: lane l's rows l + 32k, k < RL (P = 32·RL), in
// registers. Built with -DADMM_SEGMENT_NO_MATVEC (a timing build of
// tools/bench_segment_streamed_torch.py, never by ops/kernels.build) a step
// skips its mat-vec and keeps the barrier, the reduction and the update.
template <int RL>
__global__ void __launch_bounds__(RL > 0 ? kSegRegMaxThreads : kSegMaxThreads)
admm_segment_cluster_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* __restrict__ xo,
    float* __restrict__ zo, float* __restrict__ yo, int P, int C,
    float sigma, float alpha, float one_minus_alpha, int length) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x % C, b = blockIdx.x / C;
  const int W = P / C, LD = W + kSegPad;
  const int col0 = rank * W + kSegCols * warp;  // the warp's first column
  const int c = col0 + (lane >> 2);             // the lane's column
  const bool writer = (lane & 3) == 0;
  const size_t v = static_cast<size_t>(b) * P + c;
  float x = x0[v], z = z0[v], y = y0[v];
  if (length <= 0) {
    if (writer) {
      xo[v] = x;
      zo[v] = z;
      yo[v] = y;
    }
    return;
  }
  float* s_rhs = dyn_smem();     // [2][P]
  float* s_k = s_rhs + 2 * P;    // [P][LD]
  const float* K = kinv + static_cast<size_t>(b) * P * P;

  float4 kr[RL > 0 ? RL : 1][2];
  if (RL > 0) {
#pragma unroll
    for (int k = 0; k < RL; ++k) {
      const float4* src = reinterpret_cast<const float4*>(
          K + static_cast<size_t>(lane + 32 * k) * P + col0);
      kr[k][0] = __ldg(src);
      kr[k][1] = __ldg(src + 1);
    }
  } else {
    const int w4 = W / 4;
    for (int e = threadIdx.x; e < P * w4; e += blockDim.x) {
      const int r = e / w4, c4 = e - r * w4;
      __pipeline_memcpy_async(s_k + r * LD + 4 * c4,
                              K + static_cast<size_t>(r) * P + rank * W +
                                  4 * c4,
                              sizeof(float4));
    }
    __pipeline_commit();
  }
  const float qc = q[v], lbc = lb[v], ubc = ub[v];
  const float rc = rho[v], ric = rhoi[v];
  // this column's rhs into buffer `buf` of every block of the cluster
  auto push = [&](int buf) {
    if (!writer) return;
    const float r = sigma * x - qc + rc * z - y;
    float* dst = s_rhs + buf * P + c;
    for (int k = 0; k < C; ++k)
      *(C == 1 ? dst : cg::this_cluster().map_shared_rank(dst, k)) = r;
  };

  seg_cluster_sync(C);  // every block runs before any writes to it
  push(0);
  if (RL == 0) __pipeline_wait_prior(0);
  seg_cluster_sync(C);
  const int rows32 = kSegNoMatvec ? 0 : P / 32;
  for (int it = 0; it < length; ++it) {
    const float* rhs = s_rhs + (it & 1) * P;
    float acc[kSegCols];
#pragma unroll
    for (int i = 0; i < kSegCols; ++i) acc[i] = 0.0f;
    if (RL > 0) {
#pragma unroll
      for (int k = 0; k < (kSegNoMatvec ? 0 : RL); ++k)
        seg_fma8(acc, rhs[lane + 32 * k], kr[k][0], kr[k][1]);
    } else {
#pragma unroll 4
      for (int k = 0; k < rows32; ++k) {
        const float4* row =
            reinterpret_cast<const float4*>(s_k + (lane + 32 * k) * LD +
                                            kSegCols * warp);
        seg_fma8(acc, rhs[lane + 32 * k], row[0], row[1]);
      }
    }
    const float xt = seg_column_sum(acc, lane);
    admm_update(xt, lbc, ubc, rc, ric, alpha, one_minus_alpha, x, z, y);
    if (it + 1 < length) {
      push((it + 1) & 1);
      seg_cluster_sync(C);
    }
  }
  if (writer) {
    xo[v] = x;
    zo[v] = z;
    yo[v] = y;
  }
}

// Iteration `it` of a spread segment (see above): block (b, s) owns the
// columns [kW·s, kW·s + kW) of scenario b. Lane l reads columns
// 4(l mod kW/4) .. +3 of rows l / (kW/4) + (32 / (kW/4))·(warp + 8m): a
// warp instruction reads whole 4·kW-byte row segments, kSpreadUnroll rows
// a thread in flight (the ragged last rows are loaded as zeros, which add
// nothing). kFirst: the state comes from x0, z0, y0 and rhs is formed from
// them; else from the outputs and rhs_in. it ≥ length (a segment of length
// 0): the state is copied alone.
template <bool kFirst, int kW>
__global__ void __launch_bounds__(kSpreadThreads) admm_segment_spread_kernel(
    const float* __restrict__ kinv, const float* __restrict__ q,
    const float* __restrict__ lb, const float* __restrict__ ub,
    const float* __restrict__ rho, const float* __restrict__ rhoi,
    const float* __restrict__ x0, const float* __restrict__ z0,
    const float* __restrict__ y0, float* xo, float* zo, float* yo,
    const float* rhs_in, float* rhs_out, int P, float sigma, float alpha,
    float one_minus_alpha, int it, int length) {
  constexpr int kLR = kW / 4;           // lanes a row segment
  constexpr int kRW = 32 / kLR;         // rows a warp instruction
  constexpr int kRows = kRW * kSpreadWarps;  // rows a block round
  __shared__ float part[kSpreadWarps][kW];
  const unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strips = P / kW;
  const int b = blockIdx.x / strips, s = blockIdx.x - b * strips;
  const size_t base = static_cast<size_t>(b) * P;
  const int c0 = s * kW;
  const float* xs = kFirst ? x0 : xo;
  const float* zs = kFirst ? z0 : zo;
  const float* ys = kFirst ? y0 : yo;
  float xt = 0.0f;
  if (it < length) {
    const int quad = lane % kLR;
    const float* K = kinv + base * P + c0 + 4 * quad;
    const int r0 = kRW * warp + lane / kLR;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int m = 0; m * kRows < P; m += kSpreadUnroll) {
      float4 kv[kSpreadUnroll];
      float rv[kSpreadUnroll];
#pragma unroll
      for (int u = 0; u < kSpreadUnroll; ++u) {
        const int i = kRows * (m + u) + r0;
        kv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        rv[u] = 0.0f;
        if (i < P) {
          kv[u] = __ldg(reinterpret_cast<const float4*>(
              K + static_cast<size_t>(i) * P));
          rv[u] = kFirst ? sigma * x0[base + i] - q[base + i] +
                               rho[base + i] * z0[base + i] - y0[base + i]
                         : rhs_in[base + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kSpreadUnroll; ++u) {
        acc[0] = fmaf(rv[u], kv[u].x, acc[0]);
        acc[1] = fmaf(rv[u], kv[u].y, acc[1]);
        acc[2] = fmaf(rv[u], kv[u].z, acc[2]);
        acc[3] = fmaf(rv[u], kv[u].w, acc[3]);
      }
    }
    // over the kRW row lanes of a column quad: two transposing steps (bits
    // 16 and 8) leave column 4·quad + l/8 in lane l, then the lanes between
    // (bits kLR .. 4) are added in
    const bool up16 = (lane & 16) != 0, up8 = (lane & 8) != 0;
    float v2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up16 ? acc[i] : acc[i + 2];
      const float keep = up16 ? acc[i + 2] : acc[i];
      v2[i] = keep + __shfl_xor_sync(kFull, send, 16);
    }
    const float send = up8 ? v2[0] : v2[1];
    const float keep = up8 ? v2[1] : v2[0];
    float sum = keep + __shfl_xor_sync(kFull, send, 8);
#pragma unroll
    for (int bit = 4; bit >= kLR; bit /= 2)
      sum += __shfl_xor_sync(kFull, sum, bit);
    if ((lane & (8 - kLR)) == 0) part[warp][4 * quad + (lane >> 3)] = sum;
    __syncthreads();
    if (warp == 0 && lane < kW)
      for (int w = 0; w < kSpreadWarps; ++w) xt += part[w][lane];
  }
  if (warp == 0 && lane < kW) {
    const size_t v = base + c0 + lane;
    float x = xs[v], z = zs[v], y = ys[v];
    if (it < length) {
      const float r = rho[v];
      admm_update(xt, lb[v], ub[v], r, rhoi[v], alpha, one_minus_alpha, x,
                  z, y);
      if (it + 1 < length) rhs_out[v] = sigma * x - q[v] + r * z - y;
    }
    xo[v] = x;
    zo[v] = z;
    yo[v] = y;
  }
}

// kernels a call of the spread route: one an iteration, one for length 0
__host__ __device__ inline int seg_spread_kernels(int length) {
  return length > 1 ? length : 1;
}

template <int kW>
cudaError_t launch_spread(int B, cudaStream_t stream, const float* kinv,
                          const float* q, const float* lb, const float* ub,
                          const float* rho, const float* rhoi,
                          const float* x0, const float* z0, const float* y0,
                          float* xo, float* zo, float* yo, float* scratch,
                          int P, float sigma, float alpha,
                          float one_minus_alpha, int length) {
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.gridDim = dim3(B * (P / kW));
  cfg.blockDim = dim3(kSpreadThreads);
  const size_t half = static_cast<size_t>(B) * P;
  const int n = seg_spread_kernels(length);
  for (int it = 0; it < n; ++it) {
    const float* in = scratch + (it & 1) * half;
    float* out = scratch + ((it + 1) & 1) * half;
    const cudaError_t err =
        it == 0 ? cudaLaunchKernelEx(&cfg, admm_segment_spread_kernel<true, kW>,
                                     kinv, q, lb, ub, rho, rhoi, x0, z0, y0,
                                     xo, zo, yo, in, out, P, sigma, alpha,
                                     one_minus_alpha, it, length)
                : cudaLaunchKernelEx(&cfg,
                                     admm_segment_spread_kernel<false, kW>,
                                     kinv, q, lb, ub, rho, rhoi, x0, z0, y0,
                                     xo, zo, yo, in, out, P, sigma, alpha,
                                     one_minus_alpha, it, length);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launches the cluster route (cluster = C, kinv_regs: K⁻¹ in registers) or,
// for cluster = 0, the spread route with strips of spread_cols = 8, 16 or
// 32 columns and its scratch of 2·B·P floats. cudaErrorInvalidValue for
// what neither takes.
inline cudaError_t launch_segment_routes(
    int B, cudaStream_t stream, const float* kinv, const float* q,
    const float* lb, const float* ub, const float* rho, const float* rhoi,
    const float* x0, const float* z0, const float* y0, float* xo, float* zo,
    float* yo, float* scratch, int P, float sigma, float alpha,
    float one_minus_alpha, int length, int cluster, int kinv_regs,
    int spread_cols) {
  if (cluster == 0) {
    if (scratch == nullptr || kinv_regs) return cudaErrorInvalidValue;
#define ADMM_SPREAD_ARGS                                                   \
  B, stream, kinv, q, lb, ub, rho, rhoi, x0, z0, y0, xo, zo, yo, scratch,  \
      P, sigma, alpha, one_minus_alpha, length
    switch (spread_cols) {
      case 8: return launch_spread<8>(ADMM_SPREAD_ARGS);
      case 16: return launch_spread<16>(ADMM_SPREAD_ARGS);
      case 32: return launch_spread<32>(ADMM_SPREAD_ARGS);
      default: return cudaErrorInvalidValue;
    }
#undef ADMM_SPREAD_ARGS
  }
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  const int regs = kinv_regs ? 1 : 0;
  if (!seg_cluster_takes(P, cluster, regs)) return cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, const float*,
                 const float*, const float*, const float*, const float*,
                 const float*, float*, float*, float*, int, int, float, float,
                 float, int) =
      regs ? admm_segment_cluster_kernel<kSegRegRows>
           : admm_segment_cluster_kernel<0>;
  const size_t smem = seg_cluster_smem_bytes(P, cluster, regs);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(32 * (P / cluster) / kSegCols);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, kinv, q, lb, ub, rho, rhoi, x0, z0,
                            y0, xo, zo, yo, P, cluster, sigma, alpha,
                            one_minus_alpha, length);
}

}  // namespace
