// A CPU stand-in for the part of the CUDA runtime that the port's kernels
// use, so that their logic can be run where there is no card and no nvcc.
// Every CUDA thread of a cluster is an OS thread, __syncthreads() and
// cluster.sync() are std::barrier, warp shuffles go through a per-warp array
// and distributed shared memory is a pointer into the peer block's buffer.
// It checks indexing, control flow and arithmetic; it knows nothing of
// timing, bank conflicts or races that the barriers do not order.
// tests/test_torch_kernels_emulated.py compiles csrc/*.cu against it with g++.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static  // one block at a time uses a static array

using std::max;
using std::min;

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a) : x(a) {} };
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};

namespace emu {
struct Cluster;
struct Block {
  std::vector<float4> smem;  // dynamic shared memory
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::vector<float>> warp_buf;
  Cluster* cluster;
  int rank;
};
struct Cluster {
  std::vector<Block> blocks;
  std::unique_ptr<std::barrier<>> bar;
};
inline thread_local Block* blk;
inline thread_local int lane_id, warp_id;
inline float4* block_smem() { return blk->smem.data(); }
}  // namespace emu

inline thread_local uint3_ threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

inline void __syncthreads() { emu::blk->bar->arrive_and_wait(); }
inline void __syncwarp() { emu::blk->warp_bar[emu::warp_id]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int x) {
  auto& buf = emu::blk->warp_buf[emu::warp_id];
  buf[emu::lane_id] = v;
  __syncwarp();
  const float r = buf[emu::lane_id ^ x];
  __syncwarp();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  auto& buf = emu::blk->warp_buf[emu::warp_id];
  buf[emu::lane_id] = v;
  __syncwarp();
  const float r = buf[src];
  __syncwarp();
  return r;
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __frcp_rn(float a) { return 1.0f / a; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }

// runs the grid one cluster at a time, every thread of the cluster at once
template <class... Exp, class... Act>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*kernel)(Exp...), Act&&... args) {
  unsigned C = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      C = cfg->attrs[a].val.clusterDim.x;
  const unsigned T = cfg->blockDim.x, G = cfg->gridDim.x;
  if (T > 1024 || C > 8 || cfg->dynamicSmemBytes > 232448 || G % C)
    return cudaErrorInvalidValue;
  for (unsigned g0 = 0; g0 < G; g0 += C) {
    emu::Cluster cl;
    cl.blocks.resize(C);
    cl.bar = std::make_unique<std::barrier<>>(C * T);
    for (unsigned r = 0; r < C; ++r) {
      auto& b = cl.blocks[r];
      // NaN-filled: a read of shared memory that was never written shows
      b.smem.assign(cfg->dynamicSmemBytes / 16 + 1, float4{NAN, NAN, NAN, NAN});
      b.bar = std::make_unique<std::barrier<>>(T);
      for (unsigned w = 0; w < (T + 31) / 32; ++w) {
        b.warp_bar.push_back(
            std::make_unique<std::barrier<>>(std::min(32u, T - 32 * w)));
        b.warp_buf.emplace_back(32);
      }
      b.cluster = &cl;
      b.rank = r;
    }
    std::vector<std::thread> threads;
    for (unsigned r = 0; r < C; ++r)
      for (unsigned t = 0; t < T; ++t)
        threads.emplace_back([&, r, t]() {
          emu::blk = &cl.blocks[r];
          emu::lane_id = t & 31;
          emu::warp_id = t >> 5;
          threadIdx.x = t;
          blockIdx.x = g0 + r;
          blockDim = cfg->blockDim;
          gridDim = cfg->gridDim;
          kernel(static_cast<Exp>(args)...);
        });
    for (auto& t : threads) t.join();
  }
  return cudaSuccess;
}
