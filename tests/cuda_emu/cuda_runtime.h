// A CPU stand-in for the part of the CUDA runtime that the port's kernels
// use, so that their logic can be run where there is no card and no nvcc.
// A launch makes no OS thread: every CUDA thread of a cluster is a fiber on
// the caller's (x86-64), and __syncthreads(), __syncwarp() and cluster.sync()
// are one cooperative barrier. A fiber runs until it waits at a barrier or
// ends; the scheduler then resumes, in thread order, every fiber whose
// barrier has turned, so every run takes one and the same interleaving. Warp
// shuffles go through a per-warp array and distributed shared memory is a
// pointer into the peer block's buffer. It checks indexing, control flow and
// arithmetic; it knows nothing of timing, bank conflicts or races that the
// barriers do not order (its one order shows none), and a kernel that spins
// on another thread's write never ends. One launch runs at a time.
// tests/test_torch_kernels_emulated.py compiles csrc/*.cu against it with g++.
#pragma once
#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a) : x(a) {} };
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMemoryAllocation = 2
};
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
// n members: the last to arrive turns the phase and runs on, the others
// wait in the scheduler until the phase has turned
struct Barrier {
  unsigned n = 0, arrived = 0, phase = 0;
  void arrive_and_wait();
};
struct Cluster;
struct Block {
  std::vector<float4> smem;  // dynamic shared memory
  Barrier bar;
  std::vector<Barrier> warp_bar;
  std::vector<std::vector<float>> warp_buf;
  Cluster* cluster;
  int rank;
};
struct Cluster {
  std::vector<Block> blocks;
  Barrier bar;
};
struct Fiber {
  void* sp;                       // its stack pointer while it is switched out
  const Barrier* wait = nullptr;  // runnable once wait->phase != phase
  unsigned phase = 0;
  bool done = false;
};
// pushes the callee-saved registers, stores the stack pointer in *from,
// loads `to` and pops the registers that stack saved (the System V ABI
// leaves every other register to the caller)
extern "C" void emu_switch(void** from, void* to);
asm(R"(.pushsection .text.emu_switch,"axG",@progbits,emu_switch,comdat
  .globl emu_switch; .hidden emu_switch; .type emu_switch, @function
emu_switch:
  pushq %rbp; pushq %rbx; pushq %r12; pushq %r13; pushq %r14; pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15; popq %r14; popq %r13; popq %r12; popq %rbx; popq %rbp
  ret
  .size emu_switch, .-emu_switch
  .popsection)");
constexpr size_t kStack = 256 << 10;  // a fiber's stack; the kernels' locals take a few KiB
// the running fiber's CUDA thread, set by the scheduler before it resumes it
inline Block* blk;
inline int lane_id, warp_id;
inline Fiber* cur;
inline void* scheduler;      // the scheduler's stack pointer
inline void (*body)(void*);  // the kernel with its arguments
inline void* body_arg;
inline float4* block_smem() { return blk->smem.data(); }
inline void Barrier::arrive_and_wait() {
  if (++arrived == n) { arrived = 0; ++phase; return; }
  cur->wait = this;
  cur->phase = phase;
  emu_switch(&cur->sp, scheduler);
}
inline void run_fiber() {
  body(body_arg);
  cur->done = true;
  emu_switch(&cur->sp, scheduler);  // never resumed
}
}  // namespace emu

inline uint3_ threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

inline void __syncthreads() { emu::blk->bar.arrive_and_wait(); }
inline void __syncwarp() { emu::blk->warp_bar[emu::warp_id].arrive_and_wait(); }
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

// runs the grid one cluster at a time, a fiber a thread of the cluster; the
// fibers' stacks are made once per launch and run each cluster of the grid
// in turn, its shared memory NaN-filled anew in between
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
  emu::Cluster cl;
  cl.blocks.resize(C);
  cl.bar.n = C * T;
  for (unsigned r = 0; r < C; ++r) {
    auto& b = cl.blocks[r];
    b.bar.n = T;
    for (unsigned w = 0; w < (T + 31) / 32; ++w) {
      b.warp_bar.push_back({std::min(32u, T - 32 * w)});
      b.warp_buf.emplace_back(32);
    }
    b.cluster = &cl;
    b.rank = r;
  }
  auto run = [&] { kernel(static_cast<Exp>(args)...); };
  emu::body = [](void* f) { (*static_cast<decltype(run)*>(f))(); };
  emu::body_arg = &run;
  blockDim = cfg->blockDim;
  gridDim = cfg->gridDim;
  // a stack a fiber, each above a guard page that faults on an overflow
  const size_t N = C * T, page = sysconf(_SC_PAGESIZE), span = page + emu::kStack;
  char* stacks = static_cast<char*>(mmap(nullptr, N * span, PROT_READ | PROT_WRITE,
      MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
  if (stacks == MAP_FAILED) return cudaErrorMemoryAllocation;
  for (size_t i = 0; i < N; ++i) mprotect(stacks + i * span, page, PROT_NONE);
  std::vector<emu::Fiber> fibers(N);
  for (unsigned g0 = 0; g0 < G; g0 += C) {
    // NaN-filled: a read of shared memory that was never written shows
    for (auto& b : cl.blocks)
      b.smem.assign(cfg->dynamicSmemBytes / 16 + 1, float4{NAN, NAN, NAN, NAN});
    // a fresh stack returns into run_fiber: the six registers emu_switch
    // pops, its address, and a slot that keeps the ABI's 16-byte alignment
    for (size_t i = 0; i < N; ++i) {
      auto** top = reinterpret_cast<void**>(stacks + (i + 1) * span);
      top[-2] = reinterpret_cast<void*>(emu::run_fiber);
      fibers[i] = {top - 8};
    }
    for (size_t live = N; live;) {
      size_t ran = 0;
      for (size_t i = 0; i < N; ++i) {
        auto& f = fibers[i];
        if (f.done || (f.wait && f.wait->phase == f.phase)) continue;
        const unsigned r = i / T, t = i % T;
        emu::blk = &cl.blocks[r];
        emu::lane_id = t & 31;
        emu::warp_id = t >> 5;
        threadIdx.x = t;
        blockIdx.x = g0 + r;
        emu::cur = &f;
        emu::emu_switch(&emu::scheduler, f.sp);
        live -= f.done;
        ++ran;
      }
      // every live thread waits at a barrier that cannot turn
      if (!ran) { std::fputs("cuda_emu: a barrier deadlocks\n", stderr); std::abort(); }
    }
  }
  munmap(stacks, N * span);
  return cudaSuccess;
}
