// woodbury_ns — (K(ρ_new))⁻¹ from (K(ρ_old))⁻¹: rank-n_box Woodbury update
// with a Gauss–Jordan capacitance inverse, n_ns Newton–Schulz steps,
// symmetrised output. Two tuned routes (P = 128 and P = 256, n_box ≤ 128)
// keep every intermediate in shared memory and registers; a scenario runs on
// one thread block or on a cluster of 8 blocks that read each other's strips
// through distributed shared memory. The general route takes every other
// shape, any P a multiple of 128 (see its section below).
//
// Replaces the TPU kernel ironcub_mpc_tpu/ops/pallas_solve.py
// `woodbury_ns` (body `_woodbury_kernel`). It computes the same function,
// not the same blocks: the TPU kernel embeds and extracts the box through
// 0/1 selector matmuls because Mosaic cannot slice lanes at unaligned
// offsets; here the box is indexed directly. With X₀ = K⁻¹(ρ_old) [P, P],
// d = ρ_new − ρ_old and the box rows/cols [box0, box0 + n):
//   1. M = I + diag(d_box)·X₀[box, box];  G = M⁻¹ by Gauss–Jordan, no
//      pivoting, |pivot| < 1e-12 clamped to ∓1e-12 (+1e-12 for 0)
//   2. U = −(X₀[:, box]·G)·diag(d_box);  X = X₀ + U·X₀[box, :]
//   3. n_ns times: T = K·X with K = H + σI + diag(ρ_new), X ← 2X − X·T
//   4. out = ½(X + Xᵀ)
//
// What bounds it on an H100: operations when n_ns ≥ 1 (two P³ products a
// step, 8.4 MFLOP a scenario against 192 KB moved at P = 128), bytes when
// n_ns = 0 and n_box is small (the polish operator: K⁻¹ in, the result out).
// Plain fp32 FMA on CUDA cores, no TF32. What the design does:
//
// - A cluster of C blocks (256 threads each) owns one scenario; block `rank`
//   keeps rows [rank·R, (rank+1)·R), R = P/C, of X and of T in its shared
//   memory from the load of X₀ to the store of the result. No scratch in
//   device memory. Built for P = 128 with C = 1 (all of X, T and K on one
//   SM) and C = 8 (a lone scenario draws on 8 SMs), and for P = 256 with
//   C = 8, the only way its matrices fit. The B operand of a product is a
//   whole matrix: at C = 1 it is the resident matrix itself; at C > 1 every
//   block first gathers rows of it from their owners
//   (cluster.map_shared_rank, eight 16-byte loads in flight a thread) into a
//   buffer of its own, all [P, P] at once at P = 128 and one strip [R, P]
//   after the other at P = 256, so that the product's inner loop reads local
//   shared memory only. cluster.sync() (__syncthreads() at C = 1) orders the
//   stages.
// - Products are strip products OUT[R, P] = A[R, depth]·B[depth, P]. The
//   threads form a 16 × 16 grid; thread (ty, tx) accumulates rows
//   ty·TM .. ty·TM + TM − 1 (TM = R/16) times, in every panel of 128 columns,
//   columns 4tx..4tx+3 and 64+4tx..64+4tx+3 in registers (8 × 8 at P = 128,
//   C = 1), reading A as one float4 along the depth per row and B as two
//   float4 per depth step, conflict-free or broadcast. A product's result is
//   held in registers until every reader of the strip it replaces has passed
//   a barrier, so X is updated in place.
// - K's strip is brought in with cp.async while the Woodbury products run
//   (as soon as X₀ is in where the shared memory holds it beside U, else as
//   soon as U is dead); σ + ρ go onto its diagonal in shared memory. K is
//   never stored.
// - Gauss–Jordan runs in place on the n × n matrix (n ≤ 128): column i of the
//   in-place form is the inverse's, the entries of [M | I]'s right half, with
//   the same elimination order and clamp. For n ≤ 32 a thread holds four
//   entries of one column in registers, mirrored in shared memory: a pivot
//   step is two shared reads, four shuffles, a reciprocal and four FMAs a
//   thread, and one __syncthreads(). For larger n the 256 threads hold 8 × 8
//   each in registers, interleaved so that the pivot's place in a tile is a
//   compile-time index; a step's pivot row and column go through a
//   double-buffered shared array, one __syncthreads() a pivot. Every block of
//   a cluster inverts M itself (the matrix is small; the products are what
//   is split).
// - ½(X + Xᵀ) is taken on tiles 32 columns wide read along skewed diagonals,
//   so that the transposed reads hit different banks: in place at C = 1; at
//   C > 1 each block reads the mirror entries of its strip straight from
//   their owners (every entry once), holds the means in registers until
//   every block has read, and writes them over its strip. The result is
//   stored with coalesced 16-byte writes.
//
// Shared memory per block (floats), mirrored by ops/kernels.woodbury_smem_bytes:
//   X [R, P] | G [n8, P] then T [R, P] | U [R, n4] | K strip [R, P] (aliases
//   U when both do not fit) | pivot arrays [4, 128] and d [128] | at C > 1
//   the gathered operand [P, P] (P = 128) or [R, P] (P = 256)
// with n8, n4 = n rounded up to 8, 4; T and the K strip only for n_ns > 0.
//
// The general route (any P a multiple of 128, any box; ops/kernels
// .woodbury_plan sends it the shapes the tuned routes do not take, such as a
// control horizon of 13 with joint limits: P = 256, n_box 132). It replaces
// the same TPU kernel, ironcub_mpc_tpu/ops/pallas_solve.py:276
// (`woodbury_ns`, body `_woodbury_kernel` at :200), in the rank-n form of
// the plain twin ops/kernels.woodbury_ns_plain, in 4 + 2·n_ns launches a
// call (one call of the wrapper) over a per-scenario device scratch that the
// wrapper allocates on the launch's stream (G [n, n32] with its rows padded
// to 32, then W [n, P], or two [P, P] buffers with Newton–Schulz steps; the
// last X lands in the output):
//
// 1. The elimination G = M⁻¹, M = I + d_box ⊙ X₀[box, box]: n steps, each
//    a barrier after n² updates. Bound by the latency of a step, not by
//    bytes or operations (2n³ is 0.07 µs of an H100 at n = 132): on one SM
//    the previous design's 132 steps took most of its 1.07 ms at n = 132,
//    and at n = 528 its matrix left shared memory. So the rows are spread
//    over a cluster of up to 8 blocks, each holding its strip in its
//    shared memory (M up to n = 672; beyond, the strips stay in the
//    scratch, the same cluster eliminating them); a step ends on one
//    cluster barrier, and the warp that finishes the next pivot row divides
//    it by its pivot once and writes it into every block's shared memory
//    (distributed shared memory) before that barrier, so that no block
//    waits on a remote read. What is left is the barrier and that warp's
//    row, ~1.4 µs a step on an H100 (PERF.md); the plan spreads a lone
//    scenario over 8 blocks and a batch over as many as keep two blocks an
//    SM.
// 2. The products W = G·(d_box ⊙ X₀[box, :]) [n, P], X = X₀ − X₀[:, box]·W,
//    and per Newton–Schulz step F = 2I − K·X, X ← X·F: 2n²P + 2P²n + 4P³
//    operations, bound by operations (float32 FMA on the CUDA cores; no
//    TF32, no library GEMM). Each is a launch over (scenario, output tile)
//    with T × T tiles, T = 32 where B · (P / 64)² blocks of 64 would not
//    fill the card's 132 SMs (64 blocks at P = 256, B = 1) and 64 beyond:
//    8 × 16 threads, 4 × 2 or 8 × 4 outputs a thread, 32-deep stages of A
//    and B copied with cp.async and double-buffered. K = H + σI + diag(ρ)
//    is formed on A's diagonal as a stage lands and never stored, and so is
//    d_box ⊙ X₀[box, :] in B's rows.
// 3. out = ½(X + Xᵀ): bound by bytes (P² in, P² out); pairs of mirror
//    32 × 32 tiles through shared memory, coalesced both ways.
//
// Every entry keeps the plain version's rounding step for step, and the
// previous design's association: the elimination divides by the clamped
// pivot and subtracts a rounded product; each product entry is one fmaf
// chain over the whole depth in ascending order, from 0. So K is not split
// (a split sum would round otherwise, and the card's 1e-5 and the
// emulator's 2e-6 with exact symmetry hold as before). The stages meet at
// kernel boundaries, not at a grid-wide barrier: a cooperative kernel's
// grid.sync() would deadlock the CPU stand-in of tests/cuda_emu, which runs
// a grid one cluster at a time, and the route's logic would lose its only
// test off the card. No padded size is refused: device memory caps P (the
// scratch's 8·P² bytes a scenario beside the 12·P² of K⁻¹, H and the
// result; every index into a matrix is a size_t product).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kLane = 128;     // columns of a panel; the widest box
constexpr int kThreads = 256;  // 16 x 16 grid of register tiles
constexpr int kMaxSmem = 232448;
constexpr int kVecFloats = 5 * kLane;  // pivot rows/cols [2][2][128], d [128]

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 dyn_smem_f4[];
  return reinterpret_cast<float*>(dyn_smem_f4);
}

// rows of the gathered operand a block of a cluster holds at a time
__host__ __device__ constexpr int gathered_rows(int P, int C) {
  return C == 1 ? 0 : P == kLane ? P : P / C;
}

struct Layout {
  int g, u, h, vec, full, total;  // offsets in floats; X is at 0
  bool early_h;                   // the K strip has room of its own
};

__host__ __device__ inline Layout make_layout(int P, int n, int n_ns, int C) {
  const int R = P / C;
  const int n8 = (n + 7) / 8 * 8, n4 = (n + 3) / 4 * 4;
  const int gt = (n_ns > 0 && R > n8 ? R : n8) * P;
  const int u = R * n4;
  const int h = n_ns > 0 ? R * P : 0;
  const int full = gathered_rows(P, C) * P;
  Layout L;
  L.g = R * P;
  L.u = L.g + gt;
  L.early_h = 4 * (L.u + u + h + kVecFloats + full) <= kMaxSmem;
  L.h = L.early_h ? L.u + u : L.u;
  L.vec = L.early_h ? L.h + h : L.u + (u > h ? u : h);
  L.full = L.vec + kVecFloats;
  L.total = L.full + full;
  return L;
}

// acc[i][:] += A[row i, k..k+3] · B[k..k+3, cols] for the thread's TM rows
// and its columns 4tx..4tx+3 and, for W = 8, 64+4tx..64+4tx+3 of one panel
// (W = 4 where B has nothing beyond column 64); a[i] holds the four depth
// steps of row i, b points at row k of B's panel (row stride P)
template <int P, int TM, int W>
__device__ __forceinline__ void fma4(float (&acc)[TM][W], const float4 (&a)[TM],
                                     const float* b, int tx) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 b0 = *reinterpret_cast<const float4*>(b + kk * P + 4 * tx);
    float4 b1 = b0;
    if (W == 8)
      b1 = *reinterpret_cast<const float4*>(b + kk * P + 64 + 4 * tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float av = reinterpret_cast<const float*>(&a[i])[kk];
      acc[i][0] = fmaf(av, b0.x, acc[i][0]);
      acc[i][1] = fmaf(av, b0.y, acc[i][1]);
      acc[i][2] = fmaf(av, b0.z, acc[i][2]);
      acc[i][3] = fmaf(av, b0.w, acc[i][3]);
      if (W == 8) {
        acc[i][W - 4] = fmaf(av, b1.x, acc[i][W - 4]);
        acc[i][W - 3] = fmaf(av, b1.y, acc[i][W - 3]);
        acc[i][W - 2] = fmaf(av, b1.z, acc[i][W - 2]);
        acc[i][W - 1] = fmaf(av, b1.w, acc[i][W - 1]);
      }
    }
  }
}

// one depth step, A read as scalars (any alignment)
template <int TM, int W>
__device__ __forceinline__ void fma1(float (&acc)[TM][W], const float* a,
                                     int lda, const float* brow, int tx) {
  const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tx);
  float4 b1 = b0;
  if (W == 8) b1 = *reinterpret_cast<const float4*>(brow + 64 + 4 * tx);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float av = a[i * lda];
    acc[i][0] = fmaf(av, b0.x, acc[i][0]);
    acc[i][1] = fmaf(av, b0.y, acc[i][1]);
    acc[i][2] = fmaf(av, b0.z, acc[i][2]);
    acc[i][3] = fmaf(av, b0.w, acc[i][3]);
    if (W == 8) {
      acc[i][W - 4] = fmaf(av, b1.x, acc[i][W - 4]);
      acc[i][W - 3] = fmaf(av, b1.y, acc[i][W - 3]);
      acc[i][W - 2] = fmaf(av, b1.z, acc[i][W - 2]);
      acc[i][W - 1] = fmaf(av, b1.w, acc[i][W - 1]);
    }
  }
}

// acc += A[strip rows, 0..depth) · B[0..depth, one panel], both in this
// block's shared memory: A row-major with leading dimension lda, B with row
// stride P. `vec` says that A's rows are 16-byte aligned: then the first
// depth & ~3 steps read A as float4, the rest (or all) as scalars.
template <int P, int TM, int W>
__device__ __forceinline__ void strip_product(float (&acc)[TM][W],
                                              const float* a, int lda,
                                              const float* b, int depth,
                                              bool vec, int tx) {
  const int nv = vec ? depth & ~3 : 0;
#pragma unroll 2
  for (int k = 0; k < nv; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
    fma4<P, TM, W>(acc, av, b + k * P, tx);
  }
  for (int k = nv; k < depth; ++k)
    fma1<TM, W>(acc, a + k, lda, b + k * P, tx);
}

template <int C>
__device__ __forceinline__ void stage_sync() {
  if (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// Rows [row0, row0 + rows) of a matrix whose row strips of R = P/C lie at
// `off` in the shared memory of the cluster's blocks, as a local array with
// row stride P. At C = 1 that is the matrix itself; at C > 1 the rows are
// copied from their owners into `full` (eight loads in flight a thread) and
// the block is synchronised.
template <int P, int C>
__device__ __forceinline__ const float* gather_rows(float* smem, int off,
                                                    int row0, int rows,
                                                    float* full, int tid) {
  if (C == 1) return smem + off + row0 * P;
  constexpr int R = P / C;
  cg::cluster_group cluster = cg::this_cluster();
  const int total = rows * (P / 4);
  for (int base = 0; base < total; base += 8 * kThreads) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * kThreads + tid;
      if (e < total) {
        const int r = row0 + e / (P / 4);
        const float* src = cluster.map_shared_rank(smem + off, r / R) +
                           (r % R) * P + 4 * (e % (P / 4));
        v[u] = *reinterpret_cast<const float4*>(src);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * kThreads + tid;
      if (e < total) *reinterpret_cast<float4*>(full + 4 * e) = v[u];
    }
  }
  __syncthreads();
  return full;
}

// acc += A[strip rows, 0..depth) · M[row0 .. row0 + depth, :] over every
// panel, M a matrix whose row strips lie at `off` in the cluster's blocks:
// its rows are gathered as many at a time as the gathered operand holds.
// `a` is the thread's first row of A; depth steps are taken four at a time.
template <int P, int C, int TM>
__device__ __forceinline__ void cluster_product(float (&acc)[P / kLane][TM][8],
                                                const float* a, int lda,
                                                float* smem, int off, int row0,
                                                int depth, float* full,
                                                int tid, int tx) {
  constexpr int kChunk = C == 1 ? P : gathered_rows(P, C);
  for (int k0 = 0; k0 < depth; k0 += kChunk) {
    const int rows = min(kChunk, depth - k0);
    const float* b = gather_rows<P, C>(smem, off, row0 + k0, rows, full, tid);
#pragma unroll
    for (int p = 0; p < P / kLane; ++p)
      strip_product<P, TM, 8>(acc[p], a + k0, lda, b + kLane * p, rows, true,
                              tx);
    if (C > 1 && k0 + kChunk < depth) __syncthreads();  // `full` is refilled
  }
}

// this block's strip of a [B, P, P] array into shared memory, 16 bytes a copy
__device__ __forceinline__ void copy_strip_async(float* dst, const float* src,
                                                 int floats, int tid) {
  for (int e = tid; e < floats / 4; e += kThreads)
    __pipeline_memcpy_async(dst + 4 * e, src + 4 * e, 16);
  __pipeline_commit();
}

template <int P, int TM>
__device__ __forceinline__ void store_tile(float* strip,
                                           const float (&acc)[P / kLane][TM][8],
                                           int ty, int tx, float scale) {
#pragma unroll
  for (int p = 0; p < P / kLane; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float* row = strip + (ty * TM + i) * P + kLane * p;
      const float(&v)[8] = acc[p][i];
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(scale * v[0], scale * v[1], scale * v[2], scale * v[3]);
      *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
          make_float4(scale * v[4], scale * v[5], scale * v[6], scale * v[7]);
    }
}

template <int P, int TM>
__device__ __forceinline__ void load_tile(float (&acc)[P / kLane][TM][8],
                                          const float* strip, int ty, int tx,
                                          float scale) {
#pragma unroll
  for (int p = 0; p < P / kLane; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float* row = strip + (ty * TM + i) * P + kLane * p;
      const float4 lo = *reinterpret_cast<const float4*>(row + 4 * tx);
      const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * tx);
      float(&v)[8] = acc[p][i];
      v[0] = scale * lo.x; v[1] = scale * lo.y;
      v[2] = scale * lo.z; v[3] = scale * lo.w;
      v[4] = scale * hi.x; v[5] = scale * hi.y;
      v[6] = scale * hi.z; v[7] = scale * hi.w;
    }
}

template <int N, int TM, int W>
__device__ __forceinline__ void zero_tile(float (&acc)[N][TM][W]) {
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jc = 0; jc < W; ++jc) acc[p][i][jc] = 0.0f;
}

// U[strip, :] = −(X₀[strip, box]·G)·diag(d_box) for the columns [0, n4) that
// fall into the thread's W columns (W = 4: n4 ≤ 64, the upper column half of
// G is zero and is left out; n ≤ 128, so G has one panel). float4 reads of
// X₀'s box columns need the box to start on a 16-byte boundary.
template <int P, int TM, int W>
__device__ __forceinline__ void make_u(float* sU, const float* xbox,
                                       const float* sG, const float* sD, int n,
                                       int n4, bool aligned, int ty, int tx) {
  float acc[1][TM][W];
  zero_tile<1, TM, W>(acc);
  strip_product<P, TM, W>(acc[0], xbox, P, sG, n, aligned, tx);
#pragma unroll
  for (int half = 0; half < W / 4; ++half) {
    const int c0 = 64 * half + 4 * tx;
    if (c0 < n4) {
      const float4 dv = *reinterpret_cast<const float4*>(sD + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(sU + (ty * TM + i) * n4 + c0) = make_float4(
            -acc[0][i][4 * half] * dv.x, -acc[0][i][4 * half + 1] * dv.y,
            -acc[0][i][4 * half + 2] * dv.z, -acc[0][i][4 * half + 3] * dv.w);
    }
  }
}

// M[r, c] = δ_rc + d_box[r]·X₀[box, box][r, c], the identity outside n × n.
// The product is rounded before the sum, as the plain version does: a fused
// form could land on the other side of the pivot clamp. The loads are made
// unconditionally (at clamped indices) so that a thread's loads overlap.
template <int P>
__device__ __forceinline__ float capacitance(const float* __restrict__ Ki,
                                             const float* __restrict__ d,
                                             int box0, int n, int r, int c) {
  const int rr = box0 + min(r, n - 1), cc = box0 + min(c, n - 1);
  const float prod = __fmul_rn(d[rr], Ki[rr * P + cc]);
  return (r == c ? 1.0f : 0.0f) + (r < n && c < n ? prod : 0.0f);
}

__device__ __forceinline__ float clamp_pivot(float piv) {
  if (fabsf(piv) < 1e-12f) piv = piv < 0.0f ? -1e-12f : 1e-12f;
  return piv;
}

// G = M⁻¹ into sG as [n8, P], zero outside n × n, by all 256 threads: any
// n ≤ 128. The matrix lives in registers, 8 × 8 per thread, interleaved:
// thread (ty, tx) holds rows ty + 16j and columns tx + 16jc, so pivot
// i = 16·jb + o is row jb of the tiles of thread row o and column jb of the
// tiles of thread column o, a compile-time register index in a loop over jb
// that is unrolled. The pivot arrays are thread-major: entry o + 16·jb of a
// row or column lies at 8·o + jb.
template <int P>
__device__ __forceinline__ void load_block(float (&g)[8][8],
                                           const float* __restrict__ Ki,
                                           const float* __restrict__ d,
                                           int box0, int n, int tid) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int jc = 0; jc < 8; ++jc)
      g[j][jc] = capacitance<P>(Ki, d, box0, n, ty + 16 * j, tx + 16 * jc);
}

template <int P>
__device__ void gauss_jordan_block(float (&g)[8][8], int n, float* sG,
                                   float* sPiv, int tid) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
#pragma unroll 1
    for (int o = 0; o < 16; ++o) {
      const int i = 16 * jb + o;
      if (i >= n) break;
      float* prow = sPiv + (i & 1) * kLane;
      float* pcol = sPiv + (2 + (i & 1)) * kLane;
      if (ty == o) {
        *reinterpret_cast<float4*>(prow + 8 * tx) =
            make_float4(g[jb][0], g[jb][1], g[jb][2], g[jb][3]);
        *reinterpret_cast<float4*>(prow + 8 * tx + 4) =
            make_float4(g[jb][4], g[jb][5], g[jb][6], g[jb][7]);
      }
      if (tx == o) {
        *reinterpret_cast<float4*>(pcol + 8 * ty) =
            make_float4(g[0][jb], g[1][jb], g[2][jb], g[3][jb]);
        *reinterpret_cast<float4*>(pcol + 8 * ty + 4) =
            make_float4(g[4][jb], g[5][jb], g[6][jb], g[7][jb]);
      }
      __syncthreads();
      const float rp = __frcp_rn(clamp_pivot(prow[8 * o + jb]));
      float rv[8], cv[8];
      {
        const float4 lo = *reinterpret_cast<const float4*>(prow + 8 * tx);
        const float4 hi = *reinterpret_cast<const float4*>(prow + 8 * tx + 4);
        rv[0] = lo.x * rp; rv[1] = lo.y * rp; rv[2] = lo.z * rp; rv[3] = lo.w * rp;
        rv[4] = hi.x * rp; rv[5] = hi.y * rp; rv[6] = hi.z * rp; rv[7] = hi.w * rp;
        const float4 c0 = *reinterpret_cast<const float4*>(pcol + 8 * ty);
        const float4 c1 = *reinterpret_cast<const float4*>(pcol + 8 * ty + 4);
        cv[0] = c0.x; cv[1] = c0.y; cv[2] = c0.z; cv[3] = c0.w;
        cv[4] = c1.x; cv[5] = c1.y; cv[6] = c1.z; cv[7] = c1.w;
      }
      // column i takes the place of [M | I]'s right-half column i: zero
      // before the step, and the scaled pivot row carries 1/pivot there
      if (tx == o) {
        rv[jb] = rp;
#pragma unroll
        for (int j = 0; j < 8; ++j) g[j][jb] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int jc = 0; jc < 8; ++jc)
          g[j][jc] = fmaf(-cv[j], rv[jc], g[j][jc]);
      if (ty == o) {
#pragma unroll
        for (int jc = 0; jc < 8; ++jc) g[jb][jc] = rv[jc];
      }
    }
  }
  const int n8 = (n + 7) / 8 * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = ty + 16 * j;
    if (r < n8) {
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        const int c = tx + 16 * jc;
        sG[r * P + c] = (r < n && c < n) ? g[j][jc] : 0.0f;
      }
    }
  }
}

// The same for n ≤ 32, where a pivot step is too little work to pay for its
// latency: the 8 warps hold the matrix (padded to 32 × 32 with the identity)
// four rows each in registers, lane c the entries of column c, and mirror it
// in the first 64 columns of sG, double-buffered. A step reads the pivot and
// its own entry of the pivot row from the mirror, takes the pivot column's
// entries of its rows from lane i by shuffles, scales, and writes its four
// new entries to the other half of the mirror: one __syncthreads() a pivot
// and some 35 instructions a thread. Rows from n8 on are the identity, take
// no part and are not stored (sG has n8 rows).
template <int P>
__device__ __forceinline__ void load_small(float (&g)[4],
                                           const float* __restrict__ Ki,
                                           const float* __restrict__ d,
                                           int box0, int n, int tid) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
    g[a] = capacitance<P>(Ki, d, box0, n, 4 * (tid >> 5) + a, tid & 31);
}

template <int P>
__device__ void gauss_jordan_small(float (&g)[4], int n, float* sG, int tid) {
  const unsigned kFull = 0xffffffffu;
  const int lane = tid & 31, row0 = 4 * (tid >> 5);
  const int n8 = (n + 7) / 8 * 8;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (row0 + a < n8) sG[(row0 + a) * P + lane] = g[a];
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    const float* cur = sG + 32 * (i & 1);
    float* nxt = sG + 32 * ((i + 1) & 1);
    const float piv = cur[i * P + i];
    const float own = cur[i * P + lane];
    float cv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = __shfl_sync(kFull, g[a], i);
    const bool pivot_lane = lane == i;
    const float rv = (pivot_lane ? 1.0f : own) * __frcp_rn(clamp_pivot(piv));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float base = pivot_lane ? 0.0f : g[a];
      g[a] = row0 + a == i ? rv : fmaf(-cv[a], rv, base);
      if (row0 + a < n8) nxt[(row0 + a) * P + lane] = g[a];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + a;
    if (r < n8) {
      sG[r * P + lane] = (r < n && lane < n) ? g[a] : 0.0f;
      sG[r * P + 32 + lane] = 0.0f;
      sG[r * P + 64 + lane] = 0.0f;
      sG[r * P + 96 + lane] = 0.0f;
    }
  }
}

// ½(X + Xᵀ) in place on a resident X (C = 1). For a pair of 32 × 32 tiles
// (I, J), I ≤ J, lane l at skew s takes the entry (row (l + s) mod 32,
// column l) of tile (I, J) and its mirror in tile (J, I): both reads and
// both writes of a warp hit 32 different banks. The skews are dealt to the
// warps; an off-diagonal pair takes all 32, a diagonal tile the skews 1..16,
// which cover every pair once (s = 16 by the lower half of the lanes).
template <int P>
__device__ __forceinline__ void mean_with_mirror(float* X, int I, int J, int s,
                                                 int lane) {
  float* prc = X + (32 * I + ((lane + s) & 31)) * P + 32 * J + lane;
  float* pcr = X + (32 * J + lane) * P + 32 * I + ((lane + s) & 31);
  const float v = 0.5f * (*prc + *pcr);
  *prc = v;
  *pcr = v;
}

template <int P>
__device__ void symmetrise_in_place(float* X, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr int kTiles = P / 32;
#pragma unroll
  for (int I = 0; I < kTiles; ++I) {
#pragma unroll
    for (int J = I + 1; J < kTiles; ++J) {
#pragma unroll
      for (int q = 0; q < 32 / kWarps; ++q)
        mean_with_mirror<P>(X, I, J, warp + q * kWarps, lane);
    }
#pragma unroll
    for (int q = 0; q < 16 / kWarps; ++q) {
      const int s = 1 + warp + q * kWarps;
      if (s < 16 || lane < 16) mean_with_mirror<P>(X, I, I, s, lane);
    }
  }
}

// The same for a strip of R = P/C rows (C > 1; R is 16 or 32). Lane l at
// skew s takes row (l + s) mod R of the strip and column 32J + l: its own
// entry from this block's strip, the mirror entry X[c, r] from the strip of
// block c / R. Lanes that share a row read from different blocks, so no two
// reads of a warp meet in a bank. The means wait in registers until every
// block has read, then go over the strip.
template <int P, int C>
__device__ void symmetrise_strip(float* smem, int rank, int tid) {
  constexpr int R = P / C;
  constexpr int kWarps = kThreads / 32;
  const int lane = tid & 31, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  float v[P / 32][R / kWarps];
#pragma unroll
  for (int J = 0; J < P / 32; ++J) {
    const int c = 32 * J + lane;
    const float* peer = cluster.map_shared_rank(smem, c / R) + (c % R) * P;
#pragma unroll
    for (int q = 0; q < R / kWarps; ++q) {
      const int r = (lane + warp + q * kWarps) % R;
      v[J][q] = 0.5f * (smem[r * P + c] + peer[rank * R + r]);
    }
  }
  cluster.sync();
#pragma unroll
  for (int J = 0; J < P / 32; ++J)
#pragma unroll
    for (int q = 0; q < R / kWarps; ++q)
      smem[((lane + warp + q * kWarps) % R) * P + 32 * J + lane] = v[J][q];
}

template <int P, int C>
__global__ void __launch_bounds__(kThreads, 1)
woodbury_ns_kernel(const float* __restrict__ kinv, const float* __restrict__ h,
                   const float* __restrict__ dvec, const float* __restrict__ rho,
                   float* __restrict__ out, int box0, int n, float sigma,
                   int n_ns) {
  constexpr int R = P / C;
  constexpr int TM = R / 16;
  constexpr int NP = P / kLane;
  float* smem = dyn_smem();
  const Layout L = make_layout(P, n, n_ns, C);
  float* sX = smem;
  float* sG = smem + L.g;   // G, then the strip of −T
  float* sU = smem + L.u;
  float* sH = smem + L.h;
  float* sPiv = smem + L.vec;
  float* sD = sPiv + 4 * kLane;
  float* sFull = smem + L.full;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int rank = C == 1 ? 0 : static_cast<int>(blockIdx.x % C);
  const int b = blockIdx.x / C;
  const size_t PP = static_cast<size_t>(P) * P;
  const float* Ki = kinv + b * PP;
  const float* Hb = h + b * PP;
  const float* d = dvec + static_cast<size_t>(b) * P;
  const float* rh = rho + static_cast<size_t>(b) * P;
  const int n4 = (n + 3) / 4 * 4;
  float* xrow = sX + ty * TM * P;  // this thread's first row of the strip

  // 1. G = M⁻¹. The few loads the elimination waits for are started before
  // the bulk copy of this block's strip of X₀, which arrives while the
  // pivots run. K's strip follows only when X₀ is in, so that on a full card
  // the two do not share the memory rate while the block can do nothing but
  // wait for X₀; it arrives during the Woodbury products.
  if (tid < kLane) sD[tid] = tid < n ? d[box0 + tid] : 0.0f;
  if (n <= 32) {
    float g[4];
    load_small<P>(g, Ki, d, box0, n, tid);
    copy_strip_async(sX, Ki + rank * R * P, R * P, tid);
    gauss_jordan_small<P>(g, n, sG, tid);
  } else {
    float g[8][8];
    load_block<P>(g, Ki, d, box0, n, tid);
    copy_strip_async(sX, Ki + rank * R * P, R * P, tid);
    gauss_jordan_block<P>(g, n, sG, sPiv, tid);
  }
  __pipeline_wait_prior(0);
  if (n_ns > 0 && L.early_h)
    copy_strip_async(sH, Hb + rank * R * P, R * P, tid);
  stage_sync<C>();  // G, d and every block's strip of X₀ are in place

  // 2a. U = −(X₀[strip, box]·G)·diag(d_box), columns [0, n4)
  if (n4 <= 64) {
    make_u<P, TM, 4>(sU, xrow + box0, sG, sD, n, n4, box0 % 4 == 0, ty, tx);
  } else {
    make_u<P, TM, 8>(sU, xrow + box0, sG, sD, n, n4, box0 % 4 == 0, ty, tx);
  }
  __syncthreads();

  // 2b. X = X₀ + U·X₀[box, :], written over the strip of X₀ once every block
  // has read the rows it needs
  {
    float acc[NP][TM][8];
    load_tile<P, TM>(acc, sX, ty, tx, 1.0f);
    cluster_product<P, C, TM>(acc, sU + ty * TM * n4, n4, smem, 0, box0, n,
                              sFull, tid, tx);
    stage_sync<C>();
    store_tile<P, TM>(sX, acc, ty, tx, 1.0f);
  }
  if (n_ns > 0) {
    if (!L.early_h) copy_strip_async(sH, Hb + rank * R * P, R * P, tid);
    __pipeline_wait_prior(0);
    __syncthreads();
    // K = H + σI + diag(ρ_new) on the strip's part of the diagonal
    if (tid < R) {
      const int r = rank * R + tid;
      sH[tid * P + r] = sH[tid * P + r] + sigma + rh[r];
    }
  }
  stage_sync<C>();  // X is whole in the cluster; K's strip is in place

  // 3. Newton–Schulz
  for (int s = 0; s < n_ns; ++s) {
    float acc[NP][TM][8];
    zero_tile<NP, TM, 8>(acc);
    cluster_product<P, C, TM>(acc, sH + ty * TM * P, P, smem, 0, 0, P, sFull,
                              tid, tx);
    store_tile<P, TM>(sG, acc, ty, tx, -1.0f);            // −T
    stage_sync<C>();  // T is whole; every block is done with the gathered X
    load_tile<P, TM>(acc, sX, ty, tx, 2.0f);              // 2X − X·T
    cluster_product<P, C, TM>(acc, xrow, P, smem, L.g, 0, P, sFull, tid, tx);
    __syncthreads();  // this block is done reading its strip of X
    store_tile<P, TM>(sX, acc, ty, tx, 1.0f);
    stage_sync<C>();  // X is whole; every block is done with the gathered T
  }

  // 4. out = ½(X + Xᵀ)
  if (C == 1) {
    symmetrise_in_place<P>(sX, tid);
  } else {
    symmetrise_strip<P, C>(sX, rank, tid);
  }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + b * PP + rank * R * P);
  const float4* src = reinterpret_cast<const float4*>(sX);
  for (int e = tid; e < R * (P / 4); e += kThreads) o[e] = src[e];
}

template <int P, int C>
cudaError_t launch(const float* kinv, const float* h, const float* d,
                   const float* rho, float* out, int B, int box0, int n_box,
                   float sigma, int n_ns, cudaStream_t stream) {
  const size_t smem = sizeof(float) * make_layout(P, n_box, n_ns, C).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      woodbury_ns_kernel<P, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, woodbury_ns_kernel<P, C>, kinv, h, d, rho,
                            out, box0, n_box, sigma, n_ns);
}

// ---------------------------------------------------------------------------
// The general route: every shape the two tuned routes above do not take
// ---------------------------------------------------------------------------

constexpr int kGenThreads = 128;  // a product block: 8 × 16 register tiles
constexpr int kGenDepth = 32;     // depth of one staged pair of tiles
constexpr int kGenPad = 4;        // floats after each row of a staged A tile
constexpr int kGjThreads = 256;   // an elimination block
constexpr int kGjGroup = 8;       // its chunks of 32 columns loaded at once
constexpr int kSymTile = 32;      // the symmetrisation: 32 × 32 tiles,
constexpr int kSymRows = 8;       // 32 × 8 threads

enum Epilogue { kStore = 0, kSubFromBase = 1, kTwoIMinus = 2 };
enum Prologue { kPlain = 0, kScaleB = 1, kKFromH = 2 };

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// floats of one stage of a product block: A [T, depth + pad], B [depth, T]
__host__ __device__ constexpr int gen_stage_floats(int T) {
  return T * (kGenDepth + kGenPad) + kGenDepth * T;
}

// shared memory (floats) of one elimination block of a cluster of C: the
// scaled pivot row, double-buffered [2][n32], the pivot column's entries of
// the strip [2][R4] and, where it lives there, the strip of M itself
// [R, n32]; R = ⌈n / C⌉ rows a block, n32 = n rounded up to 32
__host__ __device__ inline long gj_smem_floats(int n, int C, bool in_smem) {
  const int R = (n + C - 1) / C;
  return 2L * round32(n) + 2L * round4(R) +
         (in_smem ? static_cast<long>(R) * round32(n) : 0L);
}

// device scratch of one scenario: G [n, n32] (its rows padded to 32), then
// W [n, P] for n_ns = 0, or two [P, P] buffers for n_ns > 0 (W and later
// 2I − K·X in the first, the X that is not in the output in the second)
__host__ __device__ inline long general_g_floats(int n) {
  return static_cast<long>(n) * round32(n);
}

__host__ __device__ inline long general_scratch_floats(int P, int n, int n_ns) {
  return general_g_floats(n) +
         (n_ns > 0 ? 2L * P * P : static_cast<long>(n) * P);
}

// One product C[M, N] = epi(pre(A)·pre(B)) for every scenario b, each
// operand at its pointer + b · its stride; C's rows are N apart and N is a
// multiple of the tile edge. `aux` is B's row scale (kScaleB), ρ_new for K's
// diagonal (kKFromH) or the base of kSubFromBase.
struct Product {
  const float* a;
  long a_stride;
  int lda;
  const float* b;
  long b_stride;
  int ldb;
  float* c;
  long c_stride;
  const float* aux;
  long aux_stride;
  int M, N, K;
  float sigma;
};

// The thread's share of one stage: A rows [m0, m0 + T) × depth [k0, k0 + 32)
// and B depth rows × columns [n0, n0 + T), by cp.async, 16 bytes a copy
// where the source allows (4 where A's rows are not 16-byte aligned), zeros
// beyond M and K. One commit group a call.
template <int T>
__device__ __forceinline__ void stage_tiles(float* sa, float* sb,
                                            const Product& g, const float* A,
                                            const float* B, int m0, int n0,
                                            int k0, bool avec, int tid) {
  constexpr int LDA = kGenDepth + kGenPad;
  for (int e = tid; e < T * kGenDepth / 4; e += kGenThreads) {
    const int m = e / (kGenDepth / 4), k = 4 * (e % (kGenDepth / 4));
    const int r = m0 + m, kk = k0 + k;
    float* dst = sa + m * LDA + k;
    const float* src = A + static_cast<size_t>(r) * g.lda + kk;
    if (avec && r < g.M && kk + 3 < g.K) {
      __pipeline_memcpy_async(dst, src, 16);
    } else {
      for (int q = 0; q < 4; ++q) {
        if (r < g.M && kk + q < g.K)
          __pipeline_memcpy_async(dst + q, src + q, 4);
        else
          dst[q] = 0.0f;
      }
    }
  }
  for (int e = tid; e < kGenDepth * T / 4; e += kGenThreads) {
    const int k = e / (T / 4), c = 4 * (e % (T / 4));
    float* dst = sb + k * T + c;
    if (k0 + k < g.K)
      __pipeline_memcpy_async(
          dst, B + static_cast<size_t>(k0 + k) * g.ldb + n0 + c, 16);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __pipeline_commit();
}

// What the plain version rounds before a product, applied by each thread to
// its own copies of the stage once they have landed: B's rows scaled by
// d_box (W's operand d ⊙ X₀[box, :]), or K = H + σI + diag(ρ_new) on the
// diagonal entries of A's tile (K itself is never stored).
template <int T, int PRE>
__device__ __forceinline__ void prologue(float* sa, float* sb,
                                         const Product& g, const float* aux,
                                         int m0, int k0, int tid) {
  constexpr int LDA = kGenDepth + kGenPad;
  if constexpr (PRE == kScaleB) {
    for (int e = tid; e < kGenDepth * T / 4; e += kGenThreads) {
      const int k = e / (T / 4), c = 4 * (e % (T / 4));
      if (k0 + k < g.K) {
        float4& v = *reinterpret_cast<float4*>(sb + k * T + c);
        const float s = aux[k0 + k];
        v = make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y),
                        __fmul_rn(s, v.z), __fmul_rn(s, v.w));
      }
    }
  } else if constexpr (PRE == kKFromH) {
    if (m0 >= k0 + kGenDepth || k0 >= m0 + T) return;  // no diagonal here
    for (int e = tid; e < T * kGenDepth / 4; e += kGenThreads) {
      const int m = e / (kGenDepth / 4), k = 4 * (e % (kGenDepth / 4));
      const int r = m0 + m, q = r - (k0 + k);
      if (q >= 0 && q < 4 && r < g.M) {
        float& v = sa[m * LDA + k + q];
        v = (v + g.sigma) + aux[r];
      }
    }
  }
}

// TN consecutive floats of a row of B's staged tile
template <int TN>
__device__ __forceinline__ void load_row(float (&v)[TN], const float* p) {
  if constexpr (TN == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// The products of the general route, a launch over (scenario, output tile):
// T × T tiles, thread (ty, tx) of the 8 × 16 grid owns rows ty·TM .. + TM − 1
// and columns tx·TN .. + TN − 1 (8 × 4 at T = 64, 4 × 2 at T = 32), A read
// as one float4 along the depth per row, B as TN floats per depth step.
// Stages of 32 are double-buffered: the next one's copies are in flight
// while this one is multiplied. Every output entry is one fmaf chain over
// the whole depth in ascending order, from 0, as the previous design took
// it; the epilogue stores it, subtracts it from the base (X₀ − X₀[:, box]·W)
// or from 2I (2I − K·X).
template <int T, int EPI, int PRE>
__global__ void __launch_bounds__(kGenThreads)
woodbury_ns_general_product(const Product g) {
  constexpr int TM = T / 8, TN = T / 16, LDA = kGenDepth + kGenPad;
  constexpr int kStage = gen_stage_floats(T);
  float* smem = dyn_smem();
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_n = g.N / T, tiles = (g.M + T - 1) / T * tiles_n;
  const int bb = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int m0 = t / tiles_n * T, n0 = t % tiles_n * T;
  const float* A = g.a + bb * g.a_stride;
  const float* B = g.b + bb * g.b_stride;
  const float* aux = g.aux + bb * g.aux_stride;
  const bool avec =
      g.lda % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int nk = (g.K + kGenDepth - 1) / kGenDepth;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  stage_tiles<T>(smem, smem + T * LDA, g, A, B, m0, n0, 0, avec, tid);
  for (int kt = 0; kt < nk; ++kt) {
    float* sa = smem + (kt & 1) * kStage;
    float* sb = sa + T * LDA;
    if (kt + 1 < nk) {
      float* na = smem + ((kt + 1) & 1) * kStage;
      stage_tiles<T>(na, na + T * LDA, g, A, B, m0, n0, (kt + 1) * kGenDepth,
                     avec, tid);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    prologue<T, PRE>(sa, sb, g, aux, m0, kt * kGenDepth, tid);
    __syncthreads();
    const float* a_row = sa + ty * TM * LDA;
    const float* b_col = sb + tx * TN;
#pragma unroll 2
    for (int k = 0; k < kGenDepth; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_row + i * LDA + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
        load_row<TN>(bv, b_col + (k + kk) * T);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = reinterpret_cast<const float*>(&a[i])[kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next stage's copies go over this one
  }

  float* C = g.c + bb * g.c_stride;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i, c0 = n0 + tx * TN;
    if (r >= g.M) continue;
    const size_t rc = static_cast<size_t>(r) * g.N + c0;
    float v[TN];
    if (EPI == kSubFromBase) load_row<TN>(v, aux + rc);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (EPI == kSubFromBase) v[j] = v[j] - acc[i][j];
      else if (EPI == kTwoIMinus) v[j] = (r == c0 + j ? 2.0f : 0.0f) - acc[i][j];
      else v[j] = acc[i][j];
    }
    if constexpr (TN == 4)
      *reinterpret_cast<float4*>(C + rc) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(C + rc) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ void block_or_cluster_sync(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// One step of the elimination on kCh chunks of 32 columns of a row, from
// chunk q0 on: lane l takes columns l + 32·(q0 + u), u < kCh, loads them
// all, then writes a − cr · prow, rounded as the plain version (the entry
// in the pivot column was zeroed first). kCh is a compile-time count, so no
// entry is guarded (rows are padded to 32).
template <int kCh>
__device__ __forceinline__ void gj_update_chunks(float* row, const float* prow,
                                                 float cr, int q0, int lane) {
  float v[kCh], p[kCh];
#pragma unroll
  for (int u = 0; u < kCh; ++u) {
    v[u] = row[lane + 32 * (q0 + u)];
    p[u] = prow[lane + 32 * (q0 + u)];
  }
#pragma unroll
  for (int u = 0; u < kCh; ++u)
    row[lane + 32 * (q0 + u)] = v[u] - __fmul_rn(cr, p[u]);
}

// kCh chunks of a row divided by the pivot `piv` (column `col` of the row),
// written into `dst` in each of the C blocks of the cluster (the padding
// divides to zero)
template <int kCh>
__device__ __forceinline__ void gj_scale_chunks(float* dst, const float* row,
                                                float piv, int q0, int lane,
                                                int col, int C) {
  float v[kCh];
#pragma unroll
  for (int u = 0; u < kCh; ++u) {
    const int c = lane + 32 * (q0 + u);
    v[u] = (c == col ? 1.0f : row[c]) / piv;
  }
  for (int k = 0; k < C; ++k) {
    float* to = C == 1 ? dst : cg::this_cluster().map_shared_rank(dst, k);
#pragma unroll
    for (int u = 0; u < kCh; ++u) to[lane + 32 * (q0 + u)] = v[u];
  }
}

// `chunks` chunks of 32 columns, kGjGroup at a time, then the rest in one
// group of a compile-time size
template <class F>
__device__ __forceinline__ void gj_by_groups(int chunks, F&& f) {
  int q0 = 0;
  for (; q0 + kGjGroup <= chunks; q0 += kGjGroup)
    f(q0, std::integral_constant<int, kGjGroup>());
  switch (chunks - q0) {
    case 1: f(q0, std::integral_constant<int, 1>()); break;
    case 2: f(q0, std::integral_constant<int, 2>()); break;
    case 3: f(q0, std::integral_constant<int, 3>()); break;
    case 4: f(q0, std::integral_constant<int, 4>()); break;
    case 5: f(q0, std::integral_constant<int, 5>()); break;
    case 6: f(q0, std::integral_constant<int, 6>()); break;
    case 7: f(q0, std::integral_constant<int, 7>()); break;
    default: break;
  }
}

// G = M⁻¹, M = I + d_box ⊙ X₀[box, box], into the scenario's scratch, on a
// cluster of C blocks (C = 1: one block): the plain version's elimination on
// [M | I], no pivoting, in place, column i of the in-place form holding the
// right half's column i from step i on, each entry rounded as there (the
// pivot row divided by the clamped pivot, a rounded product subtracted).
// Block `rank` holds rows [rank·R, rank·R + R) of M, padded with zeros to
// n32 = n rounded up to 32 columns, in its shared memory or, where the
// cluster's cannot hold the matrix, in G itself; a warp updates whole
// rows, lane l their columns l, l + 32, ..., in groups of up to eight
// chunks whose loads are in flight together, with no branch per
// entry. Step i reads the scaled pivot row from the block's own shared
// memory, updates, and ends on one cluster barrier: the lane that holds
// column i + 1 of a row keeps its new entry as step i + 1's pivot column,
// and in the block that holds row i + 1 one warp updates that row alone,
// divides it by its clamped pivot and writes it into the other half of
// every block's double-buffered pivot row (distributed shared memory),
// while the other seven warps share the block's other rows. No step reads
// what it writes, and an entry does not depend on which block or warp
// updates its row.
template <bool kInSmem>
__global__ void __launch_bounds__(kGjThreads)
woodbury_ns_general_gauss_jordan(const float* __restrict__ kinv,
                                 const float* __restrict__ dvec,
                                 float* __restrict__ scratch, long stride,
                                 int P, int box0, int n, int C) {
  constexpr int kWarps = kGjThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % C, b = blockIdx.x / C;
  const int R = (n + C - 1) / C, row0 = rank * R;
  const int rows = max(0, min(R, n - row0));
  const int n32 = round32(n), R4 = round4(R), chunks = n32 / 32;
  float* prows = dyn_smem();      // [2][n32], a step's scaled pivot row
  float* pcol = prows + 2 * n32;  // [2][R4], the strip's pivot column
  float* G = scratch + b * stride;
  float* A = kInSmem ? pcol + 2 * R4 : G + static_cast<size_t>(row0) * n32;
  const float* Ki = kinv + b * static_cast<size_t>(P) * P;
  const float* d = dvec + static_cast<size_t>(b) * P;

  // row r of the strip divided by its clamped pivot, the entry in column
  // `col`, into every block's `dst`, by the warp that wrote the row
  auto scale_row = [&](int r, int col, float* dst) {
    __syncwarp();
    const float* row = A + static_cast<size_t>(r) * n32;
    const float piv = clamp_pivot(row[col]);
    gj_by_groups(chunks, [&](int q0, auto ch) {
      gj_scale_chunks<decltype(ch)::value>(dst, row, piv, q0, lane, col, C);
    });
  };

  for (int e = tid; e < rows * n32; e += kGjThreads) {
    const int r = e / n32, c = e % n32, gr = row0 + r;
    float v = 0.0f;
    if (c < n)
      v = (gr == c ? 1.0f : 0.0f) +
          __fmul_rn(d[box0 + gr],
                    Ki[static_cast<size_t>(box0 + gr) * P + box0 + c]);
    A[e] = v;
    if (c == 0) pcol[r] = v;
  }
  block_or_cluster_sync(C);  // every block runs before any writes to it
  if (rank == 0 && warp == 0) scale_row(0, 0, prows);
  block_or_cluster_sync(C);

  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const float* prow = prows + s * n32;
    const float* pc = pcol + s * R4;
    float* next_col = pcol + (s ^ 1) * R4;
    const int r1 = i + 1 - row0, ri = i - row0;
    const bool col_lane = (i + 1 < n) && lane == ((i + 1) & 31);
    auto step_row = [&](int r) {
      float* row = A + static_cast<size_t>(r) * n32;
      if (r == ri) {
        for (int c = lane; c < n32; c += 32) row[c] = prow[c];
      } else {
        const float cr = pc[r];
        if (lane == (i & 31)) row[i] = 0.0f;
        gj_by_groups(chunks, [&](int q0, auto ch) {
          gj_update_chunks<decltype(ch)::value>(row, prow, cr, q0, lane);
        });
      }
      if (col_lane) next_col[r] = row[i + 1];
    };
    if (r1 >= 0 && r1 < rows) {
      // one warp takes row i + 1 alone and scales it; the other seven
      // share the rest of the strip
      const int w1 = r1 % kWarps;
      if (warp == w1) {
        step_row(r1);
        scale_row(r1, i + 1, prows + (s ^ 1) * n32);
      } else {
        for (int j = (warp - w1 - 1 + kWarps) % kWarps; j < rows - 1;
             j += kWarps - 1)
          step_row(j + (j >= r1));
      }
    } else {
      for (int r = warp; r < rows; r += kWarps) step_row(r);
    }
    block_or_cluster_sync(C);
  }
  if (kInSmem) {
    float* g = G + static_cast<size_t>(row0) * n32;
    for (int e = tid; e < rows * n32; e += kGjThreads) g[e] = A[e];
  }
}

// out = ½(X + Xᵀ) in place, one pair of mirror tiles (I, J), I ≤ J, a block:
// both read row by row (coalesced) into shared memory, the means written
// back row by row; the transposed reads go down a column of a tile padded
// to 33, so they meet no bank twice. The two means of a pair are the same
// sum, so the output is exactly symmetric.
__global__ void __launch_bounds__(kSymTile * kSymRows)
woodbury_ns_general_symmetrise(float* __restrict__ out, int P) {
  constexpr int LD = kSymTile + 1;
  const int nt = P / kSymTile, pairs = nt * (nt + 1) / 2;
  const int b = blockIdx.x / pairs;
  int p = blockIdx.x % pairs, I = 0;
  while (p >= nt - I) {
    p -= nt - I;
    ++I;
  }
  const int J = I + p;
  const int tx = threadIdx.x % kSymTile, ty = threadIdx.x / kSymTile;
  float* X = out + b * static_cast<size_t>(P) * P;
  float* xij = X + static_cast<size_t>(kSymTile * I) * P + kSymTile * J;
  float* xji = X + static_cast<size_t>(kSymTile * J) * P + kSymTile * I;
  float* t1 = dyn_smem();
  float* t2 = t1 + kSymTile * LD;
  for (int r = ty; r < kSymTile; r += kSymRows) {
    t1[r * LD + tx] = xij[static_cast<size_t>(r) * P + tx];
    t2[r * LD + tx] = xji[static_cast<size_t>(r) * P + tx];
  }
  __syncthreads();
  for (int r = ty; r < kSymTile; r += kSymRows) {
    xij[static_cast<size_t>(r) * P + tx] =
        0.5f * (t1[r * LD + tx] + t2[tx * LD + r]);
    if (I != J)
      xji[static_cast<size_t>(r) * P + tx] =
          0.5f * (t2[r * LD + tx] + t1[tx * LD + r]);
  }
}

template <int T, int EPI, int PRE>
cudaError_t launch_product_tile(const Product& g, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ((g.M + T - 1) / T) * (g.N / T));
  cfg.blockDim = dim3(kGenThreads);
  cfg.dynamicSmemBytes = sizeof(float) * 2 * gen_stage_floats(T);
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, woodbury_ns_general_product<T, EPI, PRE>,
                            g);
}

template <int EPI, int PRE>
cudaError_t launch_product(const Product& g, int B, int tile,
                           cudaStream_t stream) {
  return tile == 32 ? launch_product_tile<32, EPI, PRE>(g, B, stream)
                    : launch_product_tile<64, EPI, PRE>(g, B, stream);
}

cudaError_t launch_gauss_jordan(const float* kinv, const float* d,
                                float* scratch, long stride, int B, int P,
                                int box0, int n, int C, bool in_smem,
                                cudaStream_t stream) {
  const size_t smem = sizeof(float) * gj_smem_floats(n, C, in_smem);
  void (*kernel)(const float*, const float*, float*, long, int, int, int,
                 int) = in_smem ? woodbury_ns_general_gauss_jordan<true>
                                : woodbury_ns_general_gauss_jordan<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kGjThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, kinv, d, scratch, stride, P, box0,
                            n, C);
}

}  // namespace

// shared memory in bytes that a block of a cluster of `cluster` needs
extern "C" int woodbury_ns_smem_bytes(int P, int n_box, int n_ns,
                                      int cluster) {
  return 4 * make_layout(P, n_box, n_ns, cluster).total;
}

extern "C" int woodbury_ns_launch(const float* kinv, const float* h,
                                  const float* d, const float* rho, float* out,
                                  int B, int P, int box0, int n_box,
                                  float sigma, int n_ns, int cluster,
                                  cudaStream_t stream) {
  if (box0 < 0 || n_box < 1 || n_box > kLane || box0 + n_box > P || n_ns < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaErrorInvalidValue;
  if (P == 128 && cluster == 1)
    err = launch<128, 1>(kinv, h, d, rho, out, B, box0, n_box, sigma, n_ns, stream);
  else if (P == 128 && cluster == 8)
    err = launch<128, 8>(kinv, h, d, rho, out, B, box0, n_box, sigma, n_ns, stream);
  else if (P == 256 && cluster == 8)
    err = launch<256, 8>(kinv, h, d, rho, out, B, box0, n_box, sigma, n_ns, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The general route's shared memory in bytes: a product block at tile edge
// `tile`, an elimination block of a cluster of `cluster` (with the matrix in
// shared memory or not); and its device scratch in floats per scenario.
extern "C" int woodbury_ns_general_product_smem_bytes(int tile) {
  return 4 * 2 * gen_stage_floats(tile);
}

extern "C" long woodbury_ns_general_gj_smem_bytes(int n_box, int cluster,
                                                  int in_smem) {
  return 4 * gj_smem_floats(n_box, cluster, in_smem != 0);
}

extern "C" long woodbury_ns_general_scratch_floats(int P, int n_box,
                                                   int n_ns) {
  return general_scratch_floats(P, n_box, n_ns);
}

// `scratch` holds B · woodbury_ns_general_scratch_floats(P, n_box, n_ns)
// floats that no other launch in flight uses (the wrapper allocates it per
// call on the launch's stream). `tile` (32 or 64) is the products' tile
// edge, `gj_cluster` (1, 2, 4 or 8) the blocks of the elimination's cluster
// and `gj_in_smem` whether M lives in their shared memory
// (ops/kernels.woodbury_plan chooses all three). 4 + 2·n_ns kernels:
//   1. G = M⁻¹                                  (Gauss–Jordan, a cluster)
//   2. W = G·(d_box ⊙ X₀[box, :])               [n, P]
//   3. X = X₀ − X₀[:, box]·W                    [P, P]
//   4. n_ns times: F = 2I − K·X, then X ← X·F   [P, P] each
//   5. out = ½(X + Xᵀ), in place
// The X of each step alternates between the output and the scratch so that
// the last one lands in the output.
extern "C" int woodbury_ns_general_launch(
    const float* kinv, const float* h, const float* d, const float* rho,
    float* out, float* scratch, int B, int P, int box0, int n_box,
    float sigma, int n_ns, int tile, int gj_cluster, int gj_in_smem,
    cudaStream_t stream) {
  const int C = gj_cluster;
  if (P < 1 || P % kSymTile || box0 < 0 || n_box < 1 || box0 + n_box > P ||
      n_ns < 0 || (tile != 32 && tile != 64) || P % tile ||
      (C != 1 && C != 2 && C != 4 && C != 8) ||
      4 * gj_smem_floats(n_box, C, gj_in_smem != 0) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int n = n_box;
  const long S = general_scratch_floats(P, n, n_ns);
  const long PP = static_cast<long>(P) * P;
  float* w = scratch + general_g_floats(n);  // W, then 2I − K·X
  float* xa = w + PP;                        // the X that is not in `out`
  cudaError_t err = launch_gauss_jordan(kinv, d, scratch, S, B, P, box0, n,
                                        C, gj_in_smem != 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_product<kStore, kScaleB>(
      Product{scratch, S, round32(n), kinv + static_cast<size_t>(box0) * P,
              PP, P, w, S, d + box0, P, n, P, n, sigma},
      B, tile, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* x = n_ns % 2 == 0 ? out : xa;
  long xs = n_ns % 2 == 0 ? PP : S;
  err = launch_product<kSubFromBase, kPlain>(
      Product{kinv + box0, PP, P, w, S, P, x, xs, kinv, PP, P, P, n, sigma},
      B, tile, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int s = 0; s < n_ns; ++s) {
    err = launch_product<kTwoIMinus, kKFromH>(
        Product{h, PP, P, x, xs, P, w, S, rho, P, P, P, P, sigma}, B, tile,
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* y = x == out ? xa : out;
    const long ys = x == out ? S : PP;
    err = launch_product<kStore, kPlain>(
        Product{x, xs, P, w, S, P, y, ys, nullptr, 0, P, P, P, sigma}, B,
        tile, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    x = y;
    xs = ys;
  }
  const int nt = P / kSymTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * (nt * (nt + 1) / 2));
  cfg.blockDim = dim3(kSymTile * kSymRows);
  cfg.dynamicSmemBytes = sizeof(float) * 2 * kSymTile * (kSymTile + 1);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, woodbury_ns_general_symmetrise, out, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
