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
// The general route (any P, any box; ops/kernels.woodbury_plan
// sends it the shapes the tuned routes do not take, such as a control
// horizon of 13 with joint limits: P = 256, n_box 132). A simple design that
// is right first: one block of 256 threads a scenario, the intermediates X,
// W or K, and 2I − KX in a per-scenario device scratch [3, P, P] that the
// wrapper allocates on the launch's stream, products as 64 × 64 output tiles
// (4 × 4 a thread, 32-deep shared-memory tiles, masked at ragged edges), the
// association and rounding of the plain version step for step. The
// Gauss–Jordan elimination runs in place on [n, n] with the plain version's
// rounding (division by the pivot, a rounded product subtracted), in shared
// memory while it fits (n ≤ 231) and in the scratch beyond (n = 528 at
// P = 640: 528 steps over 1.1 MB on one SM, timed in PERF.md). Bound: as
// the tuned routes; at B = 1 only one SM works. No padded size is refused:
// what caps P is device memory, the scratch's 12·P² bytes a scenario beside
// the 12·P² of K⁻¹, H and the result (every index into a matrix is a size_t
// product).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

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

constexpr int kGenTile = 64;              // output tile edge
constexpr int kGenDepth = 32;             // depth of a shared-memory tile
constexpr int kGenLdA = kGenTile + 1;     // padded row of the A tile
constexpr int kGenTileFloats = kGenDepth * kGenLdA + kGenDepth * kGenTile;

enum Epilogue { kStore = 0, kSubFromBase = 1, kTwoIMinus = 2 };

// floats of the pivot row and column, each rounded up to 4
__host__ __device__ constexpr int general_vec_floats(int n) {
  return 2 * ((n + 3) / 4 * 4);
}

// whether the in-place Gauss–Jordan matrix [n, n] fits shared memory beside
// the product tiles and the pivot vectors (n ≤ 231)
__host__ __device__ inline bool general_gj_in_smem(int n) {
  const long floats = static_cast<long>(kGenTileFloats) +
                      general_vec_floats(n) + static_cast<long>(n) * n;
  return 4 * floats <= kMaxSmem;
}

__host__ __device__ inline int general_smem_floats(int n) {
  return kGenTileFloats + general_vec_floats(n) +
         (general_gj_in_smem(n) ? n * n : 0);
}

// device scratch of one scenario: X, W or K, 2I − KX [3, P, P], and the
// Gauss–Jordan matrix [n, n] when shared memory cannot hold it
__host__ __device__ inline long general_scratch_floats(int P, int n) {
  return 3L * P * P + (general_gj_in_smem(n) ? 0 : static_cast<long>(n) * n);
}

// C = epi(A·diag?·B) for an [M, K] A and a [K, N] B (any M, N, K), both in
// device memory, by the whole block: 64 × 64 output tiles, 4 × 4 a thread,
// 32-deep shared-memory tiles, the depth summed in ascending order. With
// `bscale`, row k of B is taken as bscale[k]·B[k, :], each product rounded
// as the plain version rounds d ⊙ K⁻¹. kSubFromBase stores base − A·B,
// kTwoIMinus 2I − A·B.
template <int EPI>
__device__ void general_matmul(const float* A, int lda, const float* B,
                               int ldb, const float* bscale, float* C,
                               int ldc, const float* base, int M, int N,
                               int K, float* sA, float* sB) {
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  for (int m0 = 0; m0 < M; m0 += kGenTile) {
    for (int n0 = 0; n0 < N; n0 += kGenTile) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += kGenDepth) {
        for (int e = tid; e < kGenTile * kGenDepth; e += kThreads) {
          const int m = e / kGenDepth, k = e % kGenDepth;
          const bool in = m0 + m < M && k0 + k < K;
          sA[k * kGenLdA + m] =
              in ? A[static_cast<size_t>(m0 + m) * lda + k0 + k] : 0.0f;
        }
        for (int e = tid; e < kGenDepth * kGenTile; e += kThreads) {
          const int k = e / kGenTile, c = e % kGenTile;
          float v = 0.0f;
          if (k0 + k < K && n0 + c < N) {
            v = B[static_cast<size_t>(k0 + k) * ldb + n0 + c];
            if (bscale != nullptr) v = __fmul_rn(bscale[k0 + k], v);
          }
          sB[k * kGenTile + c] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kGenDepth; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sA[k * kGenLdA + tr * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sB[k * kGenTile + tc * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tc * 4 + j;
          if (r < M && c < N) {
            float v = acc[i][j];
            const size_t rc = static_cast<size_t>(r) * ldc + c;
            if (EPI == kSubFromBase) v = base[rc] - v;
            if (EPI == kTwoIMinus) v = (r == c ? 2.0f : 0.0f) - v;
            C[rc] = v;
          }
        }
      }
    }
  }
  __syncthreads();
}

// G = M⁻¹ in place on A [n, n] (shared or device memory): the elimination
// of the plain version on [M | I], no pivoting, where column i of the
// in-place form holds the right half's column i from step i on. Each step
// rounds as the plain version does: the pivot row divided by the clamped
// pivot, the update a rounded product subtracted.
__device__ void general_gauss_jordan(float* A, int n, float* prow,
                                     float* pcol) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  for (int i = 0; i < n; ++i) {
    const float* Ai = A + static_cast<size_t>(i) * n;
    const float piv = clamp_pivot(Ai[i]);
    for (int c = tid; c < n; c += kThreads)
      prow[c] = (c == i ? 1.0f : Ai[c]) / piv;
    for (int r = tid; r < n; r += kThreads)
      pcol[r] = A[static_cast<size_t>(r) * n + i];
    __syncthreads();
    for (int r = warp; r < n; r += kWarps) {
      float* row = A + static_cast<size_t>(r) * n;
      if (r == i) {
        for (int c = lane; c < n; c += 32) row[c] = prow[c];
      } else {
        const float cr = pcol[r];
        for (int c = lane; c < n; c += 32)
          row[c] = (c == i ? 0.0f : row[c]) - __fmul_rn(cr, prow[c]);
      }
    }
    __syncthreads();
  }
}

// One block per scenario, intermediates in a per-scenario device scratch
// (see general_scratch_floats), the products as general_matmul tiles:
//   M = I + d_box ⊙ X₀[box, box];  G = M⁻¹           (Gauss–Jordan)
//   W = G·(d_box ⊙ X₀[box, :]);    X = X₀ − X₀[:, box]·W
//   n_ns times: K = H + σI + diag(ρ_new);  X ← X·(2I − K·X)
//   out = ½(X + Xᵀ)
// the association of the plain version, step for step.
__global__ void __launch_bounds__(kThreads) woodbury_ns_general_kernel(
    const float* __restrict__ kinv, const float* __restrict__ h,
    const float* __restrict__ dvec, const float* __restrict__ rho,
    float* __restrict__ out, float* __restrict__ scratch, int P, int box0,
    int n, float sigma, int n_ns) {
  float* smem = dyn_smem();
  float* sA = smem;
  float* sB = sA + kGenDepth * kGenLdA;
  float* prow = smem + kGenTileFloats;
  float* pcol = prow + general_vec_floats(n) / 2;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t PP = static_cast<size_t>(P) * P;
  const float* Ki = kinv + b * PP;
  const float* Hb = h + b * PP;
  const float* d = dvec + static_cast<size_t>(b) * P;
  const float* rh = rho + static_cast<size_t>(b) * P;
  float* S0 = scratch + b * general_scratch_floats(P, n);
  float* S1 = S0 + PP;
  float* S2 = S1 + PP;
  float* gj = general_gj_in_smem(n) ? prow + general_vec_floats(n) : S2 + PP;

  // 1. M, rounded as capacitance() rounds it, then G = M⁻¹ in place
  for (int r = tid / 32; r < n; r += kThreads / 32)
    for (int c = tid % 32; c < n; c += 32)
      gj[static_cast<size_t>(r) * n + c] =
          (r == c ? 1.0f : 0.0f) +
          __fmul_rn(d[box0 + r],
                    Ki[static_cast<size_t>(box0 + r) * P + box0 + c]);
  __syncthreads();
  general_gauss_jordan(gj, n, prow, pcol);

  // 2. W [n, P] into S1, X into S0
  general_matmul<kStore>(gj, n, Ki + static_cast<size_t>(box0) * P, P,
                         d + box0, S1, P, nullptr, n, P, n, sA, sB);
  general_matmul<kSubFromBase>(Ki + box0, P, S1, P, nullptr, S0, P, Ki, P, P,
                               n, sA, sB);

  // 3. Newton–Schulz: K into the free buffer, 2I − K·X into S2, X·(2I − KX)
  // over K
  float* X = S0;
  float* F = S1;
  for (int s = 0; s < n_ns; ++s) {
    for (size_t e = tid; e < PP; e += kThreads) {
      const int r = static_cast<int>(e / P), c = static_cast<int>(e % P);
      float kv = Hb[e];
      if (r == c) kv = kv + sigma + rh[r];
      F[e] = kv;
    }
    __syncthreads();
    general_matmul<kTwoIMinus>(F, P, X, P, nullptr, S2, P, nullptr, P, P, P,
                               sA, sB);
    general_matmul<kStore>(X, P, S2, P, nullptr, F, P, nullptr, P, P, P, sA,
                           sB);
    float* t = X;
    X = F;
    F = t;
  }

  // 4. out = ½(X + Xᵀ)
  float* o = out + b * PP;
  for (size_t e = tid; e < PP; e += kThreads) {
    const int r = static_cast<int>(e / P), c = static_cast<int>(e % P);
    o[e] = 0.5f * (X[e] + X[static_cast<size_t>(c) * P + r]);
  }
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

// The general route's dynamic shared memory in bytes and its device scratch
// in floats per scenario.
extern "C" int woodbury_ns_general_smem_bytes(int n_box) {
  return 4 * general_smem_floats(n_box);
}

extern "C" long woodbury_ns_general_scratch_floats(int P, int n_box) {
  return general_scratch_floats(P, n_box);
}

// `scratch` holds B · woodbury_ns_general_scratch_floats(P, n_box) floats
// that no other launch in flight uses (the wrapper allocates it per call on
// the launch's stream).
extern "C" int woodbury_ns_general_launch(
    const float* kinv, const float* h, const float* d, const float* rho,
    float* out, float* scratch, int B, int P, int box0, int n_box,
    float sigma, int n_ns, cudaStream_t stream) {
  if (P < 1 || box0 < 0 || n_box < 1 || box0 + n_box > P || n_ns < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float) * general_smem_floats(n_box);
  cudaError_t err = cudaFuncSetAttribute(
      woodbury_ns_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, woodbury_ns_general_kernel, kinv, h, d, rho,
                           out, scratch, P, box0, n_box, sigma, n_ns);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
