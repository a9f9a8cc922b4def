// woodbury_ns — (K(ρ_new))⁻¹ from (K(ρ_old))⁻¹, one scenario per thread
// block: rank-n_box Woodbury update with an in-block Gauss–Jordan
// capacitance inverse, n_ns Newton–Schulz steps, symmetrised output.
//
// Replaces the TPU kernel ironcub_mpc_tpu/ops/pallas_solve.py
// `woodbury_ns` (body `_woodbury_kernel`). It computes the same function,
// not the same blocks: the TPU kernel embeds and extracts the box through
// 0/1 selector matmuls because Mosaic cannot slice lanes at unaligned
// offsets; here the box is indexed directly. With X = K⁻¹(ρ_old) [P, P],
// d = ρ_new − ρ_old and the box rows/cols [box0, box0 + n):
//   1. M = I + diag(d_box)·X[box, box], laid out as [M | I] in shared memory
//   2. Gauss–Jordan on [M | I], no pivoting, |pivot| < 1e-12 clamped to
//      ∓1e-12 (+1e-12 for 0), one __syncthreads() per pivot step
//   3. W = M⁻¹·(d_box ⊙ X[box, :]) and X ← X − X[:, box]·W
//   4. n_ns times: T = K·X with K = H + σI + diag(ρ_new), X ← X(2I − T)
//   5. out = ½(X + Xᵀ)
//
// What bounds it on an H100: operations. With n_ns = 1 a scenario is about
// 2·(2P³) + 4P²·n ≈ 8.7 MFLOP against 2·64 KB of matrices read, so at
// B = 256 the ~2.2 GFLOP take ~33 µs at the fp32 FMA peak while the bytes
// take ~10 µs. With n_ns = 0 (the Schur-polish operator, every tick) only
// the rank-n update remains and the kernel is close to the byte bound. The
// design keeps every product on CUDA cores in plain fp32 FMA (no TF32):
// P×P products run as 64×64 output tiles per block, 4×4 outputs per thread
// from 32-deep shared-memory tiles. Three P×P intermediates and the
// Gauss–Jordan buffer do not fit in 227 KB of shared memory, so X, K and
// 2I − T live in a per-scenario global scratch [3, P, P] that the caller
// allocates (B = 256: 50 MB, about the size of L2); the Gauss–Jordan
// buffer (4.6 KB at n = 24, 115 KB at n = 120) stays in shared memory.
// Stages are ordered by __syncthreads(), which also orders the block's
// global-memory writes before its later reads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // output tile edge
constexpr int kDepth = 32;    // reduction depth per shared-memory tile
constexpr int kLdA = kTile + 1;  // padded row of the A tile (no bank conflicts on store)
constexpr int kMaxSmem = 232448;

enum Epilogue { kStore = 0, kSubFromBase = 1, kTwoIMinus = 2 };

// C = epi(A·B) for an [M, K] A and a [K, N] B read from global memory; M
// and N are multiples of kTile, K is any size. kSubFromBase stores
// base − A·B, kTwoIMinus stores 2I − A·B.
template <int EPI>
__device__ void block_matmul(const float* A, int lda, const float* B, int ldb,
                             float* C, int ldc, const float* base, int M,
                             int N, int K, float* sA, float* sB) {
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    for (int n0 = 0; n0 < N; n0 += kTile) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += kDepth) {
        for (int e = tid; e < kTile * kDepth; e += kThreads) {
          const int m = e / kDepth, k = e % kDepth;
          sA[k * kLdA + m] = (k0 + k < K) ? A[(m0 + m) * lda + k0 + k] : 0.0f;
        }
        for (int e = tid; e < kDepth * kTile; e += kThreads) {
          const int k = e / kTile, n = e % kTile;
          sB[k * kTile + n] = (k0 + k < K) ? B[(k0 + k) * ldb + n0 + n] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kDepth; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sA[k * kLdA + tr * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sB[k * kTile + tc * 4 + j];
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
          float out = acc[i][j];
          if (EPI == kSubFromBase) out = base[r * ldc + c] - out;
          if (EPI == kTwoIMinus) out = (r == c ? 2.0f : 0.0f) - out;
          C[r * ldc + c] = out;
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
woodbury_ns_kernel(const float* __restrict__ kinv, const float* __restrict__ h,
                   const float* __restrict__ dvec, const float* __restrict__ rho,
                   float* __restrict__ out, float* __restrict__ scratch, int P,
                   int box0, int n, float sigma, int n_ns) {
  extern __shared__ float smem[];
  const int w2 = 2 * n;
  float* G = smem;              // [n, 2n] Gauss–Jordan buffer [M | I]
  float* rowv = G + n * w2;     // [2n] scaled pivot row
  float* colv = rowv + w2;      // [n] pivot column
  float* sA = colv + n;         // [kDepth, kLdA]
  float* sB = sA + kDepth * kLdA;  // [kDepth, kTile]

  const int tid = threadIdx.x;
  const size_t PP = static_cast<size_t>(P) * P;
  const int b = blockIdx.x;
  const float* Ki = kinv + b * PP;
  const float* Hb = h + b * PP;
  const float* d = dvec + static_cast<size_t>(b) * P;
  const float* rh = rho + static_cast<size_t>(b) * P;
  float* S0 = scratch + 3 * b * PP;
  float* S1 = S0 + PP;
  float* S2 = S1 + PP;

  // 1. [M | I] with M = I + diag(d_box)·K⁻¹[box, box]
  for (int e = tid; e < n * w2; e += kThreads) {
    const int i = e / w2, j = e % w2;
    float g;
    if (j < n) {
      g = (i == j ? 1.0f : 0.0f) + d[box0 + i] * Ki[(box0 + i) * P + box0 + j];
    } else {
      g = (j - n == i) ? 1.0f : 0.0f;
    }
    G[e] = g;
  }
  __syncthreads();

  // 2. Gauss–Jordan, no pivoting
  for (int i = 0; i < n; ++i) {
    float piv = G[i * w2 + i];
    if (fabsf(piv) < 1e-12f) piv = piv < 0.0f ? -1e-12f : 1e-12f;
    for (int c = tid; c < w2; c += kThreads) rowv[c] = G[i * w2 + c] / piv;
    for (int r = tid; r < n; r += kThreads) colv[r] = G[r * w2 + i];
    __syncthreads();
    for (int e = tid; e < n * w2; e += kThreads) {
      const int r = e / w2, c = e % w2;
      G[e] = (r == i) ? rowv[c] : G[e] - colv[r] * rowv[c];
    }
    __syncthreads();
  }

  // 3. W = M⁻¹·(d_box ⊙ K⁻¹[box, :]) into S1 ([n, P]), X = K⁻¹ − K⁻¹[:, box]·W
  for (int e = tid; e < n * P; e += kThreads) {
    const int i = e / P, c = e % P;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k)
      acc = fmaf(G[i * w2 + n + k], d[box0 + k] * Ki[(box0 + k) * P + c], acc);
    S1[e] = acc;
  }
  __syncthreads();
  block_matmul<kSubFromBase>(Ki + box0, P, S1, P, S0, P, Ki, P, P, n, sA, sB);

  // 4. Newton–Schulz against K = H + σI + diag(ρ_new)
  float* X = S0;
  float* F = S1;  // free P×P buffer
  for (int s = 0; s < n_ns; ++s) {
    for (size_t e = tid; e < PP; e += kThreads) {
      const int r = static_cast<int>(e / P), c = static_cast<int>(e % P);
      float kv = Hb[e];
      if (r == c) kv = kv + sigma + rh[r];
      F[e] = kv;
    }
    __syncthreads();
    block_matmul<kTwoIMinus>(F, P, X, P, S2, P, nullptr, P, P, P, sA, sB);
    block_matmul<kStore>(X, P, S2, P, F, P, nullptr, P, P, P, sA, sB);
    float* t = X;
    X = F;
    F = t;
  }

  // 5. out = ½(X + Xᵀ)
  float* o = out + b * PP;
  for (size_t e = tid; e < PP; e += kThreads) {
    const int r = static_cast<int>(e / P), c = static_cast<int>(e % P);
    o[e] = 0.5f * (X[e] + X[c * P + r]);
  }
}

}  // namespace

extern "C" int woodbury_ns_launch(const float* kinv, const float* h,
                                  const float* d, const float* rho,
                                  float* out, float* scratch, int B, int P,
                                  int box0, int n_box, float sigma, int n_ns,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(n_box) * n_box + 3 * n_box + kDepth * kLdA +
       kDepth * kTile);
  if (smem > static_cast<size_t>(kMaxSmem) || P % kTile != 0 || box0 < 0 ||
      n_box < 1 || box0 + n_box > P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      woodbury_ns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    woodbury_ns_kernel<<<B, kThreads, smem, stream>>>(
        kinv, h, d, rho, out, scratch, P, box0, n_box, sigma, n_ns);
  }
  return static_cast<int>(cudaGetLastError());
}
