// The lexicographic (min, +) product with a max-rank payload, written by
// hand for Hopper (sm_90a):
//
//   out_d[b, v] = min_u dist[b, u] + W[u, v]
//   out_m[b, v] = max { mrank[b, u] : dist[b, u] + W[u, v] is finite
//                                      and attains out_d[b, v] }, or -1
//
// Replaces: src/repro/kernels/minplus/minplus.py::_minplus_kernel, the
// TPU kernel of the dense-block PLaNT sweep (ops.py::plant_sweep_dense).
//
// Bound on the H100: operations. Per (b, u, v) the function does an f32
// add, a compare and a max-rank select, 3 * B * K * N operations on the
// CUDA cores (the (min, +) semiring has no tensor-core form), against
// 4 * K * N + 8 * B * (K + N) bytes. At B = 64 that is 48 operations per
// byte of W, far past the card's balance point.
//
// Design: the TPU grid's sequential ("arbitrary") K axis becomes a loop
// inside the block. A block of 256 threads owns one 64 x 64 output tile
// (64 rows of the batch, 64 columns of W); each thread keeps a 4 x 4
// register tile of (best, bm) accumulators. Per step of 32 along K the
// block stages dist and mrank [64 x 32] (transposed, so that a thread
// reads its 4 rows as one 16 B word) and W [32 x 64] in shared memory;
// each thread then folds 32 x 16 candidates from registers. Ragged B, K
// and N are masked at the loads (+inf distance, -1 rank, +inf weight),
// which fold as the identity, and at the stores; there is no padding
// pass. The fold keeps the exact lexicographic rule of minplus.py:50-63
// in branch-free form: a smaller candidate takes its rank, an equal one
// takes the max; an all-infinite column ends at (+inf, -1). All
// arithmetic is one f32 add plus compares, so the result is
// bit-identical to the plain PyTorch version. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TB = 64;        // output rows (trees) per block
constexpr int TN = 64;        // output columns per block
constexpr int TK = 32;        // contraction depth per shared-memory step
constexpr int PITCH = TB + 4; // transposed row pitch: 16 B aligned, and
                              // only 4-way bank conflicts on the stores
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ dist, const int* __restrict__ mrank,
               const float* __restrict__ w, float* __restrict__ out_d,
               int* __restrict__ out_m, long long B, long long K,
               long long N) {
  __shared__ __align__(16) float sd[TK][PITCH];
  __shared__ __align__(16) int sm[TK][PITCH];
  __shared__ __align__(16) float sw[TK][TN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long b0 = (long long)blockIdx.y * TB;
  const long long n0 = (long long)blockIdx.x * TN;

  float best[4][4];
  int bm[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      best[i][j] = INFINITY;
      bm[i][j] = -1;
    }
  }

  for (long long k0 = 0; k0 < K; k0 += TK) {
    // dist / mrank [TB rows x TK], read along k (coalesced), stored
    // transposed
    for (int e = threadIdx.x; e < TB * TK; e += THREADS) {
      const int r = e / TK, c = e % TK;
      const long long b = b0 + r, k = k0 + c;
      const bool ok = b < B && k < K;
      sd[c][r] = ok ? dist[b * K + k] : INFINITY;
      sm[c][r] = ok ? mrank[b * K + k] : -1;
    }
    // W [TK x TN], read along v (coalesced)
    for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
      const int r = e / TN, c = e % TN;
      const long long k = k0 + r, v = n0 + c;
      sw[r][c] = (k < K && v < N) ? w[k * N + v] : INFINITY;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      const float4 dv = *reinterpret_cast<const float4*>(&sd[kk][ty * 4]);
      const int4 mv = *reinterpret_cast<const int4*>(&sm[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&sw[kk][tx * 4]);
      const float d[4] = {dv.x, dv.y, dv.z, dv.w};
      const int m[4] = {mv.x, mv.y, mv.z, mv.w};
      const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = d[i] + wj[j];
          const int tie = max(bm[i][j], m[i]);
          bm[i][j] = (c < best[i][j]) ? m[i]
                                      : ((c == best[i][j]) ? tie : bm[i][j]);
          best[i][j] = fminf(best[i][j], c);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long b = b0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long v = n0 + tx * 4 + j;
      if (v >= N) continue;
      // while best is +inf, bm followed infinite candidates: no rank
      out_d[b * N + v] = best[i][j];
      out_m[b * N + v] = isinf(best[i][j]) ? -1 : bm[i][j];
    }
  }
}

}  // namespace

extern "C" int minplus_launch(const void* dist, const void* mrank,
                              const void* w, void* out_d, void* out_m,
                              long long B, long long K, long long N,
                              void* stream) {
  const dim3 grid((unsigned int)((N + TN - 1) / TN),
                  (unsigned int)((B + TB - 1) / TB));
  minplus_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dist, (const int*)mrank, (const float*)w, (float*)out_d,
      (int*)out_m, B, K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
