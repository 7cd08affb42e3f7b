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
// byte of W, far past the card's balance point. What limits a kernel in
// practice is the SM's ALU pipe, which runs min/max, compares and selects
// at half the rate of the f32 adds: a one-pass lexicographic fold costs
// about six ALU instructions a candidate (FMNMX, two FSETP, two SEL,
// IMNMX).
//
// Design.
// - Two passes over K, each exact: the first folds only the minimum
//   (FADD + FMNMX a candidate); the second recomputes each candidate,
//   bit for bit the same sum, and takes the max rank where it equals the
//   minimum (FADD + FSETP + a predicated integer max, tie_max). That is
//   three ALU instructions a candidate instead of six, for a second read
//   of W (a few ms of bandwidth at the dense block's shape, overlapped).
//   Starting the rank at -1 gives max(-1, ranks that attain), the plain
//   version's rule; while the minimum is +inf the rank followed infinite
//   candidates, and the store makes it -1.
// - Output tiles of TB x TN = 64 x 128 and 256 threads (8 row groups x
//   32 column groups), each with an 8 x 4 register tile (124 registers).
//   At the dense block (B = 64, N = 32,768) that is 256 blocks; two fit
//   an SM (launch bounds and shared memory), so the grid is 0.97 of one
//   wave of 264 and no SM holds more than two.
// - K in steps of TK = 32, staged with cp.async into a ring of NSTAGE = 3
//   shared-memory stages, so that the copies of the next two steps are
//   in flight while a step is folded; the 32 steps of a stage are
//   unrolled. dist and mrank [TB x TK] are stored transposed (a thread
//   reads its 8 rows as two 16 B words); W [TK x TN] is copied as 16 B
//   vectors when N and the pointer allow, else 4 B.
// - Ragged B, K and N: elements past the edge are written +inf (rank -1)
//   straight into shared memory, which folds as the identity, and the
//   stores are masked. An all-infinite column ends at (+inf, -1).
// Measured on the H100 (PERF.md): 64 x 64 tiles (4 blocks per
// SM), 8 x 8 register tiles and 4 x 4 ones all lost to this shape.
// All arithmetic is one f32 add plus compares, so the result is
// bit-identical to the plain PyTorch version. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// minplus.py's TB, TN, TK, NSTAGE, THREADS and BLOCKS_PER_SM
constexpr int TB = 64;          // output rows (trees) per block
constexpr int TN = 128;         // output columns per block
constexpr int TK = 32;          // contraction depth per stage
constexpr int NSTAGE = 3;       // shared-memory stages in the ring
constexpr int BLOCKS_PER_SM = 2;
constexpr int RI = 8;           // rows per thread
constexpr int CJ = 4;           // columns per thread
constexpr int TX = TN / CJ;     // column groups: 32
constexpr int THREADS = TX * (TB / RI);   // 256
constexpr int PITCH = TB + 4;   // transposed row pitch (16 B aligned)

struct Stage {
  float d[TK][PITCH];
  int m[TK][PITCH];
  float w[TK][TN];
};
constexpr int SMEM_BYTES = NSTAGE * (int)sizeof(Stage);

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bm = max(bm, m) where c == best: one compare into a predicate and a
// predicated integer max (left to itself, nvcc emits ISETP, FSETP and
// SEL: three ALU instructions instead of two)
__device__ __forceinline__ void tie_max(int& bm, float c, float best,
                                        int m) {
  asm("{\n .reg .pred p;\n setp.eq.f32 p, %1, %2;\n"
      " @p max.s32 %0, %0, %3;\n}" : "+r"(bm) : "f"(c), "f"(best), "r"(m));
}

struct Args {
  const float* dist;
  const int* mrank;
  const float* w;
  float* out_d;
  int* out_m;
  long long B, K, N;
  bool w_vec;   // W rows copy as 16 B vectors (N % 4 == 0, aligned)
};

// Start the copies of K step kt into stage st (mrank only in the rank
// pass); past the edge, +inf / -1 go straight into shared memory.
template <bool RANK>
__device__ __forceinline__ void load_stage(const Args& a, Stage& st,
                                           long long kt, long long b0,
                                           long long n0, int tid) {
  const long long k0 = kt * TK;
#pragma unroll
  for (int e = tid; e < TB * TK; e += THREADS) {
    const int r = e / TK, c = e % TK;
    const long long b = b0 + r, k = k0 + c;
    if (b < a.B && k < a.K) {
      cp_async4(&st.d[c][r], a.dist + b * a.K + k);
      if (RANK) cp_async4(&st.m[c][r], a.mrank + b * a.K + k);
    } else {
      st.d[c][r] = INFINITY;
      if (RANK) st.m[c][r] = -1;
    }
  }
#pragma unroll
  for (int q = tid; q < TK * TN / 4; q += THREADS) {
    const int r = q / (TN / 4), c = 4 * (q % (TN / 4));
    const long long k = k0 + r, v = n0 + c;
    float* dst = &st.w[r][c];
    if (a.w_vec && k < a.K && v + 3 < a.N) {
      cp_async16(dst, a.w + k * a.N + v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k < a.K && v + j < a.N)
          cp_async4(dst + j, a.w + k * a.N + v + j);
        else
          dst[j] = INFINITY;
      }
    }
  }
}

// One pass over K through the stage ring. RANK == false folds the
// minimum into best; RANK == true takes, into bm, the max rank of the
// candidates equal to best.
template <bool RANK>
__device__ __forceinline__ void k_pass(const Args& a, Stage* ring,
                                       long long b0, long long n0, int tid,
                                       float (&best)[RI][CJ],
                                       int (&bm)[RI][CJ]) {
  const int ty = tid / TX, tx = tid % TX;
  const long long steps = (a.K + TK - 1) / TK;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < steps) load_stage<RANK>(a, ring[s], s, b0, n0, tid);
    cp_async_commit();
  }
  for (long long kt = 0; kt < steps; ++kt) {
    cp_async_wait<NSTAGE - 2>();   // this thread's copies of step kt
    __syncthreads();               // everyone's; stage (kt - 1) is free
    const long long nk = kt + NSTAGE - 1;
    if (nk < steps) load_stage<RANK>(a, ring[nk % NSTAGE], nk, b0, n0, tid);
    cp_async_commit();
    const Stage& st = ring[kt % NSTAGE];
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      // the thread's RI rows and CJ columns at kk, 16 B at a time
      float d[RI], wj[CJ];
#pragma unroll
      for (int i = 0; i < RI; i += 4)
        *reinterpret_cast<float4*>(d + i) =
            *reinterpret_cast<const float4*>(&st.d[kk][ty * RI + i]);
#pragma unroll
      for (int j = 0; j < CJ; j += 4)
        *reinterpret_cast<float4*>(wj + j) =
            *reinterpret_cast<const float4*>(&st.w[kk][tx * CJ + j]);
      if (!RANK) {
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            best[i][j] = fminf(best[i][j], d[i] + wj[j]);
      } else {
        int m[RI];
#pragma unroll
        for (int i = 0; i < RI; i += 4)
          *reinterpret_cast<int4*>(m + i) =
              *reinterpret_cast<const int4*>(&st.m[kk][ty * RI + i]);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            tie_max(bm[i][j], d[i] + wj[j], best[i][j], m[i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the next pass
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    minplus_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int tid = threadIdx.x;
  const long long b0 = (long long)blockIdx.y * TB;
  const long long n0 = (long long)blockIdx.x * TN;

  float best[RI][CJ];
  int bm[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      best[i][j] = INFINITY;
      bm[i][j] = -1;
    }
  k_pass<false>(a, ring, b0, n0, tid, best, bm);
  k_pass<true>(a, ring, b0, n0, tid, best, bm);

  const int ty = tid / TX, tx = tid % TX;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long b = b0 + ty * RI + i;
    if (b >= a.B) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const long long v = n0 + tx * CJ + j;
      if (v >= a.N) continue;
      // while best is +inf, bm followed infinite candidates: no rank
      a.out_d[b * a.N + v] = best[i][j];
      a.out_m[b * a.N + v] = isinf(best[i][j]) ? -1 : bm[i][j];
    }
  }
}

}  // namespace

extern "C" int minplus_launch(const void* dist, const void* mrank,
                              const void* w, void* out_d, void* out_m,
                              long long B, long long K, long long N,
                              void* stream) {
  const long long gx = (N + TN - 1) / TN, gy = (B + TB - 1) / TB;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      minplus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const float*)dist, (const int*)mrank, (const float*)w,
               (float*)out_d, (int*)out_m, B, K, N,
               N % 4 == 0 && ((unsigned long long)w & 15ULL) == 0};
  minplus_kernel<<<dim3((unsigned int)gx, (unsigned int)gy), THREADS,
                   SMEM_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
