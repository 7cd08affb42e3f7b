// Batched PPSD label intersection with the witnessing hub, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/label_query/label_query.py::_label_query_kernel
// (distance only there), and takes the place of the reference's jnp
// query path src/repro/core/labels.py::query_pairs, whose hub it returns
// as well: for query q with label rows (hu, du) and (hv, dv) of width L,
//   dist[q] = min over hu[i] == hv[j] >= 0 of du[i] + dv[j]  (+inf if none)
//   hub[q]  = hu[i*] for the first row-major (i*, j*) attaining dist[q],
//             -1 when dist[q] is not finite.
//
// Bound on the H100: the L x L hub compares per query at short label
// widths are cheap, so for the widths this repository builds (L <= a few
// hundred) the four [Q, L] operand reads (16 B per slot) bound it; the
// compares (Q * L * L) take over only for wide rows.
//
// Design: one warp per query, four queries per block. The v-side row is
// staged through shared memory in tiles of 256 slots, so any L runs with
// no size wall; each lane owns the u-side slots i = lane, lane + 32, ...
// and scans the staged tile (every lane reads the same shared word:
// a broadcast, no bank conflicts). Each lane keeps the lexicographic
// least (distance, i * L + j) pair and a warp shuffle reduces them, so
// ties go to the first row-major index exactly as argmin does. The one
// f32 add per match is the reference's own arithmetic, so distances are
// bit-identical.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 256;

__device__ __forceinline__ bool lex_less(float c, long long i, float bc,
                                         long long bi) {
  return c < bc || (c == bc && i < bi);
}

__global__ void label_query_kernel(const int* __restrict__ hu,
                                   const float* __restrict__ du,
                                   const int* __restrict__ hv,
                                   const float* __restrict__ dv,
                                   float* __restrict__ out_d,
                                   int* __restrict__ out_h,
                                   long long Q, long long L) {
  __shared__ int s_h[kWarps][kTile];
  __shared__ float s_d[kWarps][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= Q) return;  // the whole warp leaves together
  const int* hu_q = hu + q * L;
  const float* du_q = du + q * L;
  const int* hv_q = hv + q * L;
  const float* dv_q = dv + q * L;

  float bc = INFINITY;
  long long bi = LLONG_MAX;
  for (long long j0 = 0; j0 < L; j0 += kTile) {
    const int tl = (int)(L - j0 < kTile ? L - j0 : kTile);
    __syncwarp();
    for (int t = lane; t < tl; t += 32) {
      s_h[warp][t] = hv_q[j0 + t];
      s_d[warp][t] = dv_q[j0 + t];
    }
    __syncwarp();
    for (long long i = lane; i < L; i += 32) {
      const int h = hu_q[i];
      if (h < 0) continue;
      const float d = du_q[i];
      for (int t = 0; t < tl; ++t) {
        if (s_h[warp][t] == h) {
          const float c = d + s_d[warp][t];
          const long long idx = i * L + j0 + t;
          if (lex_less(c, idx, bc, bi)) {
            bc = c;
            bi = idx;
          }
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, bc, off);
    const long long oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (lex_less(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  if (lane == 0) {
    out_d[q] = bc;
    out_h[q] = isfinite(bc) ? hu_q[bi / L] : -1;
  }
}

}  // namespace

extern "C" int label_query_launch(const void* hu, const void* du,
                                  const void* hv, const void* dv,
                                  void* out_d, void* out_h, long long Q,
                                  long long L, void* stream) {
  const long long blocks = (Q + kWarps - 1) / kWarps;
  label_query_kernel<<<(unsigned int)blocks, kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      (const int*)hu, (const float*)du, (const int*)hv, (const float*)dv,
      (float*)out_d, (int*)out_h, Q, L);
  return (int)cudaGetLastError();
}

extern "C" const char* label_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
