// One frontier-gated pull-ELL (min, +, max-rank) relaxation sweep over a
// batch of B shortest-path trees, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ell_relax/ell_relax.py::_ell_relax_kernel
// (its body _relax_step), the TPU kernel behind every construction sweep.
//
// Bound on the H100: memory. Per sweep the function must read the dist,
// mrank and prop planes (12 B per tree and vertex), the ELL rows (8 B per
// slot) and the rank row, and write two planes (8 B per tree and vertex):
// n * (8 * deg + 20 * B + 4) bytes. Per in-edge the work is one f32 add
// and a few compares, far below the card's rate, and the gathers
// prop[b, src] / mrank[b, src] at in-edge sources are the irregular part.
//
// Design: one thread per vertex v. Consecutive threads own consecutive
// vertices, so the loads of dist/mrank and the stores of the new planes
// coalesce. A thread reads its ELL row once per tree; the row (32 B at
// deg 8) stays in L1 across the loop over trees. Padding slots (weight
// +inf) are skipped without a gather. Trees with alive[b] == 0 copy
// through without touching the ELL. All arithmetic is one f32 add plus
// min/max, so the result is bit-identical to the plain PyTorch version.
// Offsets b * n + v are 64-bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void ell_relax_kernel(const float* __restrict__ dist,
                                 const int* __restrict__ mrank,
                                 const float* __restrict__ prop,
                                 const unsigned char* __restrict__ alive,
                                 const int* __restrict__ src,
                                 const float* __restrict__ w,
                                 const int* __restrict__ rank,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_m,
                                 long long B, long long n, long long deg) {
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int* row_s = src + v * deg;
  const float* row_w = w + v * deg;
  const int rv = rank[v];
  for (long long b = 0; b < B; ++b) {
    const long long o = b * n + v;
    const float d0 = dist[o];
    const int m0 = mrank[o];
    if (!alive[b]) {
      out_d[o] = d0;
      out_m[o] = m0;
      continue;
    }
    const float* pb = prop + b * n;
    const int* mb = mrank + b * n;
    // lexicographic fold over the in-edges: the least candidate
    // distance, and the max source mrank among finite candidates that
    // attain it (-1 if none)
    float best = INFINITY;
    int bm = -1;
    for (long long k = 0; k < deg; ++k) {
      const float wk = row_w[k];
      if (isinf(wk)) continue;  // padding: its candidate is +inf
      const int s = row_s[k];
      const float c = pb[s] + wk;
      if (c < best) {
        best = c;
        bm = isfinite(c) ? mb[s] : -1;
      } else if (c == best && isfinite(c)) {
        bm = max(bm, mb[s]);
      }
    }
    // epilogue: min with self, then keep / through max-rank merge
    const float nd = fminf(d0, best);
    const int through = (best <= nd && bm >= 0) ? max(bm, rv) : -1;
    const int keep = (d0 <= nd) ? m0 : -1;
    out_d[o] = nd;
    out_m[o] = max(keep, through);
  }
}

}  // namespace

extern "C" int ell_relax_launch(const void* dist, const void* mrank,
                                const void* prop, const void* alive,
                                const void* src, const void* w,
                                const void* rank, void* out_d, void* out_m,
                                long long B, long long n, long long deg,
                                void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  ell_relax_kernel<<<(unsigned int)blocks, threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)dist, (const int*)mrank, (const float*)prop,
      (const unsigned char*)alive, (const int*)src, (const float*)w,
      (const int*)rank, (float*)out_d, (int*)out_m, B, n, deg);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_relax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
