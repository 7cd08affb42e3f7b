// The frontier-gated pull-ELL (min, +, max-rank) relaxation sweep over a
// source-windowed layout, for graphs whose [B, n] source planes outgrow
// the L2 cache. Written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ell_relax/ell_relax.py::
// _ell_relax_windowed_kernel (its body _relax_step), the TPU kernel that
// runs every construction sweep past one VMEM window.
//
// Bound on the H100: memory. The function reads the dist, mrank and prop
// planes, the adjacency and the rank row, and writes two planes, as the
// dense kernel does. What the window buys is where the gathers
// prop[b, src] / mrank[b, src] land: with sources spread over all n the
// planes (8 B per tree and vertex) miss the 50 MB L2 once 8 * B * n
// passes it, and every gather pulls a 32 B sector from device memory.
//
// Design: the TPU kernel stages a [BB, W] plane window in VMEM per
// (vertex tile, edge chunk). Carried over, a shared-memory window holds
// only ~7,000 vertices at B = 4, and with random sources every tile
// would stage every window. Instead the window here is a slice of the
// planes sized to half the L2 (layout.py), and the edges are walked
// window-major: one launch per window over the segments of that window
// (a segment is the run of one destination's finite in-edges whose
// sources lie in the window; its destinations ascend). While one window
// runs, its gathers stay in L2. A thread owns one segment and loops
// over the trees, like the dense kernel's thread per vertex. The running
// lexicographic (best, bm) fold of a destination lives in the output
// planes between its segments: the row's first segment starts it from
// (+inf, -1), its last segment runs the keep/through epilogue and
// writes the result. The fold is order-free over exact values, so the
// result is bit-identical to the dense kernel and to the plain version.
// The extra traffic is the fold's read-modify-write for destinations
// with edges in several windows. Destinations with no finite in-edge
// copy through in a last small launch. Retired trees (alive[b] == 0)
// copy through at the row's last segment. Offsets b * n + v and edge
// offsets are 64-bit. The adjacency carries no ELL padding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void relax_window_kernel(
    const float* __restrict__ dist, const int* __restrict__ mrank,
    const float* __restrict__ prop, const unsigned char* __restrict__ alive,
    const int* __restrict__ seg_row, const long long* __restrict__ seg_ptr,
    const unsigned char* __restrict__ seg_flags,
    const int* __restrict__ edge_src, const float* __restrict__ edge_w,
    const int* __restrict__ rank, float* __restrict__ out_d,
    int* __restrict__ out_m, long long B, long long n, long long seg_lo,
    long long seg_hi) {
  const long long i =
      seg_lo + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= seg_hi) return;
  const long long v = seg_row[i];
  const long long lo = seg_ptr[i];
  const long long hi = seg_ptr[i + 1];
  const unsigned flags = seg_flags[i];
  const bool first = flags & 1u;
  const bool last = flags & 2u;
  const int rv = last ? rank[v] : 0;
  for (long long b = 0; b < B; ++b) {
    const long long o = b * n + v;
    if (!alive[b]) {
      if (last) {
        out_d[o] = dist[o];
        out_m[o] = mrank[o];
      }
      continue;
    }
    const float* pb = prop + b * n;
    const int* mb = mrank + b * n;
    // resume the row's fold where its previous window left it
    float best = first ? INFINITY : out_d[o];
    int bm = first ? -1 : out_m[o];
    for (long long e = lo; e < hi; ++e) {
      const int s = edge_src[e];
      const float c = pb[s] + edge_w[e];
      if (c < best) {
        best = c;
        bm = isfinite(c) ? mb[s] : -1;
      } else if (c == best && isfinite(c)) {
        bm = max(bm, mb[s]);
      }
    }
    if (last) {
      // epilogue: min with self, then keep / through max-rank merge
      const float d0 = dist[o];
      const int m0 = mrank[o];
      const float nd = fminf(d0, best);
      const int through = (best <= nd && bm >= 0) ? max(bm, rv) : -1;
      const int keep = (d0 <= nd) ? m0 : -1;
      out_d[o] = nd;
      out_m[o] = max(keep, through);
    } else {
      out_d[o] = best;
      out_m[o] = bm;
    }
  }
}

// destinations without a finite in-edge: the sweep is the identity
__global__ void copy_rows_kernel(const float* __restrict__ dist,
                                 const int* __restrict__ mrank,
                                 const int* __restrict__ rows,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_m, long long count,
                                 long long B, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long v = rows[i];
  for (long long b = 0; b < B; ++b) {
    const long long o = b * n + v;
    out_d[o] = dist[o];
    out_m[o] = mrank[o];
  }
}

}  // namespace

// win_segs is a host array of num_windows + 1 segment offsets.
extern "C" int ell_relax_windowed_launch(
    const void* dist, const void* mrank, const void* prop,
    const void* alive, const void* seg_row, const void* seg_ptr,
    const void* seg_flags, const void* edge_src, const void* edge_w,
    const void* rank, const void* bare_rows, void* out_d, void* out_m,
    const long long* win_segs, long long num_windows, long long num_bare,
    long long B, long long n, void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  for (long long wd = 0; wd < num_windows; ++wd) {
    const long long lo = win_segs[wd], hi = win_segs[wd + 1];
    if (hi <= lo) continue;
    const long long blocks = (hi - lo + threads - 1) / threads;
    relax_window_kernel<<<(unsigned int)blocks, threads, 0, st>>>(
        (const float*)dist, (const int*)mrank, (const float*)prop,
        (const unsigned char*)alive, (const int*)seg_row,
        (const long long*)seg_ptr, (const unsigned char*)seg_flags,
        (const int*)edge_src, (const float*)edge_w, (const int*)rank,
        (float*)out_d, (int*)out_m, B, n, lo, hi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (num_bare > 0) {
    const long long blocks = (num_bare + threads - 1) / threads;
    copy_rows_kernel<<<(unsigned int)blocks, threads, 0, st>>>(
        (const float*)dist, (const int*)mrank, (const int*)bare_rows,
        (float*)out_d, (int*)out_m, num_bare, B, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ell_relax_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
