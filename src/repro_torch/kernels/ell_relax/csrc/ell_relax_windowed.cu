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
// Design. The window is a slice of the planes sized to half the L2
// (layout.py), and the edges are walked window-major: one launch per
// window over the segments of that window (a segment is the run of one
// destination's finite in-edges whose sources lie in the window; its
// destinations ascend), all from one C call. The running lexicographic
// (best, bm) fold of a destination lives in the output planes between
// its segments: the row's first segment starts it from (+inf, -1), its
// last segment runs the keep/through epilogue and writes the result.
// The fold is order-free over exact values, so the result is
// bit-identical to the dense kernel and to the plain version.
//
// - One block per tile: a run of at most TILE_SEGS consecutive segments
//   of one window holding at most TILE_EDGES edges (layout.py cuts the
//   tiles once per graph and stores each tile's segment and edge
//   offsets, so a block's bounds are four independent loads). The block
//   stages the tile's metadata and edges in shared memory once, the
//   edges 16 B per thread and interleaved {source, weight} so that the
//   fold reads one 8 B word per edge. It then spreads its (segment,
//   tree) pairs over its threads with the segment varying fastest, so
//   each tree's loads of dist/mrank and stores of the outputs stay
//   coalesced; trees past the block's width loop. Each edge is read from
//   device memory once per sweep, not once per tree.
// - A segment longer than the buffers is a tile alone, and that block
//   reads its edges from device memory.
// - A pair issues the row's own loads first, then folds its edges four
//   at a time: the four prop gathers are independent, and mrank is
//   gathered only at the candidates that attain the new minimum.
// - Only the gathers, which come from the window's slice, and the
//   fold's partials use L2 normally. Everything read or written once
//   (edges, metadata, rank, dist/mrank at the destination rows, the
//   final outputs) goes with evict-first hints (__ldcs/__stcs), so that
//   the stream does not push the slice out of L2.
// - The launches of one sweep are chained (programmatic dependent
//   launch): a window's blocks start while the previous window drains,
//   and only a pair that reads its row's partial waits for it. A row
//   whose first segment lies in this window has no earlier writer.
// - Segment metadata is 9 B: row (i32), flags (u8), and the end of its
//   edges counted from the tile's first edge (i32; layout.py refuses a
//   tile past the i32 range).
// - Destinations without a finite in-edge copy through in extra blocks
//   of the last launch. Retired trees (alive[b] == 0) copy through at
//   the row's last segment. Plane offsets b * n + v are 64-bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
// layout.py's TILE_SEGS and TILE_EDGES: the tile a block stages
constexpr int TILE_SEGS = 256;
constexpr int TILE_EDGES = 2048;
// the staged edges start at the 16 B boundary below the tile's first
// edge, up to 3 edges early, and end on a whole 16 B vector
constexpr int EDGE_BUF = TILE_EDGES + 8;

// Programmatic dependent launch between the windows of one sweep: a
// window's launch may start while the previous one drains. Only a
// segment that is not its row's first touches what an earlier window
// wrote (the row's partial), so only it waits, and every thread waits
// before it exits, so that the windows also finish in order.
__device__ __forceinline__ void allow_next_window() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_window() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

struct Planes {
  const float* dist;
  const int* mrank;
  const float* prop;
  const unsigned char* alive;
  const int* rank;
  float* out_d;
  int* out_m;
  long long B, n;
};

// The lexicographic fold of one destination's segment for tree b, then
// either the partial into the outputs or, at the row's last segment,
// the epilogue. Edges are edges[lo, hi): {source, weight bits}.
template <class Edges>
__device__ __forceinline__ void relax_pair(const Planes& p, long long b,
                                           int v, unsigned flags,
                                           const Edges& edges, int lo,
                                           int hi) {
  const long long o = b * p.n + v;
  const bool last = flags & 2u;
  if (!__ldg(p.alive + b)) {
    if (last) {
      __stcs(p.out_d + o, __ldcs(p.dist + o));
      __stcs(p.out_m + o, __ldcs(p.mrank + o));
    }
    return;
  }
  // the row's own loads go out before the gathers, which do not wait
  // for them
  float best = INFINITY, d0 = 0.0f;
  int bm = -1, m0 = -1, rv = 0;
  if (!(flags & 1u)) {
    // resume the row's fold where its previous window left it, once
    // that window's launch has finished; the partials keep L2's default
    // policy, so that some are still there when the row's next window
    // reads them
    wait_for_previous_window();
    best = p.out_d[o];
    bm = p.out_m[o];
  }
  if (last) {
    d0 = __ldcs(p.dist + o);
    m0 = __ldcs(p.mrank + o);
    rv = __ldcs(p.rank + v);
  }
  const float* pb = p.prop + b * p.n;
  const int* mb = p.mrank + b * p.n;
  for (int e = lo; e < hi; e += 4) {
    // four edges' prop gathers at once; mrank only where the candidate
    // attains the new minimum
    int sx[4];
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = e + j < hi;
      const int2 ed = in ? edges[e + j] : make_int2(0, 0);
      sx[j] = ed.x;
      c[j] = in ? __ldg(pb + ed.x) + __int_as_float(ed.y) : INFINITY;
    }
    const float nb = fminf(fminf(best, fminf(c[0], c[1])),
                           fminf(c[2], c[3]));
    if (nb < best) bm = -1;          // the old minimum no longer attains
    best = nb;
    if (isfinite(nb)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c[j] == nb) bm = max(bm, __ldg(mb + sx[j]));
    }
  }
  if (last) {
    // epilogue: min with self, then keep / through max-rank merge
    const float nd = fminf(d0, best);
    const int through = (best <= nd && bm >= 0) ? max(bm, rv) : -1;
    const int keep = (d0 <= nd) ? m0 : -1;
    __stcs(p.out_d + o, nd);
    __stcs(p.out_m + o, max(keep, through));
  } else {
    p.out_d[o] = best;
    p.out_m[o] = bm;
  }
}

// a lone segment's edges, read from device memory
struct GlobalEdges {
  const int* src;
  const float* w;
  __device__ __forceinline__ int2 operator[](int e) const {
    return make_int2(__ldg(src + e), __float_as_int(__ldg(w + e)));
  }
};

__device__ __forceinline__ void relax_tiles(
    Planes p, const int* __restrict__ seg_row,
    const unsigned char* __restrict__ seg_flags,
    const int* __restrict__ seg_end,
    const long long* __restrict__ tile_segs,
    const long long* __restrict__ tile_edges,
    const int* __restrict__ edge_src, const float* __restrict__ edge_w,
    long long E, long long tile_lo, long long num_tiles,
    const int* __restrict__ bare_rows, long long num_bare) {
  __shared__ int sh_row[TILE_SEGS];
  __shared__ int sh_end[TILE_SEGS];
  __shared__ unsigned char sh_flags[TILE_SEGS];
  // {source, weight bits} per edge: one 8 B load per edge in the fold
  __shared__ __align__(16) int2 sh_edge[EDGE_BUF];
  const int tid = threadIdx.x;
  allow_next_window();

  if (blockIdx.x >= num_tiles) {
    // destinations without a finite in-edge: the sweep is the identity
    const long long i = (blockIdx.x - num_tiles) * (long long)THREADS + tid;
    if (i >= num_bare) return;
    const long long v = __ldcs(bare_rows + i);
    for (long long b = 0; b < p.B; ++b) {
      const long long o = b * p.n + v;
      __stcs(p.out_d + o, __ldcs(p.dist + o));
      __stcs(p.out_m + o, __ldcs(p.mrank + o));
    }
    return;
  }

  // the tile's bounds: four loads, none waiting on another
  const long long t = tile_lo + blockIdx.x;
  const long long s0 = tile_segs[t];
  const int ns = (int)(tile_segs[t + 1] - s0);
  const long long e0 = tile_edges[t];
  const long long ne = tile_edges[t + 1] - e0;

  const long long pairs = ns * p.B;
  // (segment, tree) pairs, the segment fastest: thread tid starts at
  // pair tid and strides by THREADS
  const int ds = THREADS % ns;
  const long long db = THREADS / ns;
  int s = tid % ns;
  long long b = tid / ns;

  if (ns > TILE_SEGS || ne > TILE_EDGES) {
    // a lone segment longer than the buffers: edges from device memory
    for (long long q = tid; q < pairs; q += THREADS) {
      const long long i = s0 + s;
      relax_pair(p, b, __ldg(seg_row + i), __ldg(seg_flags + i),
                 GlobalEdges{edge_src + e0, edge_w + e0},
                 s ? __ldg(seg_end + i - 1) : 0, __ldg(seg_end + i));
      s += ds;
      b += db;
      if (s >= ns) {
        s -= ns;
        ++b;
      }
    }
    return;
  }

  for (int i = tid; i < ns; i += THREADS) {
    sh_row[i] = __ldcs(seg_row + s0 + i);
    sh_end[i] = __ldcs(seg_end + s0 + i);
    sh_flags[i] = __ldcs(seg_flags + s0 + i);
  }
  // the edges from the 16 B boundary at or below e0, whole vectors while
  // they lie inside the arrays
  const long long a0 = e0 & ~3LL;
  const int shift = (int)(e0 - a0);
  const int nvec = (int)((shift + ne + 3) >> 2);
  for (int k = tid; k < nvec; k += THREADS) {
    const long long e = a0 + 4LL * k;
    int4* dst = reinterpret_cast<int4*>(sh_edge + 4 * k);
    if (e + 4 <= E) {
      const int4 sv = __ldcs(reinterpret_cast<const int4*>(edge_src + e));
      const int4 wv = __ldcs(reinterpret_cast<const int4*>(edge_w + e));
      dst[0] = make_int4(sv.x, wv.x, sv.y, wv.y);
      dst[1] = make_int4(sv.z, wv.z, sv.w, wv.w);
    } else {
      for (int j = 0; j < 4 && e + j < E; ++j)
        sh_edge[4 * k + j] = make_int2(__ldcs(edge_src + e + j),
                                       __float_as_int(__ldcs(edge_w + e + j)));
    }
  }
  __syncthreads();

  for (long long q = tid; q < pairs; q += THREADS) {
    relax_pair(p, b, sh_row[s], sh_flags[s], sh_edge + shift,
               s ? sh_end[s - 1] : 0, sh_end[s]);
    s += ds;
    b += db;
    if (s >= ns) {
      s -= ns;
      ++b;
    }
  }
}

// eight blocks per SM (32 registers a thread, a few spilled): on the
// road state this beats six blocks of 40 registers, on the random state
// it loses less than that gains (PERF.md)
__global__ void __launch_bounds__(THREADS, 8) relax_tiles_kernel(
    Planes p, const int* __restrict__ seg_row,
    const unsigned char* __restrict__ seg_flags,
    const int* __restrict__ seg_end,
    const long long* __restrict__ tile_segs,
    const long long* __restrict__ tile_edges,
    const int* __restrict__ edge_src, const float* __restrict__ edge_w,
    long long E, long long tile_lo, long long num_tiles,
    const int* __restrict__ bare_rows, long long num_bare) {
  relax_tiles(p, seg_row, seg_flags, seg_end, tile_segs, tile_edges,
              edge_src, edge_w, E, tile_lo, num_tiles, bare_rows, num_bare);
  wait_for_previous_window();
}

}  // namespace

// win_tiles is a host array of num_windows + 1 tile offsets.
extern "C" int ell_relax_windowed_launch(
    const void* dist, const void* mrank, const void* prop,
    const void* alive, const void* seg_row, const void* seg_flags,
    const void* seg_end, const void* tile_segs, const void* tile_edges,
    const void* edge_src, const void* edge_w, const void* rank,
    const void* bare_rows, void* out_d, void* out_m,
    const long long* win_tiles, long long num_windows, long long num_bare,
    long long E, long long B, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Planes p{(const float*)dist, (const int*)mrank, (const float*)prop,
                 (const unsigned char*)alive, (const int*)rank,
                 (float*)out_d, (int*)out_m, B, n};
  bool launched = false;
  for (long long wd = 0; wd < num_windows; ++wd) {
    const long long lo = win_tiles[wd], tiles = win_tiles[wd + 1] - lo;
    // the edgeless rows ride on the last window's launch
    const long long bare = wd + 1 == num_windows ? num_bare : 0;
    const long long blocks = tiles + (bare + THREADS - 1) / THREADS;
    if (blocks == 0) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = st;
    cudaLaunchAttribute chain;
    chain.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    chain.val.programmaticStreamSerializationAllowed = 1;
    // the first launch waits for the sweep's inputs as any launch does
    cfg.attrs = &chain;
    cfg.numAttrs = launched ? 1 : 0;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, relax_tiles_kernel, p, (const int*)seg_row,
        (const unsigned char*)seg_flags, (const int*)seg_end,
        (const long long*)tile_segs, (const long long*)tile_edges,
        (const int*)edge_src, (const float*)edge_w, E, lo, tiles,
        (const int*)bare_rows, bare);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launched = true;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ell_relax_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
