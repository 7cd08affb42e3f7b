// The frontier-gated pull-ELL (min, +, max-rank) relaxation sweep over a
// source-windowed layout, for graphs whose [B, n] source planes outgrow
// the L2 cache. Written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ell_relax/ell_relax.py::
// _ell_relax_windowed_kernel (its body _relax_step), the TPU kernel that
// runs every construction sweep past one VMEM window.
//
// Bound on the H100: the gathers. The function reads the dist, mrank
// and prop planes, the adjacency and the rank row, and writes two
// planes, as the dense kernel does; but a sweep folds every (in-edge,
// live tree) pair, and each fold gathers prop[b, src] (and mrank[b, src]
// at a new minimum). The window keeps those gathers in L2: with 8 * B * n
// bytes of planes past the 50 MB L2, a gather from a source spread over
// all n would pull a 32 B sector from device memory. What is left is one
// L2 sector a (live tree, in-edge) on a graph whose sources scatter,
// whatever the frontier, and most of those gathers read a source whose
// prop is +inf (inactive or blocked), which folds as the identity. The
// activity mask skips them: a sparse sweep then costs about one byte
// gather an edge, for all the trees of a warp at once, instead of one
// word a live tree.
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
// - The activity mask, where the layout's gathers can pay for it (the
//   wrapper's mask_pays: sources scattered over many sectors, at most
//   GATE_TREES trees): before the first window, a pack pass in the same
//   C call writes one byte per (group of MASK_GROUP trees, vertex), bit
//   k of byte (g, v) set iff tree 8g + k is alive and prop[8g + k, v] is
//   finite, and counts the set bits per (window, group) into words reset
//   on the stream each sweep. Then one block chooses, for each (window,
//   group), the gated or the ungated fold (`choose_kernel`: the sector
//   gathers the mask saves against its loads and the gated fold's own
//   cost, two constants measured on the card). Skipping a clear bit is
//   exact: inf + w never lowers best, and mrank is gathered only at a
//   finite minimum. Elsewhere (a lattice in row order, whose gathers
//   crowd a few sectors) no mask is packed and the sweep runs as before.
// - One block per tile: a run of at most TILE_SEGS consecutive segments
//   of one window holding at most TILE_EDGES edges (layout.py cuts the
//   tiles once per graph and stores each tile's segment and edge
//   offsets, so a block's bounds are four independent loads). The block
//   stages the tile's metadata and edges in shared memory once, the
//   edges 16 B per thread and interleaved {source, weight} so that the
//   fold reads one 8 B word per edge. Each edge is read from device
//   memory once per sweep, not once per tree.
// - Ungated, a block spreads its (segment, tree) pairs over its threads
//   with the segment varying fastest, so each tree's loads of dist/mrank
//   and stores of the outputs stay coalesced; trees past the block's
//   width loop. A pair issues the row's own loads first, then folds its
//   edges four at a time: the four prop gathers are independent, and
//   mrank is gathered only at the candidates that attain the new
//   minimum.
// - Gated (a function of its own, so that its registers do not crowd
//   the ungated fold's), a block spreads (segment, live tree) pairs in
//   runs of CHUNK_SEGS consecutive segments, so that a warp holds
//   CHUNK_SEGS segments of WARP_TREES live trees: the lanes of one
//   segment read its sources' mask bytes in one request, each tree's row
//   loads still fill a sector, and no lane idles on a retired tree. A
//   pair gathers the mask bytes of four edges, then prop only at the set
//   bits. The retired trees' rows then copy through.
// - A segment longer than the layout's cut (block_cut, layout.py: 128
//   edges for batches of up to BLOCK_TREES trees, else the buffer) is a
//   tile alone (a hub's row in a window), and its block
//   folds it whole (`relax_block`, a function of its own): inside a
//   staged tile one thread a tree would fold it, up to hundreds of
//   dependent steps while the tile's other pairs are long done, and the
//   next window's resuming rows would wait on that block.
//   Consecutive threads read consecutive edges from device memory, once
//   each, and fold each edge for BLOCK_TREES trees at a time, so that
//   every edge load feeds that many independent prop gathers (where the
//   tree group is gated, after its mask byte). The warps then
//   combine their threads' (best, bm) by shuffles and the block its
//   warps' through shared memory: min, then max over the ranks that
//   attain it, exact and order-free, so that the result is still
//   bit-identical. Only then does one thread a tree wait for the row's
//   partial, so that the fold itself overlaps the previous window.
// - Only the gathers, which come from the window's slice, and the
//   fold's partials use L2 normally. Everything read or written once
//   (edges, metadata, rank, dist/mrank at the destination rows, the
//   final outputs) goes with evict-first hints (__ldcs/__stcs), so that
//   the stream does not push the slice out of L2.
// - The launches of one sweep are chained (programmatic dependent
//   launch): a window's blocks start while the previous window drains,
//   and only a pair that reads its row's partial waits for it. A row
//   whose first segment lies in this window has no earlier writer. The
//   pack pass runs before the first window in plain stream order.
// - Segment metadata is 9 B: row (i32), flags (u8), and the end of its
//   edges counted from the tile's first edge (i32; layout.py refuses a
//   tile past the i32 range).
// - Destinations without a finite in-edge copy through in extra blocks
//   of the last launch. Retired trees (alive[b] == 0) copy through at
//   the row's last segment. Every (tree, row) output is written each
//   sweep. Plane offsets b * n + v are 64-bit.

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
// windowed.py's MASK_GROUP: the trees one byte of the activity mask holds
constexpr int MASK_GROUP = 8;
// windowed.py's MASK_COST_PCT and SEGMENT_COST_PCT, the gating rule's two
// measured costs, in percent of one scattered prop gather (PERF.md: how
// they were found): a mask load that the lanes of WARP_TREES trees
// share, and the gated fold's own cost for each (segment, live tree)
constexpr int MASK_COST_PCT = 75;
constexpr int SEGMENT_COST_PCT = 150;
// windowed.py's GATE_TREES: the trees a sweep can gate (its live trees
// are one 64-bit word); a wider batch runs ungated
constexpr int GATE_TREES = 64;
// windowed.py's WARP_TREES: a warp of the gated mapping holds CHUNK_SEGS
// consecutive segments of each of WARP_TREES live trees, so that a tree's
// row loads fill a 32 B sector and the trees share a mask load
constexpr int WARP_TREES = 4;
constexpr int CHUNK_SEGS = 32 / WARP_TREES;

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

// The activity mask [G, n] bytes and what the pack pass chose: one word
// a window (bit g: group g gated) and the live trees. Only the masked
// kernel reads it.
struct Mask {
  const unsigned char* mask;
  const unsigned* window_gate;
  const unsigned long long* live;
};

// a tile's staged segments and edges
__shared__ int sh_row[TILE_SEGS];
__shared__ int sh_end[TILE_SEGS];
__shared__ unsigned char sh_flags[TILE_SEGS];
// {source, weight bits} per edge: one 8 B load per edge in the fold
__shared__ __align__(16) int2 sh_edge[EDGE_BUF];

__device__ __forceinline__ int source_of(const int2* e, int i) {
  return e[i].x;
}
__device__ __forceinline__ float weight_of(const int2* e, int i) {
  return __int_as_float(e[i].y);
}

// a retired tree's row (or a row with no finite in-edge) copied through
__device__ __forceinline__ void copy_through(const Planes& p, long long o) {
  __stcs(p.out_d + o, __ldcs(p.dist + o));
  __stcs(p.out_m + o, __ldcs(p.mrank + o));
}

// A row's fold (best, bm) into the outputs: at the row's last segment
// the epilogue (min with self, then keep / through max-rank merge) on
// its own dist d0, mrank m0 and rank rv; else the partial, which keeps
// L2's default policy, so that some partials are still there when the
// row's next window reads them.
__device__ __forceinline__ void store_row(const Planes& p, long long o,
                                          bool last, float best, int bm,
                                          float d0, int m0, int rv) {
  if (last) {
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

// The lexicographic fold of a candidate (c, r) into (best, bm): the
// minimum, and the largest rank among the candidates that attain it.
// (+inf, -1) is its identity, and a fold of partials in any order gives
// the same result.
__device__ __forceinline__ void fold_min_max(float& best, int& bm, float c,
                                             int r) {
  if (c < best) {
    best = c;
    bm = r;
  } else if (c == best) {
    bm = max(bm, r);
  }
}

// The lexicographic fold of one destination's segment for tree b, then
// either the partial into the outputs or, at the row's last segment,
// the epilogue. Edges are edges[lo, hi): {source, weight bits}. MASKED
// (a live tree on a gated window): each edge's source's byte of mg, b's
// group of the mask, comes first, one request for the lanes of the
// group, and prop only where ``bit`` is set; a clear bit is a source
// whose prop is +inf, which folds as the identity.
template <bool MASKED>
__device__ __forceinline__ void relax_pair(const Planes& p, long long b,
                                           int v, unsigned flags,
                                           const int2* edges, int lo,
                                           int hi,
                                           const unsigned char* mg = nullptr,
                                           unsigned bit = 0) {
  const long long o = b * p.n + v;
  const bool last = flags & 2u;
  if (!__ldg(p.alive + b)) {
    if (last) copy_through(p, o);
    return;
  }
  // the row's own loads go out before the gathers, which do not wait
  // for them
  float best = INFINITY, d0 = 0.0f;
  int bm = -1, m0 = -1, rv = 0;
  if (!(flags & 1u)) {
    // resume the row's fold where its previous window left it, once
    // that window's launch has finished
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
    if constexpr (MASKED) {
      unsigned hit = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = e + j < hi;
        sx[j] = in ? source_of(edges, e + j) : 0;
        if (in && (__ldg(mg + sx[j]) & bit)) hit |= 1u << j;
      }
      if (!hit) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = (hit >> j) & 1u ? __ldg(pb + sx[j]) + weight_of(edges, e + j)
                               : INFINITY;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = e + j < hi;
        const int2 ed = in ? edges[e + j] : make_int2(0, 0);
        sx[j] = ed.x;
        c[j] = in ? __ldg(pb + ed.x) + __int_as_float(ed.y) : INFINITY;
      }
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
  store_row(p, o, last, best, bm, d0, m0, rv);
}

// the k-th (from 0) set bit of x
__device__ __forceinline__ int nth_set(unsigned long long x, int k) {
  for (int i = 0; i < k; ++i) x &= x - 1;
  return __ffsll((long long)x) - 1;
}

// the segments of the staged tile, its edges from ``shift`` on
struct TileSegs {
  int shift;
  __device__ __forceinline__ int row(int s) const { return sh_row[s]; }
  __device__ __forceinline__ unsigned flags(int s) const {
    return sh_flags[s];
  }
  __device__ __forceinline__ int lo(int s) const {
    return s ? sh_end[s - 1] : 0;
  }
  __device__ __forceinline__ int hi(int s) const { return sh_end[s]; }
  __device__ __forceinline__ const int2* edges() const {
    return sh_edge + shift;
  }
};

// A gated block's pairs, a function of its own so that its registers
// do not crowd the ungated fold's: runs of CHUNK_SEGS consecutive
// segments, each run holding (segment, live tree) pairs with the segment
// fastest, so that a warp holds CHUNK_SEGS segments of WARP_TREES live
// trees (whose lanes at one segment read one mask byte) and each tree's
// row loads fill a sector; no lane idles on a retired tree. Each pair
// folds masked where its group is gated. Then the retired trees copy
// through at their rows' last segments.
__device__ __noinline__ void relax_gated(const Planes p, const Mask m,
                                         const unsigned gate, const int ns,
                                         const TileSegs seg) {
  const unsigned long long live = __ldg(m.live);
  const int tid = threadIdx.x, L = __popcll(live);
  const int run = CHUNK_SEGS * L;      // pairs of one run of segments
  const int runs = (ns + CHUNK_SEGS - 1) / CHUNK_SEGS;
  const int dr = THREADS % run, dc = THREADS / run;
  int r = tid % run, c = tid / run;
  for (int q = tid; q < runs * run; q += THREADS) {
    const int s = c * CHUNK_SEGS + r % CHUNK_SEGS;
    if (s < ns) {
      const int b = nth_set(live, r / CHUNK_SEGS);
      const int g = b / MASK_GROUP;
      if ((gate >> g) & 1u)
        relax_pair<true>(p, b, seg.row(s), seg.flags(s), seg.edges(),
                         seg.lo(s), seg.hi(s), m.mask + g * p.n,
                         1u << (b - g * MASK_GROUP));
      else
        relax_pair<false>(p, b, seg.row(s), seg.flags(s), seg.edges(),
                          seg.lo(s), seg.hi(s));
    }
    r += dr;
    c += dc;
    if (r >= run) {
      r -= run;
      ++c;
    }
  }
  if (L == p.B) return;
  for (int q = tid; q < ns * (int)p.B; q += THREADS) {
    const int s = q % ns, b = q / ns;
    if (!((live >> b) & 1ull) && (seg.flags(s) & 2u))
      copy_through(p, b * p.n + seg.row(s));
  }
}

// A block tile's block folds its segment BLOCK_TREES trees at a time
// (layout.py's BLOCK_TREES), and keeps each tree's block-wide fold in
// shared memory until the trees' rows are finished, for BLOCK_CHUNK
// trees at once. Both live in the
// staging buffer sh_edge, which a block tile does not use: first the
// warps' folds of two consecutive groups, then the chunk's.
constexpr int BLOCK_TREES = 4;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_PARTS = 2 * WARPS * BLOCK_TREES;
constexpr int BLOCK_CHUNK = 1024;
static_assert(BLOCK_PARTS + BLOCK_CHUNK <= EDGE_BUF,
              "the block fold's scratch must fit the edge buffer");

// A long segment, destination v and edges [lo, hi) of src / w, folded by
// the whole block. Thread t folds edges lo + t, lo + t + THREADS, ...
// (each edge read once, the warp's loads coalesced, the next edge's
// loads issued before this one's gathers) for the live trees of a group
// of BLOCK_TREES; where the window gates the group's mask group, prop is
// gathered only at the set bits of the source's mask byte. The warps
// combine their lanes' folds by shuffles, the block its warps' through
// shared memory (`fold_min_max`: exact, so the result does not depend on
// how the edges were split). Then one thread a tree resumes the row's
// partial where the segment is not the row's first (only now waiting for
// the previous window), and stores the row (`store_row`); retired trees
// copy through at the row's last segment.
template <bool MASKED>
__device__ __forceinline__ void relax_block_segment(
    const Planes& p, const Mask& m, const unsigned gate, const int v,
    const unsigned flags, const int* __restrict__ src,
    const float* __restrict__ w, const int lo, const int hi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool last = flags & 2u;
  int2* const part = sh_edge;                    // [2][WARPS][BLOCK_TREES]
  int2* const res = sh_edge + BLOCK_PARTS;       // [BLOCK_CHUNK]
  int k = 0;                                      // groups folded
  for (long long c0 = 0; c0 < p.B; c0 += BLOCK_CHUNK) {
    const long long c1 = min(p.B, c0 + BLOCK_CHUNK);
    for (long long b0 = c0; b0 < c1; b0 += BLOCK_TREES, ++k) {
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < BLOCK_TREES; ++j)
        if (b0 + j < c1 && __ldg(p.alive + b0 + j)) live |= 1u << j;
      // the group's byte of the mask, where its mask group is gated (a
      // group of BLOCK_TREES lies in one mask group)
      const unsigned char* mg = nullptr;
      if constexpr (MASKED) {
        if (b0 < GATE_TREES && ((gate >> (b0 / MASK_GROUP)) & 1u))
          mg = m.mask + b0 / MASK_GROUP * p.n;
      }
      const int shift = (int)(b0 % MASK_GROUP);
      const float* pb = p.prop + b0 * p.n;
      const int* mb = p.mrank + b0 * p.n;
      float best[BLOCK_TREES];
      int bm[BLOCK_TREES];
#pragma unroll
      for (int j = 0; j < BLOCK_TREES; ++j) {
        best[j] = INFINITY;
        bm[j] = -1;
      }
      if (live) {
        int e = lo + tid;
        int s = e < hi ? __ldcs(src + e) : 0;
        float we = e < hi ? __ldcs(w + e) : 0.0f;
        for (; e < hi; e += THREADS) {
          const int en = e + THREADS;
          const int sn = en < hi ? __ldcs(src + en) : 0;
          const float wn = en < hi ? __ldcs(w + en) : 0.0f;
          unsigned hit = live;
          if constexpr (MASKED) {
            if (mg) hit &= __ldg(mg + s) >> shift;
          }
          float c[BLOCK_TREES];
#pragma unroll
          for (int j = 0; j < BLOCK_TREES; ++j)
            c[j] = (hit >> j) & 1u ? __ldg(pb + j * p.n + s) + we
                                   : INFINITY;
          // mrank only where the candidate attains the tree's minimum
#pragma unroll
          for (int j = 0; j < BLOCK_TREES; ++j)
            if (c[j] <= best[j] && isfinite(c[j]))
              fold_min_max(best[j], bm[j], c[j], __ldg(mb + j * p.n + s));
          s = sn;
          we = wn;
        }
      }
      int2* const pk = part + (k & 1) * WARPS * BLOCK_TREES;
#pragma unroll
      for (int j = 0; j < BLOCK_TREES; ++j) {
        for (int off = 16; off; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[j], off);
          const int om = __shfl_xor_sync(0xffffffffu, bm[j], off);
          fold_min_max(best[j], bm[j], ob, om);
        }
        if (lane == 0)
          pk[warp * BLOCK_TREES + j] = make_int2(__float_as_int(best[j]),
                                                bm[j]);
      }
      // (the other half of part, which the next group writes, was read
      // before every thread passed this group's barrier)
      __syncthreads();
      if (tid < BLOCK_TREES && b0 + tid < c1) {
        float bb = INFINITY;
        int bbm = -1;
        for (int q = 0; q < WARPS; ++q) {
          const int2 x = pk[q * BLOCK_TREES + tid];
          fold_min_max(bb, bbm, __int_as_float(x.x), x.y);
        }
        res[b0 - c0 + tid] = make_int2(__float_as_int(bb), bbm);
      }
    }
    __syncthreads();
    for (long long b = c0 + tid; b < c1; b += THREADS) {
      const long long o = b * p.n + v;
      if (!__ldg(p.alive + b)) {
        if (last) copy_through(p, o);
        continue;
      }
      float best = __int_as_float(res[b - c0].x);
      int bm = res[b - c0].y;
      float d0 = 0.0f;
      int m0 = -1, rv = 0;
      if (last) {
        d0 = __ldcs(p.dist + o);
        m0 = __ldcs(p.mrank + o);
        rv = __ldcs(p.rank + v);
      }
      if (!(flags & 1u)) {
        // resume the row's partial, once the previous window is done
        wait_for_previous_window();
        fold_min_max(best, bm, p.out_d[o], p.out_m[o]);
      }
      store_row(p, o, last, best, bm, d0, m0, rv);
    }
    // the chunk's folds are read before the next chunk writes them
    __syncthreads();
  }
}

// A block tile's segments (the layout makes it one), each folded by the
// whole block. A function of its own, and the tile's last call, so that
// its registers do not crowd the tiled fold's: a call with the tile's
// values still live after it spills the tiled fold's registers and slows
// it (measured on the card).
template <bool MASKED>
__device__ __noinline__ void relax_block(const Planes p, const Mask m,
                                         const unsigned gate,
                                         const int* __restrict__ seg_row,
                                         const unsigned char* __restrict__
                                             seg_flags,
                                         const int* __restrict__ seg_end,
                                         const int ns,
                                         const int* __restrict__ src,
                                         const float* __restrict__ w) {
  for (int i = 0; i < ns; ++i)
    relax_block_segment<MASKED>(p, m, gate, __ldg(seg_row + i),
                                __ldg(seg_flags + i), src, w,
                                i ? __ldg(seg_end + i - 1) : 0,
                                __ldg(seg_end + i));
}

template <bool MASKED>
__device__ __forceinline__ void relax_tiles(
    Planes p, Mask m, long long wd, const int* __restrict__ seg_row,
    const unsigned char* __restrict__ seg_flags,
    const int* __restrict__ seg_end,
    const long long* __restrict__ tile_segs,
    const long long* __restrict__ tile_edges,
    const int* __restrict__ edge_src, const float* __restrict__ edge_w,
    long long E, long long tile_lo, long long num_tiles,
    const int* __restrict__ bare_rows, long long num_bare,
    long long block_cut) {
  const int tid = threadIdx.x;
  allow_next_window();

  if (blockIdx.x >= num_tiles) {
    // destinations without a finite in-edge: the sweep is the identity
    const long long i = (blockIdx.x - num_tiles) * (long long)THREADS + tid;
    if (i >= num_bare) return;
    const long long v = __ldcs(bare_rows + i);
    for (long long b = 0; b < p.B; ++b) copy_through(p, b * p.n + v);
    return;
  }

  // the tile's bounds (and the window's choice): loads that wait on none
  const long long t = tile_lo + blockIdx.x;
  const long long s0 = tile_segs[t];
  const int ns = (int)(tile_segs[t + 1] - s0);
  const long long e0 = tile_edges[t];
  const long long ne = tile_edges[t + 1] - e0;
  unsigned gate = 0;
  if constexpr (MASKED) gate = __ldg(m.window_gate + wd);

  const long long pairs = ns * p.B;
  // (segment, tree) pairs, the segment fastest: thread tid starts at
  // pair tid and strides by THREADS
  const int ds = THREADS % ns;
  const long long db = THREADS / ns;
  int s = tid % ns;
  long long b = tid / ns;

  if ((ns == 1 && ne > block_cut) || ns > TILE_SEGS || ne > TILE_EDGES) {
    // one segment longer than the layout's cut (the layout leaves it
    // alone in its tile), or a tile the buffers could not hold: the whole
    // block folds it from device memory
    relax_block<MASKED>(p, m, gate, seg_row + s0, seg_flags + s0,
                        seg_end + s0, ns, edge_src + e0, edge_w + e0);
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

  if constexpr (MASKED) {
    if (gate) {
      relax_gated(p, m, gate, ns, TileSegs{shift});
      return;
    }
  }
  for (long long q = tid; q < pairs; q += THREADS) {
    relax_pair<false>(p, b, sh_row[s], sh_flags[s], sh_edge + shift,
                      s ? sh_end[s - 1] : 0, sh_end[s]);
    s += ds;
    b += db;
    if (s >= ns) {
      s -= ns;
      ++b;
    }
  }
}

// The sweep's kernel, one launch a window. MASKED: the sweep packed the
// activity mask, and each block reads its window's choice. Unmasked:
// eight blocks per SM (32 registers a thread, a few spilled): on the
// road state this beats six blocks of 40 registers, on the random state
// it loses less than that gains. Masked: six, since the gated fold in
// the same kernel would spill the ungated one's registers at eight
// (PERF.md).
template <bool MASKED>
__global__ void __launch_bounds__(THREADS, MASKED ? 6 : 8) relax_tiles_kernel(
    Planes p, const int* __restrict__ seg_row,
    const unsigned char* __restrict__ seg_flags,
    const int* __restrict__ seg_end,
    const long long* __restrict__ tile_segs,
    const long long* __restrict__ tile_edges,
    const int* __restrict__ edge_src, const float* __restrict__ edge_w,
    long long E, long long tile_lo, long long num_tiles,
    const int* __restrict__ bare_rows, long long num_bare, Mask m,
    long long wd, long long block_cut) {
  relax_tiles<MASKED>(p, m, wd, seg_row, seg_flags, seg_end, tile_segs,
                      tile_edges, edge_src, edge_w, E, tile_lo, num_tiles,
                      bare_rows, num_bare, block_cut);
  wait_for_previous_window();
}

// The counts and choices the pack pass writes (i32 words of ``stats``):
// bits [nw, G] set bits per (window, group), gated [nw, G] each one's
// choice (1: gated), window_gate [nw] the choices as one word a window
// (bit g: group g), and live (2 words) the live trees.
struct Stats {
  int* bits;
  int* gated;
  unsigned* window_gate;
  unsigned long long* live;
};

// The choices, made by one block once the pack pass's counts are in. A
// (window, group) of L live trees over wv vertices with
// ``bits`` set bits has a finite-source density d = bits / (L * wv). In
// scattered prop gathers, the mask saves a (segment, live tree) pair
// gain * (1 - d) of them, and costs it gain * MASK_COST * ceil(L /
// WARP_TREES) / L in mask loads and SEGMENT_COST besides (``gain``: the
// layout's edges a segment times the distinct sectors its tiles' gathers
// touch an edge, windowed.py's gather_gain). Gated iff the saving is at
// least the cost.
__global__ void __launch_bounds__(THREADS) choose_kernel(
    Planes p, Stats st, long long window, long long nw, long long G,
    double gain) {
  unsigned long long live = 0;
  if (p.B <= GATE_TREES)
    for (int b = 0; b < (int)p.B; ++b)
      if (__ldg(p.alive + b)) live |= 1ull << b;
  if (threadIdx.x == 0) *st.live = live;
  for (long long wd = threadIdx.x; wd < nw; wd += THREADS) {
    const long long wv = min(window, p.n - wd * window);
    unsigned word = 0;
    for (long long g = 0; g < G; ++g) {
      const long long lg = g < GATE_TREES / MASK_GROUP
          ? __popcll((live >> (g * MASK_GROUP)) & 0xffull) : 0;
      const long long bits = st.bits[wd * G + g];
      // rounded step by step (no fused multiply-add), as windowed.py's
      // gated() computes it
      const double d = lg && wv > 0 ? (double)bits / (lg * wv) : 1.0;
      const double masks =
          (double)((lg + WARP_TREES - 1) / WARP_TREES) / max(lg, 1LL);
      const double saved = __dsub_rn(__dmul_rn(100.0, __dsub_rn(1.0, d)),
                                     __dmul_rn(MASK_COST_PCT, masks));
      const bool gated = lg && wv > 0 &&
          __dmul_rn(gain, saved) >= SEGMENT_COST_PCT;
      st.gated[wd * G + g] = gated;
      if (gated) word |= 1u << g;
    }
    st.window_gate[wd] = word;
  }
}

// The pack pass: a block packs PACK_WARPS runs of 32 consecutive
// vertices, one vertex a thread and run, into its byte of each group,
// and the set bits add up per (window, group), a warp at a time into
// shared counters (a run lies in one window: windows are multiples of
// 32 vertices), then a block at a time into the counts.
constexpr int PACK_WARPS = 32;
__global__ void __launch_bounds__(THREADS) pack_mask_kernel(
    Planes p, unsigned char* __restrict__ mask, Stats st, long long window,
    long long G) {
  __shared__ int sh_bits[PACK_WARPS];        // a window of the block's
  const int tid = threadIdx.x, lane = tid & 31;
  const long long v0 = blockIdx.x * (long long)(32 * PACK_WARPS);
  const long long wd0 = v0 / window;
  for (long long g = 0; g < G; ++g) {
    if (tid < PACK_WARPS) sh_bits[tid] = 0;
    __syncthreads();
    const long long b0 = g * MASK_GROUP;
    const int k_end = (int)min((long long)MASK_GROUP, p.B - b0);
    for (int j = 0; j < 32 * PACK_WARPS / THREADS; ++j) {
      const long long vr = v0 + (long long)j * THREADS + (tid & ~31);
      const long long v = vr + lane;
      unsigned byte = 0;
      if (v < p.n) {
        for (int k = 0; k < k_end; ++k)
          if (__ldg(p.alive + b0 + k) &&
              isfinite(__ldcs(p.prop + (b0 + k) * p.n + v)))
            byte |= 1u << k;
        mask[g * p.n + v] = (unsigned char)byte;
      }
      const unsigned cnt = __reduce_add_sync(0xffffffffu, __popc(byte));
      if (lane == 0 && cnt) atomicAdd(sh_bits + (vr / window - wd0), (int)cnt);
    }
    __syncthreads();
    if (tid < PACK_WARPS && sh_bits[tid])
      atomicAdd(st.bits + (wd0 + tid) * G + g, sh_bits[tid]);
  }
}

}  // namespace

// win_tiles is a host array of num_windows + 1 tile offsets. mask is
// [G, n] bytes (G = ceil(B / MASK_GROUP)) and stats 2 * num_windows * G
// + num_windows i32 words, padded to even, then 2 more (`Stats`), both
// written here; or both null, and the sweep packs no mask and gates no
// window. window is the layout's window width, a multiple of 32,
// block_cut its cut (a tile of one longer segment is folded by its whole
// block) and gain its gather gain (`choose_kernel`).
extern "C" int ell_relax_windowed_launch(
    const void* dist, const void* mrank, const void* prop,
    const void* alive, const void* seg_row, const void* seg_flags,
    const void* seg_end, const void* tile_segs, const void* tile_edges,
    const void* edge_src, const void* edge_w, const void* rank,
    const void* bare_rows, void* out_d, void* out_m, void* mask,
    void* stats, const long long* win_tiles, long long num_windows,
    long long num_bare, long long E, long long B, long long n,
    long long window, long long block_cut, double gain, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Planes p{(const float*)dist, (const int*)mrank, (const float*)prop,
                 (const unsigned char*)alive, (const int*)rank,
                 (float*)out_d, (int*)out_m, B, n};
  const long long nw = num_windows;
  Mask m{nullptr, nullptr, nullptr};
  cudaError_t err;
  if (mask != nullptr) {
    const long long G = (B + MASK_GROUP - 1) / MASK_GROUP;
    int* words = (int*)stats;
    // the live trees' word on an 8 B boundary (stats is 16 B aligned)
    const long long head = 2 * nw * G + nw + ((2 * nw * G + nw) & 1);
    const Stats sts{words, words + nw * G, (unsigned*)(words + 2 * nw * G),
                    (unsigned long long*)(words + head)};
    err = cudaMemsetAsync(stats, 0, nw * G * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const long long run = 32 * PACK_WARPS;
    pack_mask_kernel<<<(unsigned int)((n + run - 1) / run), THREADS, 0,
                       st>>>(p, (unsigned char*)mask, sts, window, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    choose_kernel<<<1, THREADS, 0, st>>>(p, sts, window, nw, G, gain);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    m = Mask{(const unsigned char*)mask, sts.window_gate, sts.live};
  }
  bool launched = false;
  for (long long wd = 0; wd < nw; ++wd) {
    const long long lo = win_tiles[wd], tiles = win_tiles[wd + 1] - lo;
    // the edgeless rows ride on the last window's launch
    const long long bare = wd + 1 == nw ? num_bare : 0;
    const long long blocks = tiles + (bare + THREADS - 1) / THREADS;
    if (blocks == 0) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = st;
    cudaLaunchAttribute chain;
    chain.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    chain.val.programmaticStreamSerializationAllowed = 1;
    // the first launch waits for the sweep's inputs (and the choices) as
    // any launch does
    cfg.attrs = &chain;
    cfg.numAttrs = launched ? 1 : 0;
    err = cudaLaunchKernelEx(
        &cfg, mask ? relax_tiles_kernel<true> : relax_tiles_kernel<false>, p,
        (const int*)seg_row,
        (const unsigned char*)seg_flags, (const int*)seg_end,
        (const long long*)tile_segs, (const long long*)tile_edges,
        (const int*)edge_src, (const float*)edge_w, E, lo, tiles,
        (const int*)bare_rows, bare, m, wd, block_cut);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launched = true;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ell_relax_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
