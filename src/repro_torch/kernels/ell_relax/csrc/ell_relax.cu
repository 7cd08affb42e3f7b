// One frontier-gated pull-ELL (min, +, max-rank) relaxation sweep over a
// batch of B shortest-path trees, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ell_relax/ell_relax.py::_ell_relax_kernel
// (its body _relax_step), the TPU kernel behind every construction sweep
// whose two source planes fit half the L2 (kernels/ell_relax/ops.py).
//
// Bound on the H100: memory. Per sweep the function must read the dist,
// mrank and prop planes, the finite in-edges (8 B each) and the rank row,
// and write two planes (8 B per tree and vertex). Per in-edge the work
// is one f32 add and a few compares, far below the card's rate. On this
// route the planes fit the L2, so the gathers prop[b, src] and
// mrank[b, src] are L2 hits; what a sweep must wait for is their latency
// and the stream of the ELL and the destination rows.
//
// Design: (vertex, tree-group) work items.
// - A block owns a tile of TILE_V consecutive vertices and a chunk of
//   S * G trees (S tree slots of TILE_V threads; each thread takes G
//   trees of its vertex). The wrapper picks G and S from B * n and the SM
//   count (ell_relax.py::launch_geometry): G = 1 until the (tree, vertex)
//   items outnumber the card's resident threads several times over, so a
//   small sweep (the exactness build: B = 16, n = 4096, 256 blocks) still
//   spreads over the card, and the mid-size states (B = 4, n ~ 800K) take
//   G = 2 with two tree slots, all four trees in one block. The grid is 1-D: the blocks of one tile (its
//   tree chunks) are consecutive, so they read the tile's ELL rows from
//   L2 together.
// - The block stages the tile's ELL rows in shared memory once for all
//   its trees: the rows are one contiguous run, copied as 16 B vectors
//   with two in flight per thread and stored as interleaved {source,
//   weight} words, transposed (slot k of vertex r at k * TILE_V + r, so
//   that the threads of a tree row read consecutive words). Each row's
//   +inf padding tail is dropped (the row's count ends at its last finite
//   slot; an +inf slot inside a row makes no gather). rank is staged
//   beside them.
// - Threads are (tree slot, vertex) pairs with the vertex fastest, so the
//   loads of dist/mrank and the stores of the two output planes coalesce
//   along a tree's row.
// - A thread issues the row's own loads first, then the prop gathers of
//   a whole chunk of its in-edges (8, or 4 at G = 4) for all its trees
//   before
//   folding them, so that the gathers overlap; mrank is gathered only
//   where a candidate attains the new minimum.
// - A tile whose padded rows do not fit the edge buffer (TILE_V * deg >
//   EDGE_SLOTS, deg > 32) reads its rows from device memory in the fold
//   and skips the padding there.
// - Trees with alive[b] == 0 copy through without a gather (per-tree
//   retirement). Plane offsets b * n + v are 64-bit.
// Measured choices (PERF.md): the vector staging and the tail trim
// beat scalar staging with in-place compaction on both mid-size states;
// skipping the source loads of padding slots lost.
// All arithmetic is one f32 add plus min/max, so the result is
// bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ell_relax.py's TILE_V, MAX_SLOTS and EDGE_SLOTS
constexpr int TILE_V = 64;       // vertices per block
constexpr int MAX_SLOTS = 4;     // tree slots per block: <= 256 threads
constexpr int EDGE_SLOTS = 2048; // staged ELL slots (deg <= 32 at TILE_V)

struct Planes {
  const float* dist;
  const int* mrank;
  const float* prop;
  const unsigned char* alive;
  const int* src;
  const float* w;
  const int* rank;
  float* out_d;
  int* out_m;
  long long B, n, deg;
};

// the tile's rows, staged and compacted in shared memory
struct SharedEdges {
  const int2* sh;
  int r;
  __device__ __forceinline__ int2 operator()(int k) const {
    return sh[k * TILE_V + r];
  }
};

// the row read from device memory, padding included
struct GlobalEdges {
  const int* src;
  const float* w;
  __device__ __forceinline__ int2 operator()(int k) const {
    return make_int2(__ldg(src + k), __float_as_int(__ldg(w + k)));
  }
};

// The fold of vertex v for the thread's G trees b[g] (b[g] < 0: past B),
// over cnt in-edges, CH at a time, then the epilogue.
template <int G, int CH, class Edges>
__device__ __forceinline__ void relax_vertex(const Planes& p, long long v,
                                             int rv,
                                             const long long (&b)[G],
                                             const Edges& edges, int cnt) {
  long long o[G];
  float d0[G], best[G];
  int m0[G], bm[G];
  bool live[G];
  const float* pb[G];
  const int* mb[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    o[g] = b[g] * p.n + v;
    live[g] = b[g] >= 0 && __ldg(p.alive + b[g]);
    d0[g] = b[g] >= 0 ? __ldcs(p.dist + o[g]) : 0.0f;
    m0[g] = b[g] >= 0 ? __ldg(p.mrank + o[g]) : -1;
    best[g] = INFINITY;
    bm[g] = -1;
    pb[g] = p.prop + (b[g] >= 0 ? b[g] * p.n : 0);
    mb[g] = p.mrank + (b[g] >= 0 ? b[g] * p.n : 0);
  }
  for (int e = 0; e < cnt; e += CH) {
    int sx[CH];
    float wv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int2 ed = e + j < cnt ? edges(e + j)
                                  : make_int2(0, __float_as_int(INFINITY));
      sx[j] = ed.x;
      wv[j] = __int_as_float(ed.y);
    }
    // every gather of the chunk, for every tree, before any fold
    float c[G][CH];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < CH; ++j)
        c[g][j] = (live[g] && !isinf(wv[j])) ? __ldg(pb[g] + sx[j]) + wv[j]
                                              : INFINITY;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float nb = best[g];
#pragma unroll
      for (int j = 0; j < CH; ++j) nb = fminf(nb, c[g][j]);
      if (nb < best[g]) bm[g] = -1;   // the old minimum no longer attains
      best[g] = nb;
      if (isfinite(nb)) {
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (c[g][j] == nb) bm[g] = max(bm[g], __ldg(mb[g] + sx[j]));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (b[g] < 0) continue;
    if (!live[g]) {
      __stcs(p.out_d + o[g], d0[g]);
      __stcs(p.out_m + o[g], m0[g]);
      continue;
    }
    // epilogue: min with self, then keep / through max-rank merge
    const float nd = fminf(d0[g], best[g]);
    const int through = (best[g] <= nd && bm[g] >= 0) ? max(bm[g], rv) : -1;
    const int keep = (d0[g] <= nd) ? m0[g] : -1;
    __stcs(p.out_d + o[g], nd);
    __stcs(p.out_m + o[g], max(keep, through));
  }
}

// slot e of the tile's run (row e / deg, slot e % deg), transposed
__device__ __forceinline__ void stage_slot(int2* sh, int e, int deg, int src,
                                           int wbits) {
  const int r = e / deg;
  sh[(e - r * deg) * TILE_V + r] = make_int2(src, wbits);
}

template <int G>
__global__ void __launch_bounds__(TILE_V * MAX_SLOTS)
    ell_relax_kernel(Planes p, int S, long long chunks) {
  constexpr int CH = G == 4 ? 4 : 8;
  __shared__ __align__(16) int2 sh_edge[EDGE_SLOTS];
  __shared__ int sh_cnt[TILE_V];
  __shared__ int sh_rank[TILE_V];
  const int tid = threadIdx.x;
  const int nthreads = TILE_V * S;
  const long long tile = blockIdx.x / chunks;
  const long long chunk = blockIdx.x - tile * chunks;
  const long long v0 = tile * TILE_V;
  const int nv = (int)min((long long)TILE_V, p.n - v0);
  const int deg = (int)p.deg;
  const bool staged = TILE_V * p.deg <= EDGE_SLOTS;

  if (staged) {
    // the tile's padded rows are one contiguous run of nv * deg slots,
    // starting on a 16 B boundary (v0 * deg is a multiple of 4): copied
    // as 16 B vectors, two in flight per thread, then a scalar tail
    const long long base = v0 * p.deg;
    const int total = nv * deg;
    int done = 0;
    if ((((unsigned long long)p.src | (unsigned long long)p.w) & 15) == 0) {
      const int nvec = total >> 2;
      const int4* s4 = reinterpret_cast<const int4*>(p.src + base);
      const int4* w4 = reinterpret_cast<const int4*>(p.w + base);
      for (int q0 = tid; q0 < nvec; q0 += 2 * nthreads) {
        int4 sv[2], wv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = q0 + u * nthreads;
          if (q < nvec) {
            sv[u] = __ldcs(s4 + q);
            wv[u] = __ldcs(w4 + q);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = q0 + u * nthreads;
          if (q < nvec) {
            stage_slot(sh_edge, 4 * q, deg, sv[u].x, wv[u].x);
            stage_slot(sh_edge, 4 * q + 1, deg, sv[u].y, wv[u].y);
            stage_slot(sh_edge, 4 * q + 2, deg, sv[u].z, wv[u].z);
            stage_slot(sh_edge, 4 * q + 3, deg, sv[u].w, wv[u].w);
          }
        }
      }
      done = nvec << 2;
    }
    for (int e = done + tid; e < total; e += nthreads)
      stage_slot(sh_edge, e, deg, __ldcs(p.src + base + e),
                 __float_as_int(__ldcs(p.w + base + e)));
  }
  if (tid < nv) sh_rank[tid] = __ldcs(p.rank + v0 + tid);
  __syncthreads();
  if (staged && tid < nv) {
    // the row ends after its last finite slot
    int cnt = 0;
    for (int k = 0; k < deg; ++k)
      if (!isinf(__int_as_float(sh_edge[k * TILE_V + tid].y))) cnt = k + 1;
    sh_cnt[tid] = cnt;
  }
  __syncthreads();

  const int r = tid % TILE_V;
  if (r >= nv) return;
  const int s = tid / TILE_V;
  const long long v = v0 + r;
  // tree g of this thread: the chunk's base + g * S + s
  long long b[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long bg = chunk * S * G + (long long)g * S + s;
    b[g] = bg < p.B ? bg : -1;
  }
  if (staged)
    relax_vertex<G, CH>(p, v, sh_rank[r], b, SharedEdges{sh_edge, r},
                        sh_cnt[r]);
  else
    relax_vertex<G, CH>(p, v, sh_rank[r], b,
                        GlobalEdges{p.src + v * p.deg, p.w + v * p.deg},
                        deg);
}

}  // namespace

// G trees per thread (1, 2 or 4), S tree slots per block (1..MAX_SLOTS),
// blocks = ceil(n / TILE_V) * ceil(B / (S * G)): ell_relax.py's
// launch_geometry.
extern "C" int ell_relax_launch(const void* dist, const void* mrank,
                                const void* prop, const void* alive,
                                const void* src, const void* w,
                                const void* rank, void* out_d, void* out_m,
                                long long B, long long n, long long deg,
                                int G, int S, long long blocks,
                                void* stream) {
  if (S < 1 || S > MAX_SLOTS || blocks < 1 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Planes p{(const float*)dist, (const int*)mrank, (const float*)prop,
                 (const unsigned char*)alive, (const int*)src,
                 (const float*)w, (const int*)rank, (float*)out_d,
                 (int*)out_m, B, n, deg};
  const long long tiles = (n + TILE_V - 1) / TILE_V;
  const long long chunks = blocks / tiles;
  if (chunks * tiles != blocks || chunks * S * G < B)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks), block(TILE_V * S);
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 1: ell_relax_kernel<1><<<grid, block, 0, st>>>(p, S, chunks); break;
    case 2: ell_relax_kernel<2><<<grid, block, 0, st>>>(p, S, chunks); break;
    case 4: ell_relax_kernel<4><<<grid, block, 0, st>>>(p, S, chunks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ell_relax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
