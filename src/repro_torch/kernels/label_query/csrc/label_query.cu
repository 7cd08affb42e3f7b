// Batched PPSD label intersection with the witnessing hub, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/label_query/label_query.py::_label_query_kernel
// (distance only there) together with the four row gathers in front of it
// (src/repro/kernels/label_query/ops.py, src/repro/core/labels.py::query_pairs,
// where XLA fuses them into the query). For query q with label rows (hu, du)
// of u and (hv, dv) of v, of padded width L:
//   dist[q] = min over hu[i] == hv[j] >= 0 of du[i] + dv[j]  (+inf if none)
//   hub[q]  = hu[i*] for the first row-major (i*, j*) attaining dist[q],
//             -1 when dist[q] is not finite.
//
// Two forms, one launch each:
// - table form: the kernel reads the rows itself from a label table
//   hubs/dist [n, L], count [n] at the int64 ids u[q], v[q]. A negative id
//   wraps once (as tensor indexing does); an id outside [-n, n) is a
//   device-side assert. The u-loop runs over [0, count[u]) and the v-loop
//   over [0, count[v]). A table keeps (-1, +inf) at and past count, so no
//   answer changes: a padding slot never matches a hub, and the first
//   (i, j) attaining the minimum lies below both counts.
// - operand form: row q of four [Q, L] operands, count = L.
//
// Bound on the H100: bytes. A query needs its two ids, two counts, the valid
// prefix of both rows (8 B a slot) and two outputs: 160 B at count = 8, so
// 65,536 road queries move 10.5 MB, 0.0031 ms at 3.35 TB/s. The
// count_u * count_v hub compares come near the bytes only for long full
// rows (L = count = 256: 4.3e9 compares at Q = 65,536, 0.064 ms at the f32
// rate, beside 0.081 ms of bytes). The rows lie scattered over the table, so each query
// is a chain of three dependent loads (ids, counts, rows); the design keeps
// many queries in flight and spends no lanes or loads on padding.
//
// Design:
// - short rows (L <= 32): a group of G = clamp(next_pow2(L), 4, 32) lanes
//   serves a query, 32 / G queries a warp. Lane k holds u-slot k and v-slot
//   k in registers, loaded only below the counts; the v-slots are broadcast
//   in the group with __shfl_sync(width = G) up to the warp's largest v
//   count, and a group-wide shuffle reduction picks the winner. No shared
//   memory.
// - long rows: one warp per query. The u-row's lines are prefetched into
//   L1 while the v-row is staged in shared memory up to count[v], tile by
//   tile (16 B vectors where L % 4 == 0 and the bases are 16 B aligned;
//   slots past the count are masked to -1); each lane then holds U <= 4
//   u-slots (i = lane + 32 s) in registers, U from the u count, and tests
//   them against four staged hubs per shared-memory load. On the H100
//   (exploratory builds at the exactness and synthetic L = 256 states) the
//   prefetch and the cap of 4 (fewer registers, more warps an SM) each took
//   about a tenth off; staging the u-row in shared memory as well lost, and
//   the short path's time did not move with loading a row before its count
//   arrived.
// Each lane keeps the lexicographic least (distance, i): the witness hub is
// hu[i*] whatever j* is, so i alone breaks ties, and -0.0 ties +0.0 as in
// amin/argmin. The one f32 add per match is the reference's own arithmetic,
// so distances are bit-identical.

#include <assert.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;
// v-slots a warp stages at once on the long path (a multiple of 4)
constexpr int kMaxTile = 1024;

struct Rows {
  const int* hu;
  const float* du;
  const int* cu;         // count of the u-side rows; null: every row is full
  const long long* iu;   // ids of the u-side rows; null: row q
  const int* hv;
  const float* dv;
  const int* cv;
  const long long* iv;
  long long n;           // rows of the table (the ids' range)
  long long Q;
  int L;
  int vec;               // 16 B loads of the v-row
  float* out_d;
  int* out_h;
};

__device__ __forceinline__ bool lex_less(float c, int i, float bc, int bi) {
  return c < bc || (c == bc && i < bi);
}

__device__ __forceinline__ long long row_of(const long long* ids,
                                            long long q, long long n) {
  if (ids == nullptr) return q;
  long long r = __ldg(ids + q);
  if (r < 0) r += n;
  assert(r >= 0 && r < n && "label_query: vertex id out of range");
  return r;
}

__device__ __forceinline__ int count_of(const int* count, long long r,
                                        int L) {
  return count == nullptr ? L : min(max(__ldg(count + r), 0), L);
}

// ------------------------------------------------------------ short rows

template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
    label_query_short_kernel(const Rows a) {
  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const long long q =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          (32 / G) + lane / G;
  const bool live = q < a.Q;
  long long ru = 0, rv = 0;
  int cu = 0, cv = 0;
  if (live) {
    ru = row_of(a.iu, q, a.n);
    rv = row_of(a.iv, q, a.n);
    cu = count_of(a.cu, ru, a.L);
    cv = count_of(a.cv, rv, a.L);
  }
  // -2 (u) and -1 (v) for an empty or negative slot: they never match
  int h = -2, hv = -1;
  float d = INFINITY, dv = INFINITY;
  if (k < cu) {
    h = __ldg(a.hu + ru * a.L + k);
    d = __ldg(a.du + ru * a.L + k);
    if (h < 0) h = -2;
  }
  if (k < cv) {
    hv = __ldg(a.hv + rv * a.L + k);
    dv = __ldg(a.dv + rv * a.L + k);
    if (hv < 0) hv = -1;
  }
  const int tv = (int)__reduce_max_sync(kFull, (unsigned)cv);
  float bc = INFINITY;
  for (int t = 0; t < tv; ++t) {
    const int ht = __shfl_sync(kFull, hv, t, G);
    const float dt = __shfl_sync(kFull, dv, t, G);
    if (ht == h) {
      const float c = d + dt;
      if (c < bc) bc = c;
    }
  }
  int bi = k;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(kFull, bc, off, G);
    const int oi = __shfl_xor_sync(kFull, bi, off, G);
    if (lex_less(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  const int hub = __shfl_sync(kFull, h, bi, G);
  if (live && k == 0) {
    a.out_d[q] = bc;
    a.out_h[q] = isfinite(bc) ? hub : -1;
  }
}

// ------------------------------------------------------------- long rows

__device__ __forceinline__ void take(float c, int i, int h, float& bc,
                                     int& bi, int& bh) {
  if (lex_less(c, i, bc, bi)) {
    bc = c;
    bi = i;
    bh = h;
  }
}

// U u-slots of this lane (i = i0 + lane + 32 s) against the staged v-tile
// of n4 four-slot words.
template <int U>
__device__ __forceinline__ void scan_slots(const int* hu_row,
                                           const float* du_row, int cu,
                                           int i0, int lane,
                                           const int* s_h, const float* s_d,
                                           int n4, float& bc, int& bi,
                                           int& bh) {
  int h[U];
  float d[U];
#pragma unroll
  for (int s = 0; s < U; ++s) {
    const int i = i0 + lane + 32 * s;
    h[s] = -2;
    d[s] = INFINITY;
    if (i < cu) {
      const int x = __ldg(hu_row + i);
      d[s] = __ldg(du_row + i);
      h[s] = x < 0 ? -2 : x;
    }
  }
  const int4* s_h4 = reinterpret_cast<const int4*>(s_h);
#pragma unroll 2
  for (int t4 = 0; t4 < n4; ++t4) {
    const int4 w = s_h4[t4];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int x = h[s];
      if ((w.x == x) | (w.y == x) | (w.z == x) | (w.w == x)) {
        const int i = i0 + lane + 32 * s;
        const int t = 4 * t4;
        if (w.x == x) take(d[s] + s_d[t], i, x, bc, bi, bh);
        if (w.y == x) take(d[s] + s_d[t + 1], i, x, bc, bi, bh);
        if (w.z == x) take(d[s] + s_d[t + 2], i, x, bc, bi, bh);
        if (w.w == x) take(d[s] + s_d[t + 3], i, x, bc, bi, bh);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    label_query_long_kernel(const Rows a, int tile) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= a.Q) return;  // the whole warp leaves together
  const long long ru = row_of(a.iu, q, a.n);
  const long long rv = row_of(a.iv, q, a.n);
  const int cu = count_of(a.cu, ru, a.L);
  const int cv = count_of(a.cv, rv, a.L);
  const int* hu_row = a.hu + ru * a.L;
  const float* du_row = a.du + ru * a.L;
  const int* hv_row = a.hv + rv * a.L;
  const float* dv_row = a.dv + rv * a.L;
  int* s_h = reinterpret_cast<int*>(smem) + (long long)warp * 2 * tile;
  float* s_d = reinterpret_cast<float*>(s_h + tile);
  const int slots = (cu + 31) / 32;  // u-slots per lane, warp-uniform
  // the u-row's lines into L1 while the v-row stages: its loads in
  // scan_slots then wait on L1, not on L2 or memory
  for (int i = 32 * lane; i < cu; i += 32 * 32) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(hu_row + i));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(du_row + i));
  }
  if (lane == 31 && cu > 0) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(hu_row + cu - 1));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(du_row + cu - 1));
  }

  float bc = INFINITY;
  int bi = INT_MAX, bh = -1;
  for (int j0 = 0; j0 < cv; j0 += tile) {
    const int tl = min(cv - j0, tile);
    const int n4 = (tl + 3) / 4;
    __syncwarp();
    if (a.vec) {
      const int4* src_h = reinterpret_cast<const int4*>(hv_row + j0);
      const float4* src_d = reinterpret_cast<const float4*>(dv_row + j0);
      for (int m = lane; m < n4; m += 32) {
        int4 x = __ldg(src_h + m);
        const int t = 4 * m;
        x.x = (t < tl && x.x >= 0) ? x.x : -1;
        x.y = (t + 1 < tl && x.y >= 0) ? x.y : -1;
        x.z = (t + 2 < tl && x.z >= 0) ? x.z : -1;
        x.w = (t + 3 < tl && x.w >= 0) ? x.w : -1;
        reinterpret_cast<int4*>(s_h)[m] = x;
        reinterpret_cast<float4*>(s_d)[m] = __ldg(src_d + m);
      }
    } else {
      for (int t = lane; t < 4 * n4; t += 32) {
        int x = -1;
        float y = INFINITY;
        if (t < tl) {
          x = __ldg(hv_row + j0 + t);
          y = __ldg(dv_row + j0 + t);
          if (x < 0) x = -1;
        }
        s_h[t] = x;
        s_d[t] = y;
      }
    }
    __syncwarp();
    for (int s0 = 0; s0 < slots;) {
      const int rem = slots - s0;
      const int i0 = 32 * s0;
      if (rem > 2) {
        scan_slots<4>(hu_row, du_row, cu, i0, lane, s_h, s_d, n4, bc, bi,
                      bh);
        s0 += 4;
      } else if (rem == 2) {
        scan_slots<2>(hu_row, du_row, cu, i0, lane, s_h, s_d, n4, bc, bi,
                      bh);
        s0 += 2;
      } else {
        scan_slots<1>(hu_row, du_row, cu, i0, lane, s_h, s_d, n4, bc, bi,
                      bh);
        s0 += 1;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(kFull, bc, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    const int oh = __shfl_xor_sync(kFull, bh, off);
    if (lex_less(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
      bh = oh;
    }
  }
  if (lane == 0) {
    a.out_d[q] = bc;
    a.out_h[q] = isfinite(bc) ? bh : -1;
  }
}

}  // namespace

// group: lanes per query (4, 8, 16 or 32; 32 with L > 32 is the long
// path); warps: warps per block (1..4); blocks: ceil(Q / queries a block).
extern "C" int label_query_launch(const void* hu, const void* du,
                                  const void* cu, const void* iu,
                                  const void* hv, const void* dv,
                                  const void* cv, const void* iv,
                                  void* out_d, void* out_h, long long n,
                                  long long Q, int L, int group, int warps,
                                  long long blocks, int vec, void* stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const Rows a{(const int*)hu, (const float*)du, (const int*)cu,
               (const long long*)iu, (const int*)hv, (const float*)dv,
               (const int*)cv, (const long long*)iv, n, Q, L, vec,
               (float*)out_d, (int*)out_h};
  const dim3 grid((unsigned int)blocks), block(32 * warps);
  const cudaStream_t s = (cudaStream_t)stream;
  if (L > 32) {
    if (group != 32) return (int)cudaErrorInvalidValue;
    const int tile = min((L + 3) / 4 * 4, kMaxTile);
    const size_t smem = (size_t)warps * 2 * tile * sizeof(int);
    label_query_long_kernel<<<grid, block, smem, s>>>(a, tile);
  } else {
    if (group < L) return (int)cudaErrorInvalidValue;
    switch (group) {
      case 4: label_query_short_kernel<4><<<grid, block, 0, s>>>(a); break;
      case 8: label_query_short_kernel<8><<<grid, block, 0, s>>>(a); break;
      case 16: label_query_short_kernel<16><<<grid, block, 0, s>>>(a); break;
      case 32: label_query_short_kernel<32><<<grid, block, 0, s>>>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* label_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
