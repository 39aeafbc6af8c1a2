// Polygon-layer crossing counts over a (point tile, edge tile) pair list.
//
// Replaces the four Pallas kernels of geomesa_tpu/engine/pip_sparse.py:
//   _pip_grouped_call  (B6, _make_multi_kernel): per point tile, the union
//                      crossing count and band-flag count over its listed
//                      edge tiles                    -> pip_grouped_launch
//   _pip_assign_call   (B7, _make_assign_kernel): per-polygon parity, a
//                      running crossing count flushed at each polygon
//                      boundary (pinfo < 0) into assign += parity*(-pinfo)
//                      and count += parity, plus the band count
//                                                    -> pip_assign_launch
//   _pip_sparse_call   (B8, _sparse_kernel; B9, _sparse_band_kernel): the
//                      same crossing / band counts over a list of pairs in
//                      any order        -> pip_pairs_{count,band}_launch
//
// Tiles are 512 points and 512 edges (POINT_TILE == EDGE_TILE). Per point p
// of a tile and edge e (all f32, half-open rule, eps = the band width):
//   cond  = (y1 <= py) != (y2 <= py)
//   xc    = x1 + ((py - y1) / (y2 == y1 ? 1 : y2 - y1)) * (x2 - x1)
//   cross = cond && xc > px
//   flag  = (|py-y1| <= eps && |py-y2| <= eps
//            && px >= min(x1,x2) - eps && px <= max(x1,x2) + eps)
//           || (cond && |xc - px| <= eps * (1 + |x2-x1| / max(|y2-y1|, eps)))
// Counts are int32 sums of cross and flag over the edges. Every rounding
// step is an _rn intrinsic, so nvcc cannot contract x1 + t*(x2-x1) into an
// FMA, and min/max propagate NaN as torch.minimum/maximum do, so the
// counts equal the plain PyTorch versions (engine/pip_sparse_kernels.py)
// bit for bit. The source is self-contained (it repeats pip_crossing.cu's
// predicate and skip rule rather than sharing a header), so build.py's
// per-source hash covers everything it compiles.
//
// What bounds it on the H100. Every pair meets an 8 KB edge tile with the
// 512 points of its point tile: 2.6e5 tests per 8 KB, far above the card's
// ~20 FP32 operations per byte, so tested all-pairs it is bound by the
// FP32/ALU pipes (3.452e10 tests a launch at the config-2 shape). But an
// edge can cross or flag a point only if its y-span, widened by 2 eps,
// reaches the point's y, and a point tile (~2.8 degrees across at config
// 2) is larger than a polygon (~1 degree): of all tests only 0.04%
// straddle. Sorted by y inside the tile, 32 * kPerThread consecutive
// points span a thin strip that few edges reach.
//
// B6/B7 design (grouped_kernel; a launch is two kernels on one stream,
// the chunk_bounds prologue and grouped_kernel):
//   - the prologue writes each kChunk-edge chunk's (min y, max y) over the
//     edge table, NaN ends ignored, into a scratch the wrapper allocates
//     (a warp an edge tile, coalesced);
//   - one block a CSR row (a covered point tile and its edge tiles),
//     handed out longest row first (order[], computed by the wrapper on
//     the device), so the longest rows start first;
//   - the block sorts its tile's 512 points by y in shared memory (a
//     bitonic sort of 64-bit keys: y's order-preserving bits, NaN last,
//     then the slot); thread t of warp w holds sorted points
//     w * 32 * kPerThread + k * 32 + lane (k < kPerThread) in registers
//     with their slots, and writes its counts back to those slots. That is
//     the block's only synchronisation: from here each warp walks the row
//     on its own, with no block barrier, so no warp waits for another;
//   - each warp reduces its points' y-range with shuffles (NaN adds
//     nothing) and keeps its sorted y in shared memory; it reads the chunk
//     bounds of 32 edge tiles at a time (one chunk a lane, a ballot a
//     tile) and keeps the chunks that reach one of its points (a binary
//     search over its sorted y). Point by point, not by the warp's
//     y-range: a tile whose points lie in two clusters far apart in y
//     (Morton order joins such regions; chip_smoke.py prints the longest
//     config-2 row's span) gives one warp a range that reaches every edge
//     between them;
//   - each kept chunk is copied into a stage of the warp's own ring in
//     shared memory by cp.async (16 bytes a lane): the copies of the next
//     kStages - 1 kept chunks are in flight while one is tested, and a
//     __syncwarp orders each copy for the warp's lanes;
//   - lane j reads edge j of the arrived chunk once and writes its record:
//     the ends, the NaN-propagating x-span widened by eps, the
//     slope-inflated error (the record's one division) and a near-flat flag
//     (|y2 - y1| <= 4 eps in f64); a ballot keeps the edges that reach the
//     warp's y-range themselves (the same rule);
//   - the kept edges meet the thread's kPerThread points in two passes.
//     The first tests cond and, on flagged edges only, the near-flat term
//     (compares, no division), and marks in a bit mask the (edge, point)
//     tests where cond holds. The second works that mask off one test a
//     lane a round: the division, the crossing and the near-cross term.
//     A warp then waits on the division's latency once a round, not once
//     for every edge in which any lane straddles. Counts are popcounts of
//     the marks (kChunk * kPerThread <= 64).
//
// The skip rule (pip_crossing.cu's B5 rule). An edge with y-ends in
// [lo, hi] is out of reach of points with y in [ymin, ymax] when
//   lo - ymax > m || ymin - hi > m, in f64, with m = 2 eps.
// A warp skips a chunk that is out of reach of each of its points (ymin =
// ymax = y), and, in a chunk it keeps, an edge out of reach of its range.
// cross and near_cross need cond, i.e. min(y1,y2) <= py < max(y1,y2), so
// lo <= py <= hi: f32 values convert to f64 exactly, so lo - py <= 0 <= m
// and py - hi <= 0 <= m, and the rule keeps the edge at any m >= 0 (B8's
// m = 0 too: it keeps a point at an edge's lower y-end, where cond holds).
// near_flat needs |fl(py - y)| <= eps for both ends; f32 rounding is
// monotone with relative error 2^-24, so |py - y| <= eps (1 + 2^-23) < m,
// and the f64 difference of two f32 values rounds monotonically too, so
// the test can only keep more. Every edge that can cross or flag a point
// is kept. A NaN point adds nothing to the range and is never crossed or
// flagged; an edge with a NaN y-end crosses and flags nothing (every
// compare with that end is false and its xc is NaN); a chunk of NaN edges
// gets (+inf, -inf) and is skipped. Pad points (1e8) and pad edges (y =
// 1e9) are far out of each other's reach; a chunk that holds a polygon's
// last real edges and the first pad edges spans up to 1e9 and is kept by
// many warps, and the per-edge test drops its pad edges.
//
// kPerThread, kChunk, kThreads and kStages were fixed by a sweep on the
// H100 (P in {1, 2, 4}, C in {16, 32} with C * P <= 64, 512 points a
// block, 2 or 3 stages; PERF.md): the lowest B6 + B7 time. One point a
// thread gives the thinnest warps, which keep the fewest chunks.
//
// B8 and B9 walk a pair list in any order the same way: the wrapper turns
// it into one CSR row per point tile on the device (a stable sort by point
// tile, row pointers by binary search, the rows longest first), so each
// block owns its tile's output and writes it with plain stores (a
// duplicate pair is tested twice), and an empty row returns before it
// sorts. The TPU's first-visit zeroing existed because its grid ran in
// order; the pair list's launches add in the caller.
//   - B9 (grouped_kernel<false, false, true>) is B6's walk without the
//     crossings: it keeps the cond marks, which the near-cross term needs,
//     and drops the crossing compare and its popcount; the skip rule is
//     B6's as it is (a band flag needs the point within eps of the edge's
//     y-span, the reach is 2 eps).
//   - B8 (grouped_kernel<false, true, false>) is B6's walk with the
//     crossings only: the record is the edge's ends (no slope division, no
//     near-flat flag), pass one marks cond, pass two computes xc and
//     xc > px, and nothing of the band is computed or stored. Its wrapper
//     passes eps = 0, so the reach margin 2 eps is 0 and a warp keeps only
//     the chunks and edges whose y-span holds one of its points (the skip
//     rule's proof below, the crossing half, holds for any margin >= 0).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 512;
constexpr int kPerThread = 1;
constexpr int kChunk = 32;
constexpr int kThreads = 512;
constexpr int kStages = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpPoints = 32 * kPerThread;
constexpr int kChunks = kTile / kChunk;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kThreads * kPerThread == kTile, "512 points a block");
static_assert(kChunk == 16 || kChunk == 32, "a chunk is a half or a whole warp");
static_assert(kChunks <= 32, "one chunk a lane");
static_assert(kChunk * kPerThread <= 64, "one mark bit a test of a chunk");
static_assert((kPerThread & (kPerThread - 1)) == 0, "a power of two");
static_assert(kStages >= 2, "the current chunk and the next");

// torch.minimum / torch.maximum: NaN if either side is NaN, one
// instruction each (fminf/fmaxf would drop the NaN). They differ from torch
// only in the sign of a zero result, which no caller can see: each result
// is moved by eps or compared with eps > 0.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float crossing_x(float4 e, float py) {
  const float den = (e.w == e.y) ? 1.0f : __fsub_rn(e.w, e.y);
  const float t = __fdiv_rn(__fsub_rn(py, e.y), den);
  return __fadd_rn(e.x, __fmul_rn(t, __fsub_rn(e.z, e.x)));
}

// A staged edge: (x1, y1, x2, y2) and (min(x1,x2) - eps, max(x1,x2) + eps,
// err, 1 if the edge can be near-flat for some py).
struct Edge {
  float4 e;
  float4 b;
};

__device__ __forceinline__ Edge make_edge(float4 d, float eps) {
  const float slope = __fdiv_rn(fabsf(__fsub_rn(d.z, d.x)),
                                max_nan(fabsf(__fsub_rn(d.w, d.y)), eps));
  // near_flat puts both ends within eps (1 + 2^-23) of py, so it needs
  // |y2 - y1| <= 2 eps (1 + 2^-23) <= 4 eps, a bound the f64 difference
  // keeps (it rounds monotonically); a NaN end makes near_flat false
  const bool flat = fabs((double)d.w - (double)d.y) <= 4.0 * (double)eps;
  Edge r;
  r.e = d;
  r.b = make_float4(__fsub_rn(min_nan(d.x, d.z), eps),
                    __fadd_rn(max_nan(d.x, d.z), eps),
                    __fmul_rn(eps, __fadd_rn(1.0f, slope)),
                    flat ? 1.0f : 0.0f);
  return r;
}

// True when no point with y in [ymin, ymax] can be crossed or flagged by
// an edge whose y-ends lie in [lo, hi]: the skip rule of the header.
__device__ __forceinline__ bool out_of_reach(float lo, float hi, float ymin,
                                             float ymax, double margin) {
  return (double)lo - (double)ymax > margin
         || (double)ymin - (double)hi > margin;
}

// True when some point of a warp is not out of reach of [lo, hi] (the rule
// for a one-point range). ys: the warp's y, ascending, its n non-NaN
// values first. lo - y > m holds on a prefix of them (the f64 difference
// rounds monotonically), so a binary search finds the first point that
// is not below the span, and the span reaches some point exactly when it
// reaches that one.
__device__ __forceinline__ bool reaches(const float* ys, int n, float lo,
                                        float hi, double margin) {
  int i = 0;
#pragma unroll
  for (int step = kWarpPoints / 2; step > 0; step >>= 1)
    if (i + step - 1 < n && (double)lo - (double)ys[i + step - 1] > margin)
      i += step;
  if (i < n && (double)lo - (double)ys[i] > margin) ++i;
  return i < n && !((double)ys[i] - (double)hi > margin);
}

// Order-preserving bits of y, NaN last.
__device__ __forceinline__ unsigned y_key(float y) {
  if (y != y) return 0xffffffffu;
  const unsigned u = __float_as_uint(y);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a[k] for a k known only at run time, without an indexed register array
__device__ __forceinline__ float pick(const float (&a)[kPerThread], int k) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < kPerThread; ++i) v = k == i ? a[i] : v;
  return v;
}

// The mark bits of point k in a chunk's mask: bit j * kPerThread + k.
__device__ __forceinline__ unsigned long long point_bits(int k) {
  unsigned long long m = 0;
#pragma unroll
  for (int j = 0; j < 64; j += kPerThread) m |= 1ull << (j + k);
  return m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kStages - 1 committed groups (the newest) are in
// flight: the oldest, the chunk about to be tested, has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Requests chunk c of edge tile et (x1, y1, x2, y2: kChunk floats each, in
// 16-byte pieces, one a lane) into a warp's stage and commits the group;
// et < 0 commits an empty group, so that every lane commits one group a
// request and the chunk about to be tested is always the kStages-th
// newest.
__device__ __forceinline__ void request(float (*stage)[kChunk], const float* x1,
                                        const float* y1, const float* x2,
                                        const float* y2, int et, int c,
                                        int lane) {
  constexpr int kPieces = kChunk / 4;  // 16-byte pieces of one array
  if (et >= 0 && lane < 4 * kPieces) {
    const int a = lane / kPieces, off = (lane % kPieces) * 4;
    const float* src = a == 0 ? x1 : a == 1 ? y1 : a == 2 ? x2 : y2;
    cp_async16(&stage[a][off], src + (long long)et * kTile + c * kChunk + off);
  }
  cp_async_commit();
}

// (min y, max y) of each chunk, NaN ends ignored; a chunk of NaN edges
// gets (+inf, -inf) and is skipped everywhere. A warp an edge tile: 32
// consecutive edges a step (coalesced), reduced over kChunk lanes.
constexpr int kBoundsThreads = 256;
__global__ void __launch_bounds__(kBoundsThreads)
chunk_bounds(const float* __restrict__ y1, const float* __restrict__ y2,
             int n_etiles, float2* __restrict__ bounds) {
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * (kBoundsThreads / 32)
                         + (threadIdx.x >> 5);
  if (tile >= n_etiles) return;  // the whole warp leaves
  for (int i = 0; i < kTile; i += 32) {
    const long long j = tile * kTile + i + lane;
    const float a = y1[j], b = y2[j];
    float lo = fminf(fminf(CUDART_INF_F, a), b);
    float hi = fmaxf(fmaxf(-CUDART_INF_F, a), b);
#pragma unroll
    for (int o = kChunk / 2; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kAll, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kAll, hi, o));
    }
    if (lane % kChunk == 0) bounds[j / kChunk] = make_float2(lo, hi);
  }
}

// B6 <false, true, true>:  out0 = crossings, out2 = band.
// B7 <true, true, true>:   out0 = assign, out1 = count, out2 = band.
// B8 <false, true, false>: out0 = crossings (the band is not computed).
// B9 <false, false, true>: out2 = band.
// Outputs are zeroed by the wrapper: an empty row returns before it sorts.
template <bool kAssign, bool kCross, bool kBand>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ x1, const float* __restrict__ y1,
               const float* __restrict__ x2, const float* __restrict__ y2,
               const float2* __restrict__ bounds, const int* __restrict__ order,
               const int* __restrict__ rows, const int* __restrict__ row_ptr,
               const int* __restrict__ ets, const int* __restrict__ pinfo,
               int* __restrict__ out0, int* __restrict__ out1,
               int* __restrict__ out2, float eps) {
  __shared__ unsigned long long s_key[kTile];
  __shared__ float s_y[kTile];  // the tile's y, sorted (each warp its own)
  __shared__ __align__(16) float s_stage[kWarps][kStages][4][kChunk];
  __shared__ __align__(16) Edge s_rec[kWarps][kChunk];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = order[blockIdx.x];
  const long long base = (long long)rows[r] * kTile;
  const int m0 = row_ptr[r], m1 = row_ptr[r + 1];
  static_assert(kCross || kBand, "crossings, band flags or both");
  static_assert(kCross || !kAssign, "parity needs the crossings");
  if (m0 == m1) return;  // (uniform: the whole block leaves)

  // 1. sort the tile's points by y (bitonic, ascending, keys unique)
  for (int i = tid; i < kTile; i += kThreads)
    s_key[i] = ((unsigned long long)y_key(py[base + i]) << 32) | (unsigned)i;
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < kTile / 2; i += kThreads) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const unsigned long long u = s_key[a], v = s_key[a + j];
        if ((u > v) == ((a & k) == 0)) {
          s_key[a] = v;
          s_key[a + j] = u;
        }
      }
      __syncthreads();
    }
  }

  // 2. the thread's points; the warp's y-range (NaN adds nothing)
  float qx[kPerThread], qy[kPerThread];
  int slot[kPerThread], cross[kPerThread], band[kPerThread];
  int assign[kPerThread], count[kPerThread];
  float ymin = CUDART_INF_F, ymax = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    slot[k] = (int)(s_key[warp * kWarpPoints + k * 32 + lane] & (kTile - 1));
    qx[k] = px[base + slot[k]];
    qy[k] = py[base + slot[k]];
    s_y[warp * kWarpPoints + k * 32 + lane] = qy[k];
    ymin = fminf(ymin, qy[k]);
    ymax = fmaxf(ymax, qy[k]);
    cross[k] = band[k] = assign[k] = count[k] = 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(kAll, ymin, o));
    ymax = fmaxf(ymax, __shfl_xor_sync(kAll, ymax, o));
  }
  __syncwarp();  // the warp's s_y is written
  const float* ys = s_y + warp * kWarpPoints;  // NaN last
  int n_ys = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    n_ys += __popc(__ballot_sync(kAll, qy[k] == qy[k]));
  const double margin = 2.0 * (double)eps;
  float (*stage)[4][kChunk] = s_stage[warp];
  Edge* rec = s_rec[warp];
  unsigned issued = 0, tested = 0;  // requests and tested chunks (uniform)

  // 3. the row, 32 edge tiles at a time; every branch below is uniform
  //    across the warp, and warps never wait for each other
  for (int g0 = m0; g0 < m1; g0 += 32) {
    const int ng = min(32, m1 - g0);
    const int my_et = lane < ng ? ets[g0 + lane] : 0;
    const int my_info = (kAssign && lane < ng) ? pinfo[g0 + lane] : 0;
    // lane t gets the mask of the chunks of tile g0 + t that reach the
    // warp (the chunk bounds of 8 tiles are loaded before they are tested)
    unsigned my_live = 0;
    for (int t0 = 0; t0 < ng; t0 += 8) {
      float2 b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int et = __shfl_sync(kAll, my_et, (t0 + u) & 31);
        b[u] = (t0 + u < ng && lane < kChunks)
                   ? bounds[(long long)et * kChunks + lane]
                   : make_float2(CUDART_INF_F, -CUDART_INF_F);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        // (the warp's range first: it rules out most chunks at once)
        const unsigned live = __ballot_sync(
            kAll, lane < kChunks
                      && !out_of_reach(b[u].x, b[u].y, ymin, ymax, margin)
                      && reaches(ys, n_ys, b[u].x, b[u].y, margin));
        if (lane == t0 + u) my_live = live;
      }
    }
    // the request cursor walks the group's kept chunks in the order they
    // are tested, kStages - 1 ahead (empty requests past the last one)
    int at = 0;
    unsigned rest = __shfl_sync(kAll, my_live, 0);
    auto request_next = [&]() {
      if (!rest) {
        const unsigned later = __ballot_sync(kAll, lane > at && lane < ng
                                                 && my_live != 0);
        if (later) {
          at = __ffs(later) - 1;
          rest = __shfl_sync(kAll, my_live, at);
        }
      }
      const int et = __shfl_sync(kAll, my_et, at);
      const int c = __ffs(rest) - 1;
      request(stage[issued % kStages], x1, y1, x2, y2, rest ? et : -1, c,
              lane);
      rest &= rest - 1;
      ++issued;
    };
    tested = issued;  // the previous group's empty requests are never tested
#pragma unroll
    for (int q = 1; q < kStages; ++q) request_next();
    for (int t = 0; t < ng; ++t) {
      unsigned live = __shfl_sync(kAll, my_live, t);
      while (live) {
        live &= live - 1;
        request_next();
        cp_async_wait_oldest();
        __syncwarp();  // the chunk has landed for every lane; the previous
                       // chunk's records are consumed
        // lane j: edge j's record, and whether it reaches the warp
        const float (*in)[kChunk] = stage[tested++ % kStages];
        bool reach = false;
        if (lane < kChunk) {
          const float4 d = make_float4(in[0][lane], in[1][lane], in[2][lane],
                                       in[3][lane]);
          if (kBand)
            rec[lane] = make_edge(d, eps);
          else
            rec[lane].e = d;  // crossings need the ends alone
          reach = !out_of_reach(fminf(d.y, d.w), fmaxf(d.y, d.w), ymin, ymax,
                                margin);
        }
        unsigned edges = __ballot_sync(kAll, reach);
        __syncwarp();  // the records are written
        // pass 1: cond marks and the near-flat term (no division)
        unsigned long long marks = 0, flags = 0;
        while (edges) {
          const int j = __ffs(edges) - 1;
          edges &= edges - 1;
          const Edge e = rec[j];
          if (kBand && e.b.w != 0.0f) {  // one edge for every lane: no divergence
#pragma unroll
            for (int k = 0; k < kPerThread; ++k) {
              const bool f = fabsf(__fsub_rn(qy[k], e.e.y)) <= eps
                             && fabsf(__fsub_rn(qy[k], e.e.w)) <= eps
                             && qx[k] >= e.b.x && qx[k] <= e.b.y;
              flags |= (unsigned long long)f << (j * kPerThread + k);
            }
          }
#pragma unroll
          for (int k = 0; k < kPerThread; ++k) {
            const bool c1 = (e.e.y <= qy[k]) != (e.e.w <= qy[k]);
            marks |= (unsigned long long)c1 << (j * kPerThread + k);
          }
        }
        // pass 2: one marked test a lane a round
        unsigned long long crossed = 0, todo = marks;
        while (todo) {
          const int bit = __ffsll(todo) - 1;
          todo &= todo - 1;
          const int k = bit % kPerThread;
          const Edge e = rec[bit / kPerThread];
          const float x = pick(qx, k);
          const float xc = crossing_x(e.e, pick(qy, k));
          if (kCross) crossed |= (unsigned long long)(xc > x) << bit;
          if (kBand)
            flags |= (unsigned long long)(fabsf(__fsub_rn(xc, x)) <= e.b.z)
                     << bit;
        }
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (kCross) cross[k] += __popcll(crossed & point_bits(k));
          if (kBand) band[k] += __popcll(flags & point_bits(k));
        }
      }
      if (kAssign) {
        const int info = __shfl_sync(kAll, my_info, t);
        if (info < 0) {  // last edge tile of this polygon in the row: flush
#pragma unroll
          for (int k = 0; k < kPerThread; ++k) {
            const int parity = cross[k] & 1;
            assign[k] += parity * (-info);
            count[k] += parity;
            cross[k] = 0;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + slot[k];
    if (kAssign) {
      out0[i] = assign[k];
      out1[i] = count[k];
    } else if (kCross) {
      out0[i] = cross[k];
    }
    if (kBand) out2[i] = band[k];
  }
}

template <bool kAssign, bool kCross, bool kBand>
int launch_grouped(const void* px, const void* py, const void* x1,
                   const void* y1, const void* x2, const void* y2,
                   void* bounds, const void* order, const void* rows,
                   const void* row_ptr, const void* ets, const void* pinfo,
                   void* out0, void* out1, void* out2, int k, int n_etiles,
                   float eps, void* stream) {
  if (k <= 0) return 0;
  if (n_etiles <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int kTilesPerBlock = kBoundsThreads / 32;
  chunk_bounds<<<(n_etiles + kTilesPerBlock - 1) / kTilesPerBlock,
                 kBoundsThreads, 0, s>>>((const float*)y1, (const float*)y2,
                                         n_etiles, (float2*)bounds);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grouped_kernel<kAssign, kCross, kBand><<<k, kThreads, 0, s>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (const float2*)bounds,
      (const int*)order, (const int*)rows, (const int*)row_ptr,
      (const int*)ets, (const int*)pinfo, (int*)out0, (int*)out1, (int*)out2,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// B6. order/rows/row_ptr/ets: int32 CSR over k covered point tiles, order
// a permutation of the k rows (longest first); edge arrays of n_etiles
// whole tiles, 16-byte aligned; bounds: f32 scratch of 2 * n_etiles *
// (512 / kChunk) elements; counts, band: int32 [n_ptiles * 512], zeroed.
extern "C" int pip_grouped_launch(const void* px, const void* py,
                                  const void* x1, const void* y1,
                                  const void* x2, const void* y2,
                                  void* bounds, const void* order,
                                  const void* rows, const void* row_ptr,
                                  const void* ets, void* counts, void* band,
                                  int k, int n_etiles, float eps,
                                  void* stream) {
  return launch_grouped<false, true, true>(px, py, x1, y1, x2, y2, bounds,
                                           order, rows, row_ptr, ets, nullptr,
                                           counts, nullptr, band, k, n_etiles,
                                           eps, stream);
}

// B7. As B6, plus pinfo: int32 [m], the pair's polygon rank + 1, negated on
// the last edge tile of that polygon's run in its row. assign, count, band:
// int32 [n_ptiles * 512], zeroed.
extern "C" int pip_assign_launch(const void* px, const void* py,
                                 const void* x1, const void* y1,
                                 const void* x2, const void* y2, void* bounds,
                                 const void* order, const void* rows,
                                 const void* row_ptr, const void* ets,
                                 const void* pinfo, void* assign, void* count,
                                 void* band, int k, int n_etiles, float eps,
                                 void* stream) {
  return launch_grouped<true, true, true>(px, py, x1, y1, x2, y2, bounds,
                                          order, rows, row_ptr, ets, pinfo,
                                          assign, count, band, k, n_etiles, eps,
                                          stream);
}

// B8. The crossing counts of B6 over a pair list turned into one CSR row
// per point tile (rows: every tile 0..k-1; a tile's pairs in any order, a
// duplicate pair counted twice; row_ptr, ets, order and bounds as B6's);
// eps: the reach margin's half (0 from the wrapper); counts: int32
// [(n_ptiles + 1) * 512], zeroed.
extern "C" int pip_pairs_count_launch(const void* px, const void* py,
                                      const void* x1, const void* y1,
                                      const void* x2, const void* y2,
                                      void* bounds, const void* order,
                                      const void* rows, const void* row_ptr,
                                      const void* ets, void* counts, int k,
                                      int n_etiles, float eps, void* stream) {
  return launch_grouped<false, true, false>(px, py, x1, y1, x2, y2, bounds,
                                            order, rows, row_ptr, ets, nullptr,
                                            counts, nullptr, nullptr, k,
                                            n_etiles, eps, stream);
}

// B9. As B8, the band counts (eps: the band's width); band: int32
// [(n_ptiles + 1) * 512], zeroed.
extern "C" int pip_pairs_band_launch(const void* px, const void* py,
                                     const void* x1, const void* y1,
                                     const void* x2, const void* y2,
                                     void* bounds, const void* order,
                                     const void* rows, const void* row_ptr,
                                     const void* ets, void* band, int k,
                                     int n_etiles, float eps, void* stream) {
  return launch_grouped<false, false, true>(px, py, x1, y1, x2, y2, bounds,
                                            order, rows, row_ptr, ets, nullptr,
                                            nullptr, nullptr, band, k, n_etiles,
                                            eps, stream);
}
