// Even-odd point-in-polygon over an edge table, and its f32 ambiguity band.
//
// Replaces the two Pallas kernels of geomesa_tpu/engine/pip_pallas.py:
//   points_in_polygon_pallas       (B4, _pip_kernel): crossing parity
//   points_in_polygon_band_pallas  (B5, _pip_band_kernel): band flags
// One source, two entry points (pip_crossing_launch, pip_band_launch).
//
// What it computes, per point p and edge e (all f32, half-open rule):
//   cond = (y1 <= py) != (y2 <= py)
//   t    = (py - y1) / (y2 == y1 ? 1 : y2 - y1)
//   xc   = x1 + t * (x2 - x1)
//   B4:  out[p] = (count over e of cond && xc > px) is odd
//   B5:  out[p] = any over e of
//          near_flat = |py-y1| <= eps && |py-y2| <= eps
//                      && px >= min(x1,x2) - eps && px <= max(x1,x2) + eps
//          or cond && |xc - px| <= eps * (1 + |x2-x1| / max(|y2-y1|, eps))
// Every rounding step is written with an _rn intrinsic so nvcc cannot
// contract x1 + t*(x2-x1) into an FMA, and min/max propagate NaN as
// torch.minimum/maximum do: the result agrees bit for bit with the plain
// PyTorch version (engine/pip_kernels.py) and the reference's f32 kernel.
//
// What bounds it on the H100. Dense, the work is N*E pair tests (1.1e11
// at the density path's N = 1.007e8, E = 1088): the FP32/ALU pipes. But
// an edge can change a point's answer only if its y-span reaches the
// point's y. When the caller writes the rows in spatial (Z2-Morton)
// order, a block of consecutive points covers a thin y-strip that few
// edges reach (pow2 pad rows sit at (0, 0), far from any polygon of the
// data). The stores do not sort: they keep rows in write order within a
// partition, so that order is the caller's. The kernel skips, per block,
// every edge whose y-span misses the block's y-range: on the density
// path's Morton-ordered rows a block of 512 stages ~7 of 1088 edges and
// 57% of blocks stage none. What is left is bound by reading 8 bytes and
// writing 1 byte a point (0.27 ms at that shape) and, in practice, by
// the latency of each block's chain of loads and barriers (under 1 ms;
// PERF.md). Rows written in time order, or in no spatial order, make
// every block span the polygon and the work dense again; then each
// shared-memory edge read serves kPerThread points, and B5 pays its
// near-flat term only on the edges flat enough to be near-flat (a flag
// computed once an edge), which takes only 10-20% off the
// one-thread-a-point kernel's time on the H100 (PERF.md).
//
// Each launch is two kernels on the caller's stream: the chunk_bounds
// prologue and pip_kernel.
//
// The skip rule. A chunk (kChunk edges in table order) or an edge with
// y-ends in [lo, hi] is skipped for a block whose live points have y in
// [ymin, ymax] (NaN points add nothing: fminf/fmaxf) when
//   B4: lo > ymax || hi <= ymin.
//     Exact: cond needs min(y1,y2) <= py < max(y1,y2).
//   B5: lo - ymax > m || ymin - hi > m, in f64, with m = 2 eps.
//     near_cross needs cond, so it lies inside the B4 rule. near_flat
//     needs |fl(py - y)| <= eps for both ends; f32 rounding is monotone
//     with relative error 2^-24, so |py - y| <= eps (1 + 2^-23) < m, and
//     the f64 difference of two f32 values rounds monotonically too, so
//     the test can only keep more. Every edge that can flag a point is
//     kept.
// NaN. A NaN point adds nothing to the range and is never crossed or
// flagged. An edge with a NaN y-end crosses and flags nothing (every
// compare with that end is false and its xc is NaN), so skipping it or
// not changes nothing; the bounds take fminf/fmaxf, which ignore a NaN
// end, and a NaN bound skips nothing.
//
// Design:
//   - a prologue kernel writes each chunk's (min y, max y) over its real
//     edges into a scratch the wrapper allocates, on the same stream;
//   - a block of kThreads threads owns kPerThread * kThreads consecutive
//     points; thread t holds points base + t + k * kThreads in registers
//     (coalesced loads and byte stores), and the block reduces their
//     y-range with warp shuffles and shared memory;
//   - the block tests every chunk's bounds, compacts the survivors' ids
//     into shared memory (ballot), then stages only those chunks' edges,
//     one edge a thread a round, dropping each edge that misses the
//     y-range by the same rule and compacting the rest (ballot + one
//     shared atomic a warp) as float4 (B5 adds the per-edge x-span and
//     slope-inflated error, computed once an edge instead of once a
//     pair);
//   - every staged edge is tested against the thread's kPerThread points,
//     parity (B4) or flags (B5) kept as bits of one register; the
//     division runs only where cond holds (every term that reads t or xc
//     is ANDed with cond), and B5's near-flat term only on edges with
//     |y2 - y1| <= 4 eps (in f64), the only ones it can hold for (a
//     branch on the edge, the same for every thread).
// kChunk = 32, kPerThread = 4 and kThreads = 128 were fixed by a sweep on
// the H100 (C in {32, 64}, P in {1, 2, 4, 8}, T in {128, 256}; its table
// is in PERF.md): the lowest Morton-order time whose shuffled times stay
// below the one-thread-a-point kernel's. Larger blocks span more y and
// stage more edges; P = 1 pays a shared-memory read per pair.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kChunk = 32;
constexpr int kBlockPoints = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kPerThread >= 1 && kPerThread <= 32, "one bit a point");
static_assert((kChunk & (kChunk - 1)) == 0, "a power of two");

// A staged edge: (x1, y1, x2, y2), and for B5 (min(x1,x2) - eps,
// max(x1,x2) + eps, err, 1 if the edge can be near-flat for some py).
template <bool kBand> struct Edge { float4 e; };
template <> struct Edge<true> { float4 e; float4 b; };

// torch.minimum / torch.maximum: NaN if either side is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// True when no point with y in [ymin, ymax] can be crossed (B4) or
// flagged (B5) by an edge whose y-ends lie in [lo, hi]: the skip rule of
// the header.
template <bool kBand>
__device__ __forceinline__ bool out_of_reach(float lo, float hi, float ymin,
                                             float ymax, double margin) {
  if (kBand)
    return (double)lo - (double)ymax > margin
           || (double)ymin - (double)hi > margin;
  return lo > ymax || hi <= ymin;
}

__device__ __forceinline__ float crossing_x(float4 e, float py) {
  const float den = (e.w == e.y) ? 1.0f : __fsub_rn(e.w, e.y);
  const float t = __fdiv_rn(__fsub_rn(py, e.y), den);
  return __fadd_rn(e.x, __fmul_rn(t, __fsub_rn(e.z, e.x)));
}

__device__ __forceinline__ void stage(Edge<false>* dst, float4 d, float) {
  dst->e = d;
}

__device__ __forceinline__ void stage(Edge<true>* dst, float4 d, float eps) {
  const float slope = __fdiv_rn(fabsf(__fsub_rn(d.z, d.x)),
                                max_nan(fabsf(__fsub_rn(d.w, d.y)), eps));
  // near_flat puts both ends within eps (1 + 2^-23) of py, so it needs
  // |y2 - y1| <= 2 eps (1 + 2^-23) <= 4 eps, a bound the f64 difference
  // keeps (it rounds monotonically); a NaN end makes near_flat false
  const bool flat = fabs((double)d.w - (double)d.y) <= 4.0 * (double)eps;
  dst->e = d;
  dst->b = make_float4(__fsub_rn(min_nan(d.x, d.z), eps),
                       __fadd_rn(max_nan(d.x, d.z), eps),
                       __fmul_rn(eps, __fadd_rn(1.0f, slope)),
                       flat ? 1.0f : 0.0f);
}

// Test `ne` staged edges against the thread's points; bit k of `bits` is
// point k's parity (B4) or band flag (B5).
template <bool kBand>
__device__ __forceinline__ void test_edges(const Edge<kBand>* edges, int ne,
                                           const float (&qx)[kPerThread],
                                           const float (&qy)[kPerThread],
                                           unsigned& bits, float eps) {
  for (int j = 0; j < ne; ++j) {
    const Edge<kBand> r = edges[j];
    const float4 d = r.e;
    if constexpr (kBand) {
      // one edge for every thread: this branch does not diverge
      if (r.b.w != 0.0f) {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          bool f = fabsf(__fsub_rn(qy[k], d.y)) <= eps
                   && fabsf(__fsub_rn(qy[k], d.w)) <= eps
                   && qx[k] >= r.b.x && qx[k] <= r.b.y;
          if ((d.y <= qy[k]) != (d.w <= qy[k]))
            f = f || fabsf(__fsub_rn(crossing_x(d, qy[k]), qx[k])) <= r.b.z;
          bits |= (unsigned)f << k;
        }
      } else {  // near_flat is false for every point
#pragma unroll
        for (int k = 0; k < kPerThread; ++k)
          if ((d.y <= qy[k]) != (d.w <= qy[k]))
            bits |= (unsigned)(fabsf(__fsub_rn(crossing_x(d, qy[k]), qx[k]))
                               <= r.b.z) << k;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if ((d.y <= qy[k]) != (d.w <= qy[k]))
          bits ^= (unsigned)(crossing_x(d, qy[k]) > qx[k]) << k;
    }
  }
}

// (min y, max y) of each chunk's real edges, NaN ends ignored; a chunk
// of NaN edges gets (+inf, -inf) and is skipped everywhere.
__global__ void chunk_bounds(const float* __restrict__ y1,
                             const float* __restrict__ y2, int e, int nchunks,
                             float2* __restrict__ bounds) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  const int j1 = min(e - c * kChunk, kChunk) + c * kChunk;
  for (int j = c * kChunk; j < j1; ++j) {
    const float a = y1[j], b = y2[j];
    lo = fminf(lo, fminf(a, b));
    hi = fmaxf(hi, fmaxf(a, b));
  }
  bounds[c] = make_float2(lo, hi);
}

template <bool kBand>
__global__ void __launch_bounds__(kThreads)
pip_kernel(const float* __restrict__ px, const float* __restrict__ py,
           const float* __restrict__ x1, const float* __restrict__ y1,
           const float* __restrict__ x2, const float* __restrict__ y2,
           const float2* __restrict__ bounds, unsigned char* __restrict__ out,
           long long n, int e, float eps) {
  __shared__ Edge<kBand> s_edge[kThreads];
  __shared__ int s_chunk[kThreads];
  __shared__ float s_ymin[kWarps], s_ymax[kWarps];
  __shared__ int s_wcount[kWarps];
  __shared__ unsigned s_staged;  // edges staged so far (only grows)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  const long long base = (long long)blockIdx.x * kBlockPoints + tid;

  // the thread's points; a dead slot is NaN: no range, no flag, no write
  float qx[kPerThread], qy[kPerThread];
  float ymin = CUDART_INF_F, ymax = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + (long long)k * kThreads;
    qx[k] = i < n ? px[i] : 0.0f;
    qy[k] = i < n ? py[i] : CUDART_NAN_F;
    ymin = fminf(ymin, qy[k]);
    ymax = fmaxf(ymax, qy[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(kAll, ymin, o));
    ymax = fmaxf(ymax, __shfl_xor_sync(kAll, ymax, o));
  }
  if (lane == 0) {
    s_ymin[warp] = ymin;
    s_ymax[warp] = ymax;
  }
  if (tid == 0) s_staged = 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ymin = fminf(ymin, s_ymin[w]);
    ymax = fmaxf(ymax, s_ymax[w]);
  }

  const double margin = 2.0 * (double)eps;
  const int nchunks = (int)(((long long)e + kChunk - 1) / kChunk);
  unsigned bits = 0;
  unsigned consumed = 0;  // s_staged as of the last round (uniform)
  // Every loop bound below is uniform across the block, so each
  // __syncthreads and each full-warp ballot is reached by all threads.
  for (int g0 = 0; g0 < nchunks; g0 += kThreads) {
    // 1. which chunks of this group reach the block's y-range
    const int c = g0 + tid;
    bool keep = false;
    if (c < nchunks) {
      const float2 b = bounds[c];
      keep = !out_of_reach<kBand>(b.x, b.y, ymin, ymax, margin);
    }
    const unsigned kb = __ballot_sync(kAll, keep);
    if (lane == 0) s_wcount[warp] = __popc(kb);
    __syncthreads();
    int before = 0, kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = s_wcount[w];
      before += w < warp ? cw : 0;
      kept += cw;
    }
    if (keep) s_chunk[before + __popc(kb & below)] = c;
    __syncthreads();

    // 2. stage their edges that reach the y-range, a round of kThreads
    //    slots at a time, and test them
    const int slots = kept * kChunk;
    for (int r0 = 0; r0 < slots; r0 += kThreads) {
      const int s = r0 + tid;
      bool take = false;
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s < slots) {
        const int j = s_chunk[s / kChunk] * kChunk + s % kChunk;
        if (j < e) {
          d = make_float4(x1[j], y1[j], x2[j], y2[j]);
          take = !out_of_reach<kBand>(fminf(d.y, d.w), fmaxf(d.y, d.w), ymin,
                                      ymax, margin);
        }
      }
      const unsigned tb = __ballot_sync(kAll, take);
      unsigned at = 0;
      if (lane == 0 && tb) at = atomicAdd(&s_staged, (unsigned)__popc(tb));
      at = __shfl_sync(kAll, at, 0);
      if (take) stage(&s_edge[at - consumed + __popc(tb & below)], d, eps);
      __syncthreads();
      const unsigned ne = s_staged - consumed;
      test_edges<kBand>(s_edge, (int)ne, qx, qy, bits, eps);
      consumed += ne;
      __syncthreads();  // s_edge is rewritten by the next round
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < n) out[i] = (unsigned char)((bits >> k) & 1u);
  }
}

template <bool kBand>
int launch(const void* px, const void* py, const void* x1, const void* y1,
           const void* x2, const void* y2, void* out, void* bounds,
           long long bounds_len, long long n, int e, float eps, void* stream) {
  if (n <= 0) return 0;
  if (e < 0) return (int)cudaErrorInvalidValue;
  const long long nchunks = ((long long)e + kChunk - 1) / kChunk;
  if (bounds_len < 2 * nchunks) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kBlockPoints - 1) / kBlockPoints;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nchunks > 0) {
    chunk_bounds<<<(unsigned)((nchunks + 255) / 256), 256, 0, s>>>(
        (const float*)y1, (const float*)y2, e, (int)nchunks, (float2*)bounds);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pip_kernel<kBand><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (const float2*)bounds,
      (unsigned char*)out, n, e, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// out: uint8 [n] (a torch.bool tensor), 1 where the crossing count is odd.
// bounds: f32 scratch of bounds_len >= 2 * ceil(e / kChunk) elements.
extern "C" int pip_crossing_launch(const void* px, const void* py,
                                   const void* x1, const void* y1,
                                   const void* x2, const void* y2, void* out,
                                   void* bounds, long long bounds_len,
                                   long long n, int e, void* stream) {
  return launch<false>(px, py, x1, y1, x2, y2, out, bounds, bounds_len, n, e,
                       0.0f, stream);
}

// out: uint8 [n], 1 where some edge flags the point as boundary-ambiguous.
extern "C" int pip_band_launch(const void* px, const void* py, const void* x1,
                               const void* y1, const void* x2, const void* y2,
                               void* out, void* bounds, long long bounds_len,
                               long long n, int e, float eps, void* stream) {
  return launch<true>(px, py, x1, y1, x2, y2, out, bounds, bounds_len, n, e,
                      eps, stream);
}
