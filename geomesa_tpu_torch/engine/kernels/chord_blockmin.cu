// Chord-key block minima for the fused kNN scan, dense and sparse.
//
// Replaces the two Pallas kernels of geomesa_tpu/engine/knn_scan.py:
//   chord_blockmin         (B2, _make_kernel + _chunk_body): every data tile
//                          -> chord_blockmin_dense_kernel
//   chord_blockmin_sparse  (B1, _make_sparse_kernel): the data tiles named
//                          by tile_ids[p] for p < n_sel; slots p >= n_sel
//                          write exactly PENALTY and read no data
//                          -> chord_blockmin_kernel
//
// What both compute, per query q and per blk-lane block b of the points:
//   d   = unit3(lon, lat) - c                     (f32 prelude, per point)
//   ndm = |d|^2 + (1 - mask) * PENALTY
//   key = aug_q[q] . [dx, dy, dz, ndm]            (aug_q[q][3] == 1)
//   out[q, b] = min over the block's lanes of key
// in full FP32: no TF32, no tensor cores (the reference uses
// Precision.HIGHEST), and no fast-math intrinsics. Every minimum
// propagates NaN (min.NaN.f32), as the plain version's torch.amin does.
//
// What bounds them on the H100: the FP32 pipes. Each point is read once
// (12 bytes) but feeds Q keys of 3 FMAs and a min each, so at Q = 256 the
// kernels do ~340 FP32 operations per byte read, far above the card's
// ~20 FP32 operations per byte of HBM bandwidth. A warp issues one
// instruction a cycle, so 4 instructions a key is the floor.
//
// B2 design (chord_blockmin_dense_kernel): queries across lanes, points
// broadcast from shared memory.
//   - a block holds kDQB = 256 queries, kQL = 8 a lane (query j * 32 +
//     lane), their (ax, ay, az) and running minima in registers; a launch
//     with more queries has a second row of blocks;
//   - a block walks a contiguous run of chunks of the points (a persistent
//     grid: as many blocks as fit on the card at once, each a near-equal
//     share). A chunk is cb <= 16 blk-blocks, at most 2048 points; its
//     prelude [dx, dy, dz, ndm] is computed once per point per launch (one
//     thread a point, sincosf twice) into one of two shared buffers, while
//     the raw x, y and mask of the next chunk are loaded into registers
//     before the fold of this one, and turned into its prelude after: one
//     barrier a chunk;
//   - a warp folds whole segments of a chunk (a blk-block, or 1/r of one
//     when a chunk has fewer than 8 blocks): each point's float4 is one
//     shared-memory broadcast (every lane reads the same address) that
//     feeds 8 keys, a key is fmaf(ax, dx, fmaf(ay, dy, fmaf(az, dz, ndm)))
//     and a min (aug_q[q][3] == 1 adds ndm as it is), and no shuffle
//     reduces anything: each lane owns its queries' minima;
//   - a segment's minima go to a shared [query][segment] table (row stride
//     odd: no bank conflicts), and after the barrier the block writes each
//     query's row segment of the chunk (cb minima, 64 bytes at blk = 128)
//     with a half-warp a row, lane b on column b, so the [Q, N/blk]
//     output is written in whole sectors, not 4 bytes a 32-byte sector.
// The key loop is 24 FFMA, 8 FMNMX and one LDS.128 a point, and 2048-point
// chunks (2 blocks an SM, 125 registers), the half-warp row writes and
// sincosf were each faster than 1024-point chunks (3 blocks an SM), a
// division per output element, and sinf/cosf, on the H100
// (scripts/torch_knn_dense_sweep.py; PERF.md).
//
// B1 (chord_blockmin_kernel, unchanged since its port): a block owns one
// data tile (slot p) and QB = 64 queries; 8 warps own QW = 8 queries each,
// kept in registers; the tile is swept in chunks of up to 2048 points whose
// prelude is staged in shared memory once per block, so the trigonometry
// runs once per point per query group; within a chunk, for each blk-lane
// block, every lane loads its blk / 32 points and folds them into the QW
// queries' keys; a warp shuffle takes each query's minimum, and lane b
// keeps block b's minimum so the row segment is written with one coalesced
// store; the sparse guard reads n_sel from device memory: no host sync.
// (Its dense branch, tile_ids null, has no caller.)

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQW = 8;                 // queries per warp
constexpr int kQB = kWarps * kQW;      // queries per block
constexpr int kChunkPts = 2048;        // staged points per chunk (32 KB)
constexpr float kPenalty = 1e9f;
constexpr float kDeg2Rad = 0.017453292519943295f;

// The minimum of a and b, NaN if either is NaN, as torch.amin (the plain
// version) and the reference's jnp.min take it: a row with a NaN
// coordinate makes its block's minimum NaN. fminf would drop it.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(kThreads)
chord_blockmin_kernel(const float* __restrict__ aug_q,    // [q, 4]
                      const float* __restrict__ c,        // [3]
                      const float* __restrict__ x,        // [n]
                      const float* __restrict__ y,        // [n]
                      const float* __restrict__ maskf,    // [n]
                      const int* __restrict__ tile_ids,   // [slots] or null
                      const int* __restrict__ n_sel,      // [1] or null
                      float* __restrict__ out,            // [q, slots * nbt]
                      int q, int blk, int data_tile, int bpc) {
  __shared__ float4 pts[kChunkPts];
  __shared__ float4 aq[kQB];

  const int slot = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int nbt = data_tile / blk;                       // blocks per tile
  const long long out_cols = (long long)gridDim.x * nbt;
  const long long col0 = (long long)slot * nbt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  long long tile = slot;
  if (tile_ids != nullptr) {
    if (slot >= *n_sel) {
      // dead capacity slot: exactly PENALTY, no data read
      for (int i = threadIdx.x; i < kQB * nbt; i += kThreads) {
        const int qi = i / nbt;
        if (q0 + qi < q) out[(long long)(q0 + qi) * out_cols + col0 + i % nbt] = kPenalty;
      }
      return;
    }
    tile = tile_ids[slot];
  }

  for (int i = threadIdx.x; i < kQB; i += kThreads) {
    aq[i] = (q0 + i < q)
        ? make_float4(aug_q[4 * (q0 + i)], aug_q[4 * (q0 + i) + 1],
                      aug_q[4 * (q0 + i) + 2], aug_q[4 * (q0 + i) + 3])
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float cx = c[0], cy = c[1], cz = c[2];
  const long long base = tile * (long long)data_tile;

  for (int b0 = 0; b0 < nbt; b0 += bpc) {
    const int nb = min(bpc, nbt - b0);
    const int npts = nb * blk;
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < npts; i += kThreads) {
      const long long g = base + (long long)b0 * blk + i;
      const float rlon = x[g] * kDeg2Rad;
      const float rlat = y[g] * kDeg2Rad;
      const float cl = cosf(rlat);
      const float dx = cl * cosf(rlon) - cx;
      const float dy = cl * sinf(rlon) - cy;
      const float dz = sinf(rlat) - cz;
      const float nd = dx * dx + dy * dy + dz * dz;
      pts[i] = make_float4(dx, dy, dz, nd + (1.0f - maskf[g]) * kPenalty);
    }
    __syncthreads();

    float mine[kQW];
#pragma unroll
    for (int j = 0; j < kQW; ++j) mine[j] = CUDART_INF_F;
    const int qw0 = warp * kQW;
    if (q0 + qw0 < q) {
      for (int b = 0; b < nb; ++b) {
        float m[kQW];
#pragma unroll
        for (int j = 0; j < kQW; ++j) m[j] = CUDART_INF_F;
        for (int l = lane; l < blk; l += 32) {
          const float4 d = pts[b * blk + l];
#pragma unroll
          for (int j = 0; j < kQW; ++j) {
            const float4 a = aq[qw0 + j];
            const float key = fmaf(a.x, d.x, fmaf(a.y, d.y, fmaf(a.z, d.z, a.w * d.w)));
            m[j] = min_nan(m[j], key);
          }
        }
#pragma unroll
        for (int j = 0; j < kQW; ++j) {
          float v = m[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
          if (lane == b) mine[j] = v;
        }
      }
      if (lane < nb) {
#pragma unroll
        for (int j = 0; j < kQW; ++j) {
          if (q0 + qw0 + j < q)
            out[(long long)(q0 + qw0 + j) * out_cols + col0 + b0 + lane] = mine[j];
        }
      }
    }
  }
}

// -- B2 -----------------------------------------------------------------------

constexpr int kDThreads = 256;
constexpr int kDWarps = kDThreads / 32;
constexpr int kQL = 8;                      // queries a lane holds
constexpr int kDQB = 32 * kQL;              // queries a block holds
constexpr int kDChunkPts = 2048;            // most points a chunk
constexpr int kDMaxBlocks = 16;             // most blk-blocks a chunk
constexpr int kDMaxSegs = 16;               // most segments a chunk
constexpr int kDPtsPerThread = kDChunkPts / kDThreads;
constexpr int kDMinStride = kDMaxSegs + 1;  // odd: no bank conflicts
constexpr size_t kDSmem = sizeof(float4) * 2 * kDChunkPts
                          + sizeof(float) * 2 * kDQB * kDMinStride;

static_assert(kDChunkPts % kDThreads == 0, "whole points a thread");
static_assert(kDMaxSegs >= kDWarps, "a segment a warp at least");
static_assert(kDMaxBlocks == 16, "a half-warp writes a row segment");

// [dx, dy, dz, ndm] of one point, as the plain version's _prelude
__device__ __forceinline__ float4 prelude(float lon, float lat, float m,
                                          float cx, float cy, float cz) {
  float slon, clon, slat, clat;
  sincosf(lon * kDeg2Rad, &slon, &clon);
  sincosf(lat * kDeg2Rad, &slat, &clat);
  const float dx = clat * clon - cx;
  const float dy = clat * slon - cy;
  const float dz = slat - cz;
  const float nd = dx * dx + dy * dy + dz * dz;
  return make_float4(dx, dy, dz, nd + (1.0f - m) * kPenalty);
}

// kFold false skips the keys (one point a segment stands in for the
// fold): the prelude, the barriers and the output alone, to measure the
// prelude's share of a launch. Its output is not the minima.
template <bool kFold>
__global__ void __launch_bounds__(kDThreads, 2)
chord_blockmin_dense_kernel(const float* __restrict__ aug_q,  // [q, 4]
                            const float* __restrict__ c,      // [3]
                            const float* __restrict__ x,      // [n]
                            const float* __restrict__ y,      // [n]
                            const float* __restrict__ maskf,  // [n]
                            float* __restrict__ out,          // [q, n / blk]
                            int q, long long n, int blk, int cb, int r) {
  extern __shared__ float4 smem[];
  float4* pts = smem;                                        // [2][chunk]
  float* mins = reinterpret_cast<float*>(smem + 2 * kDChunkPts);  // [2][kDQB][stride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ncols = n / blk;                   // blocks of the points
  const long long nchunks = (ncols + cb - 1) / cb;
  const long long c0 = nchunks * blockIdx.x / gridDim.x;
  const long long c1 = nchunks * (blockIdx.x + 1) / gridDim.x;
  if (c0 >= c1) return;
  const int q0 = blockIdx.y * kDQB;
  const int seg_pts = blk / r;
  const float cx = c[0], cy = c[1], cz = c[2];

  float ax[kQL], ay[kQL], az[kQL];
#pragma unroll
  for (int j = 0; j < kQL; ++j) {
    const int qi = q0 + j * 32 + lane;
    ax[j] = qi < q ? aug_q[4 * qi] : 0.0f;
    ay[j] = qi < q ? aug_q[4 * qi + 1] : 0.0f;
    az[j] = qi < q ? aug_q[4 * qi + 2] : 0.0f;
  }

  // the raw points of chunk `ch`, one a thread per kDThreads (coalesced)
  float rx[kDPtsPerThread], ry[kDPtsPerThread], rm[kDPtsPerThread];
  auto load = [&](long long ch) {
    const long long base = ch * cb * blk;
    const long long npts = min((long long)cb, ncols - ch * cb) * blk;
#pragma unroll
    for (int k = 0; k < kDPtsPerThread; ++k) {
      const int i = k * kDThreads + tid;
      if (i < npts) {
        rx[k] = x[base + i];
        ry[k] = y[base + i];
        rm[k] = maskf[base + i];
      }
    }
  };
  auto stage = [&](long long ch, float4* dst) {
    const long long npts = min((long long)cb, ncols - ch * cb) * blk;
#pragma unroll
    for (int k = 0; k < kDPtsPerThread; ++k) {
      const int i = k * kDThreads + tid;
      if (i < npts) dst[i] = prelude(rx[k], ry[k], rm[k], cx, cy, cz);
    }
  };

  load(c0);
  stage(c0, pts);
  __syncthreads();
  for (long long ch = c0; ch < c1; ++ch) {
    const int buf = (int)((ch - c0) & 1);
    const bool more = ch + 1 < c1;
    if (more) load(ch + 1);  // in flight during the fold
    const int nb = (int)min((long long)cb, ncols - ch * cb);
    const float4* p = pts + buf * kDChunkPts;
    float* mn = mins + buf * kDQB * kDMinStride;
    for (int sg = warp; sg < nb * r; sg += kDWarps) {
      const float4* sp = p + sg * seg_pts;
      float m[kQL];
#pragma unroll
      for (int j = 0; j < kQL; ++j) m[j] = CUDART_INF_F;
      const int len = kFold ? seg_pts : 1;
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        const float4 d = sp[i];  // the same address in every lane: a broadcast
#pragma unroll
        for (int j = 0; j < kQL; ++j)
          m[j] = min_nan(m[j], fmaf(ax[j], d.x, fmaf(ay[j], d.y, fmaf(az[j], d.z, d.w))));
      }
#pragma unroll
      for (int j = 0; j < kQL; ++j) mn[(j * 32 + lane) * kDMinStride + sg] = m[j];
    }
    if (more) stage(ch + 1, pts + (buf ^ 1) * kDChunkPts);
    __syncthreads();  // the chunk's minima are in; the next chunk is staged
    // each query's row segment of this chunk: a half-warp a row, lane b
    // of it on column b
    const int b = tid & (kDMaxBlocks - 1);
    if (b < nb) {
      float* o = out + (long long)q0 * ncols + ch * cb + b;
      for (int qi = tid / kDMaxBlocks; qi < kDQB && q0 + qi < q;
           qi += kDThreads / kDMaxBlocks) {
        const float* row = mn + qi * kDMinStride + b * r;
        float v = row[0];
        for (int k = 1; k < r; ++k) v = min_nan(v, row[k]);
        o[(long long)qi * ncols] = v;
      }
    }
  }
}

}  // namespace

// B1. tile_ids: int32 [slots], the data tile of each slot; n_sel: int32
// [1] on the device, the live slots; out: f32 [q, slots * data_tile / blk].
extern "C" int chord_blockmin_sparse_launch(const void* aug_q, const void* c,
                                            const void* x, const void* y,
                                            const void* maskf,
                                            const void* tile_ids,
                                            const void* n_sel, void* out,
                                            int q, int slots, int blk,
                                            int data_tile, void* stream) {
  if (q <= 0 || slots <= 0) return 0;
  if (tile_ids == nullptr || n_sel == nullptr) return (int)cudaErrorInvalidValue;
  if (blk < 32 || blk % 32 != 0 || data_tile % blk != 0) return (int)cudaErrorInvalidValue;
  int bpc = kChunkPts / blk;
  if (bpc > 32) bpc = 32;  // lane b holds block b's minimum
  if (bpc < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(slots, (q + kQB - 1) / kQB);
  chord_blockmin_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)aug_q, (const float*)c, (const float*)x, (const float*)y,
      (const float*)maskf, (const int*)tile_ids, (const int*)n_sel,
      (float*)out, q, blk, data_tile, bpc);
  return (int)cudaGetLastError();
}

namespace {

template <bool kFold>
int launch_dense(const void* aug_q, const void* c, const void* x,
                 const void* y, const void* maskf, void* out, int q,
                 long long n, int blk, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (blk < 32 || blk % 32 != 0 || blk > kDChunkPts || n % blk != 0)
    return (int)cudaErrorInvalidValue;
  // a chunk: cb blocks, at most 2048 points and 16 blocks; a block is r
  // segments (a power of two) so that a chunk has at least 8 of them
  const int cb = std::max(1, std::min(kDMaxBlocks, kDChunkPts / blk));
  int r = 1;
  while (cb * r < kDWarps) r *= 2;
  auto kernel = chord_blockmin_dense_kernel<kFold>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kDThreads, kDSmem)) != cudaSuccess) return (int)err;
  const long long nchunks = (n / blk + cb - 1) / cb;
  const dim3 grid((unsigned)std::min(nchunks, (long long)std::max(1, sms * per_sm)),
                  (q + kDQB - 1) / kDQB);
  kernel<<<grid, kDThreads, kDSmem, (cudaStream_t)stream>>>(
      (const float*)aug_q, (const float*)c, (const float*)x, (const float*)y,
      (const float*)maskf, (float*)out, q, n, blk, cb, r);
  return (int)cudaGetLastError();
}

}  // namespace

// B2. x, y, maskf: f32 [n], n a multiple of blk (a multiple of 32, at most
// 2048); out: f32 [q, n / blk].
extern "C" int chord_blockmin_dense_launch(const void* aug_q, const void* c,
                                           const void* x, const void* y,
                                           const void* maskf, void* out,
                                           int q, long long n, int blk,
                                           void* stream) {
  return launch_dense<true>(aug_q, c, x, y, maskf, out, q, n, blk, stream);
}

// B2 without its keys, for timing the prelude's share of a launch (the
// output is not the minima).
extern "C" int chord_blockmin_dense_prelude_launch(
    const void* aug_q, const void* c, const void* x, const void* y,
    const void* maskf, void* out, int q, long long n, int blk, void* stream) {
  return launch_dense<false>(aug_q, c, x, y, maskf, out, q, n, blk, stream);
}
