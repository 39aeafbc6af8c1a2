// Chord-key block minima for the fused kNN scan, dense and sparse.
//
// Replaces the two Pallas kernels of geomesa_tpu/engine/knn_scan.py:
//   chord_blockmin         (B2, _make_kernel + _chunk_body): every data tile
//                          -> chord_blockmin_dense_launch
//   chord_blockmin_sparse  (B1, _make_sparse_kernel): the data tiles named
//                          by tile_ids[p] for p < n_sel; slots p >= n_sel
//                          write exactly PENALTY and read no data
//                          -> chord_blockmin_sparse_launch
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
// What bounds it on the H100: the FP32 pipes. Each point is read once
// (12 bytes) but feeds Q keys of 3 FMAs and a min each, so at Q = 256 the
// kernel does ~340 FP32 operations per byte read, far above the card's
// ~20 FP32 operations per byte of HBM bandwidth. A warp issues one
// instruction a cycle, so 4 instructions a key is the floor.
//
// Design: one kernel (blockmin_kernel) for both routes, queries
// across lanes and points broadcast from shared memory. The points are cut
// into chunks; a chunk lies inside one slot: the dense route has one slot
// of all N points, the sparse route a slot per entry of the tile list,
// each one data tile, of which the first min(*n_sel, slots) are live.
//   - a block holds kDQB = 256 queries, kQL = 8 a lane (query j * 32 +
//     lane), their (ax, ay, az) and running minima in registers; a launch
//     with more queries has a second row of blocks;
//   - a block walks a contiguous run of the live chunks (a persistent
//     grid: as many blocks as fit on the card at once, sized against every
//     chunk the slots could hold, each a near-equal share of the live
//     ones, which it counts from n_sel on the device: no host sync). A
//     chunk is cb <= 16 blk-blocks, at most 2048 points; chunk ch is chunk
//     ch % cpt of slot ch / cpt (cpt chunks a slot), its points start at
//     tile_ids[slot] * tile_pts + (ch % cpt) * cb * blk and its minima go
//     to columns slot * nbt + (ch % cpt) * cb on. Its prelude [dx, dy, dz,
//     ndm] is computed once per point per launch (one thread a point,
//     sincosf twice) into one of two shared buffers, while the raw x, y
//     and mask of the next chunk are loaded into registers before the fold
//     of this one, and turned into its prelude after: one barrier a chunk;
//   - a warp folds whole segments of a chunk (a blk-block, or 1/r of one
//     when a chunk has fewer than 8 blocks): each point's float4 is one
//     shared-memory broadcast (every lane reads the same address) that
//     feeds 8 keys, a key is fmaf(ax, dx, fmaf(ay, dy, fmaf(az, dz, ndm)))
//     and a min (aug_q[q][3] == 1 adds ndm as it is), and no shuffle
//     reduces anything: each lane owns its queries' minima;
//   - a segment's minima go to a shared [query][segment] table (row stride
//     odd: no bank conflicts), and after the barrier the block writes each
//     query's row segment of the chunk (cb minima, 64 bytes at blk = 128)
//     with a half-warp a row, lane b on column b, so the [Q, columns]
//     output is written in whole sectors, not 4 bytes a 32-byte sector;
//   - the columns of the dead slots, [Q, (slots - live) * nbt], are
//     written with exactly PENALTY by the same launch (a grid-stride loop
//     over every block), and no point of theirs is read.
// The key loop is 24 FFMA, 8 FMNMX and one LDS.128 a point, and 2048-point
// chunks (2 blocks an SM, 125 registers), the half-warp row writes and
// sincosf were each faster than 1024-point chunks (3 blocks an SM), a
// division per output element, and sinf/cosf, on the H100
// (scripts/torch_knn_dense_sweep.py; PERF.md).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

namespace {

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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQL = 8;                     // queries a lane holds
constexpr int kQB = 32 * kQL;              // queries a block holds
constexpr int kChunkPts = 2048;            // most points a chunk
constexpr int kMaxBlocks = 16;             // most blk-blocks a chunk
constexpr int kMaxSegs = 16;               // most segments a chunk
constexpr int kPtsPerThread = kChunkPts / kThreads;
constexpr int kMaxDevices = 64;            // devices the launch caches
constexpr int kMinStride = kMaxSegs + 1;   // odd: no bank conflicts
constexpr size_t kSmem = sizeof(float4) * 2 * kChunkPts
                         + sizeof(float) * 2 * kQB * kMinStride;

static_assert(kChunkPts % kThreads == 0, "whole points a thread");
static_assert(kMaxSegs >= kWarps, "a segment a warp at least");
static_assert(kMaxBlocks == 16, "a half-warp writes a row segment");

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

// Both routes. tile_ids null: one slot of nbt blocks, the points from 0
// (dense); else slot s is data tile tile_ids[s] of tile_pts points, and
// the slots from min(*n_sel, slots) on are dead (sparse). out: [q, slots *
// nbt]. kFold false skips the keys (one point a segment stands in for the
// fold): the prelude, the barriers and the output alone, to measure the
// prelude's share of a launch. Its output is not the minima.
template <bool kFold>
__global__ void __launch_bounds__(kThreads, 2)
blockmin_kernel(const float* __restrict__ aug_q,    // [q, 4]
                const float* __restrict__ c,        // [3]
                const float* __restrict__ x,        // [n]
                const float* __restrict__ y,        // [n]
                const float* __restrict__ maskf,    // [n]
                const int* __restrict__ tile_ids,   // [slots] or null
                const int* __restrict__ n_sel,      // [1] or null
                float* __restrict__ out,            // [q, slots * nbt]
                int q, int slots, long long nbt, long long tile_pts, int blk,
                int cb, int r) {
  extern __shared__ float4 smem[];
  float4* pts = smem;                                            // [2][chunk]
  float* mins = reinterpret_cast<float*>(smem + 2 * kChunkPts);  // [2][kQB][stride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, q - q0);
  const long long cols = (long long)slots * nbt;
  const int cpt = (int)((nbt + cb - 1) / cb);  // chunks a slot
  const int live = tile_ids == nullptr ? slots : max(0, min(*n_sel, slots));

  // the dead slots' columns: exactly PENALTY, no point read
  const long long dead0 = (long long)live * nbt;
  for (int qi = 0; qi < nq; ++qi)
    for (long long j = dead0 + (long long)blockIdx.x * kThreads + tid; j < cols;
         j += (long long)gridDim.x * kThreads)
      out[(long long)(q0 + qi) * cols + j] = kPenalty;

  const long long nchunks = (long long)live * cpt;
  const long long c0 = nchunks * blockIdx.x / gridDim.x;
  const long long c1 = nchunks * (blockIdx.x + 1) / gridDim.x;
  if (c0 >= c1) return;
  const int seg_pts = blk / r;
  const float cx = c[0], cy = c[1], cz = c[2];

  // chunk k of slot s: its first point and its blk-blocks; the walk steps
  // (slot, k) along, with no division in the loop
  auto first_pt = [&](int s, int k) {
    const long long tile = tile_ids == nullptr ? s : tile_ids[s];
    return tile * tile_pts + (long long)k * cb * blk;
  };
  auto blocks = [&](int k) { return (int)min((long long)cb, nbt - (long long)k * cb); };
  int slot = (int)(c0 / cpt), cc = (int)(c0 - (long long)slot * cpt);

  float ax[kQL], ay[kQL], az[kQL];
#pragma unroll
  for (int j = 0; j < kQL; ++j) {
    const int qi = q0 + j * 32 + lane;
    ax[j] = qi < q ? aug_q[4 * qi] : 0.0f;
    ay[j] = qi < q ? aug_q[4 * qi + 1] : 0.0f;
    az[j] = qi < q ? aug_q[4 * qi + 2] : 0.0f;
  }

  // the raw points of a chunk, one a thread per kThreads (coalesced)
  float rx[kPtsPerThread], ry[kPtsPerThread], rm[kPtsPerThread];
  auto load = [&](long long pt0, int nb) {
    const int npts = nb * blk;
#pragma unroll
    for (int j = 0; j < kPtsPerThread; ++j) {
      const int i = j * kThreads + tid;
      if (i < npts) {
        rx[j] = x[pt0 + i];
        ry[j] = y[pt0 + i];
        rm[j] = maskf[pt0 + i];
      }
    }
  };
  auto stage = [&](int nb, float4* dst) {
    const int npts = nb * blk;
#pragma unroll
    for (int j = 0; j < kPtsPerThread; ++j) {
      const int i = j * kThreads + tid;
      if (i < npts) dst[i] = prelude(rx[j], ry[j], rm[j], cx, cy, cz);
    }
  };

  load(first_pt(slot, cc), blocks(cc));
  stage(blocks(cc), pts);
  __syncthreads();
  for (long long ch = c0; ch < c1; ++ch) {
    const int buf = (int)((ch - c0) & 1);
    const bool more = ch + 1 < c1;
    const bool wrap = cc + 1 == cpt;  // the next chunk opens the next slot
    const int ns = wrap ? slot + 1 : slot, nc = wrap ? 0 : cc + 1;
    if (more) load(first_pt(ns, nc), blocks(nc));  // in flight during the fold
    const int nb = blocks(cc);
    const float4* p = pts + buf * kChunkPts;
    float* mn = mins + buf * kQB * kMinStride;
    for (int sg = warp; sg < nb * r; sg += kWarps) {
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
      for (int j = 0; j < kQL; ++j) mn[(j * 32 + lane) * kMinStride + sg] = m[j];
    }
    if (more) stage(blocks(nc), pts + (buf ^ 1) * kChunkPts);
    __syncthreads();  // the chunk's minima are in; the next chunk is staged
    // each query's row segment of this chunk: a half-warp a row, lane b
    // of it on column b
    const int b = tid & (kMaxBlocks - 1);
    if (b < nb) {
      float* o = out + (long long)q0 * cols + (long long)slot * nbt
                 + (long long)cc * cb + b;
      for (int qi = tid / kMaxBlocks; qi < nq; qi += kThreads / kMaxBlocks) {
        const float* row = mn + qi * kMinStride + b * r;
        float v = row[0];
        for (int k = 1; k < r; ++k) v = min_nan(v, row[k]);
        o[(long long)qi * cols] = v;
      }
    }
    slot = ns;
    cc = nc;
  }
}

template <bool kFold>
int launch(const void* aug_q, const void* c, const void* x, const void* y,
           const void* maskf, const void* tile_ids, const void* n_sel,
           void* out, int q, int slots, long long nbt, long long tile_pts,
           int blk, void* stream) {
  if (q <= 0 || slots <= 0 || nbt <= 0) return 0;
  if (blk < 32 || blk % 32 != 0 || blk > kChunkPts) return (int)cudaErrorInvalidValue;
  // a chunk: cb blocks, at most 2048 points and 16 blocks; a block is r
  // segments (a power of two) so that a chunk has at least 8 of them
  const int cb = std::max(1, std::min(kMaxBlocks, kChunkPts / blk));
  int r = 1;
  while (cb * r < kWarps) r *= 2;
  auto kernel = blockmin_kernel<kFold>;
  // the shared-memory attribute and the resident blocks a device are set
  // and read once per device, so that a launch under CUDA graph capture
  // (the serve ring) makes no other runtime call than the launch
  static int resident[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem))
        != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
        != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, kSmem)) != cudaSuccess) return (int)err;
    resident[dev] = std::max(1, sms * per_sm);
  }
  // sized against every chunk the slots could hold: the live count is
  // known only on the device
  const long long nchunks = slots * ((nbt + cb - 1) / cb);
  if ((nbt + cb - 1) / cb > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)std::min(nchunks, (long long)resident[dev]),
                  (q + kQB - 1) / kQB);
  kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)aug_q, (const float*)c, (const float*)x, (const float*)y,
      (const float*)maskf, (const int*)tile_ids, (const int*)n_sel,
      (float*)out, q, slots, nbt, tile_pts, blk, cb, r);
  return (int)cudaGetLastError();
}

template <bool kFold>
int launch_sparse(const void* aug_q, const void* c, const void* x,
                  const void* y, const void* maskf, const void* tile_ids,
                  const void* n_sel, void* out, int q, int slots, int blk,
                  int data_tile, void* stream) {
  if (q <= 0 || slots <= 0) return 0;
  if (tile_ids == nullptr || n_sel == nullptr) return (int)cudaErrorInvalidValue;
  if (blk <= 0 || data_tile % blk != 0) return (int)cudaErrorInvalidValue;
  return launch<kFold>(aug_q, c, x, y, maskf, tile_ids, n_sel, out, q, slots,
                       data_tile / blk, data_tile, blk, stream);
}

template <bool kFold>
int launch_dense(const void* aug_q, const void* c, const void* x,
                 const void* y, const void* maskf, void* out, int q,
                 long long n, int blk, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (blk <= 0 || n % blk != 0) return (int)cudaErrorInvalidValue;
  return launch<kFold>(aug_q, c, x, y, maskf, nullptr, nullptr, out, q, 1,
                       n / blk, n, blk, stream);
}

}  // namespace

// B1. tile_ids: int32 [slots], the data tile of each slot; n_sel: int32
// [1] on the device, the live slots; x, y, maskf: f32, whole data tiles of
// data_tile points (a multiple of blk, which is a multiple of 32, at most
// 2048); out: f32 [q, slots * data_tile / blk].
extern "C" int chord_blockmin_sparse_launch(const void* aug_q, const void* c,
                                            const void* x, const void* y,
                                            const void* maskf,
                                            const void* tile_ids,
                                            const void* n_sel, void* out,
                                            int q, int slots, int blk,
                                            int data_tile, void* stream) {
  return launch_sparse<true>(aug_q, c, x, y, maskf, tile_ids, n_sel, out, q,
                             slots, blk, data_tile, stream);
}

// B1 without its keys, for timing the prelude's share of a launch (the
// live columns are not the minima; the dead ones are PENALTY).
extern "C" int chord_blockmin_sparse_prelude_launch(
    const void* aug_q, const void* c, const void* x, const void* y,
    const void* maskf, const void* tile_ids, const void* n_sel, void* out,
    int q, int slots, int blk, int data_tile, void* stream) {
  return launch_sparse<false>(aug_q, c, x, y, maskf, tile_ids, n_sel, out, q,
                              slots, blk, data_tile, stream);
}

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
