// Chord-key block minima for the fused kNN scan, dense and sparse.
//
// Replaces the two Pallas kernels of geomesa_tpu/engine/knn_scan.py:
//   chord_blockmin         (B2, _make_kernel + _chunk_body): every data tile
//   chord_blockmin_sparse  (B1, _make_sparse_kernel): the data tiles named
//                          by tile_ids[p] for p < n_sel; slots p >= n_sel
//                          write exactly PENALTY and read no data.
// One kernel serves both: a null tile_ids pointer selects the dense mode.
//
// What it computes, per query q and per blk-lane block b of a data tile:
//   d   = unit3(lon, lat) - c                     (f32 prelude, per point)
//   ndm = |d|^2 + (1 - mask) * PENALTY
//   key = aug_q[q] . [dx, dy, dz, ndm]            (aug_q[q][3] == 1)
//   out[q, slot * (data_tile / blk) + b] = min over the block's lanes of key
// in full FP32: no TF32, no tensor cores (the reference uses
// Precision.HIGHEST), and no fast-math intrinsics.
//
// What bounds it on the H100: the FP32 pipes. Each point is read once
// (12 bytes) but feeds Q keys of 4 FMAs and a min each, so at Q = 256 the
// kernel does ~600 FP32 operations per byte read, far above the card's
// ~20 FP32 operations per byte of HBM bandwidth.
//
// Design (simple first; speed is later work):
//   - a block owns one data tile (slot p) and QB = 64 queries; 8 warps own
//     QW = 8 queries each, kept in registers;
//   - the tile is swept in chunks of up to 2048 points whose prelude
//     [dx, dy, dz, ndm] is staged in shared memory once per block, so the
//     trigonometry runs once per point per query group, not per key;
//   - within a chunk, for each blk-lane block, every lane loads its
//     blk / 32 points and folds them into the QW queries' keys; a warp
//     shuffle takes each query's minimum, and lane b keeps block b's
//     minimum so the row segment is written with one coalesced store;
//     every minimum propagates NaN (min.NaN.f32), as the plain version's.
//   - the sparse guard reads n_sel from device memory: no host sync.

#include <cuda_runtime.h>
#include <math_constants.h>

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

}  // namespace

extern "C" int chord_blockmin_launch(const void* aug_q, const void* c,
                                     const void* x, const void* y,
                                     const void* maskf, const void* tile_ids,
                                     const void* n_sel, void* out, int q,
                                     int slots, int blk, int data_tile,
                                     void* stream) {
  if (q <= 0 || slots <= 0) return 0;
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
