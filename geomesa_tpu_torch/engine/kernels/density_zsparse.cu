// Cell-dictionary density: per data tile, the f32 sum of mask-folded
// weights for each slot of the tile's distinct-cell dictionary.
//
// Replaces the Pallas kernel of geomesa_tpu/engine/density_zsparse.py:
//   _zsparse_call (B3, _make_kernel)
//
// What it computes, for selected tile s (data tile t = tile_ids[s]) and
// dictionary slot j:
//   col  = floor((x - xmin) / dx), row = floor((y - ymin) / dy)     (f32;
//          NaN becomes 0, as the reference's int32 cast makes it)
//   ok   = 0 <= col < width && 0 <= row < height
//   cell = clip(row, 0, height-1) * width + clip(col, 0, width-1)
//   out[s, j] = sum over the tile's points with cell == dicts[s, j] of
//               (ok ? lw : 0)
// dicts[s] is sorted ascending with -1 pads at the end; a pad never
// matches, and a point whose cell is absent from the dictionary adds
// nothing (the reference's one-hot contract, which its stale-calibration
// mass check relies on). The binning subtract and divide use _rn
// intrinsics (no FMA contraction, IEEE division), so cells agree bit for
// bit with the plain PyTorch version and the reference's f32 binning.
//
// What bounds it on the H100: HBM bytes. Each point is read once (x, y,
// lw: 12 bytes) and costs a handful of FP32 operations plus a binary
// search over at most 512 shared-memory slots, far below the card's
// ~20 FP32 operations per byte of bandwidth.
//
// Design (simple first; speed is later work): one block per selected
// tile, all S tiles in one launch (no TPU VMEM chunking of the tile
// list); the dictionary and a capd-wide f32 accumulator sit in shared
// memory; each thread bins its points, finds the slot by binary search
// (pads compare as +infinity) and adds its weight with a shared-memory
// atomicAdd; the row is written once. Atomic order varies from run to
// run, so weighted sums carry f32 summation-order noise; counts of
// unit weights are exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCapd = 512;

__global__ void __launch_bounds__(kThreads)
zsparse_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ lw,
               const int* __restrict__ tile_ids,   // [S]
               const int* __restrict__ dicts,      // [S, capd]
               float* __restrict__ out,            // [S, capd]
               int capd, int data_tile, float xmin, float dx, float ymin,
               float dy, int width, int height) {
  __shared__ int dict[kMaxCapd];
  __shared__ float acc[kMaxCapd];
  const int s = blockIdx.x;
  for (int j = threadIdx.x; j < capd; j += kThreads) {
    dict[j] = dicts[(long long)s * capd + j];
    acc[j] = 0.0f;
  }
  __syncthreads();

  const long long base = (long long)tile_ids[s] * data_tile;
  for (int i = threadIdx.x; i < data_tile; i += kThreads) {
    const long long g = base + i;
    const float w = lw[g];
    if (w == 0.0f) continue;  // adding +-0 to the sum changes nothing
    float colf = floorf(__fdiv_rn(__fsub_rn(x[g], xmin), dx));
    float rowf = floorf(__fdiv_rn(__fsub_rn(y[g], ymin), dy));
    // a NaN coordinate bins to index 0, as the reference's int32 cast
    // (before its bounds check) takes it; out-of-bounds rows are zeroed
    // through the weight, exactly as the reference's `where(ok, w, 0)`
    if (colf != colf) colf = 0.0f;
    if (rowf != rowf) rowf = 0.0f;
    if (!(colf >= 0.0f && colf < (float)width && rowf >= 0.0f
          && rowf < (float)height))
      continue;
    const int cell = (int)rowf * width + (int)colf;
    int lo = 0, hi = capd;
    while (lo < hi) {  // first slot not below `cell`; pads are +infinity
      const int mid = (lo + hi) >> 1;
      const int v = dict[mid];
      if (v >= 0 && v < cell) lo = mid + 1; else hi = mid;
    }
    if (lo < capd && dict[lo] == cell) atomicAdd(&acc[lo], w);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < capd; j += kThreads)
    out[(long long)s * capd + j] = acc[j];
}

}  // namespace

extern "C" int zsparse_launch(const void* x, const void* y, const void* lw,
                              const void* tile_ids, const void* dicts,
                              void* out, int s, int capd, int data_tile,
                              float xmin, float dx, float ymin, float dy,
                              int width, int height, void* stream) {
  if (s <= 0) return 0;
  if (capd <= 0 || capd > kMaxCapd || data_tile <= 0)
    return (int)cudaErrorInvalidValue;
  zsparse_kernel<<<s, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)lw,
      (const int*)tile_ids, (const int*)dicts, (float*)out, capd, data_tile,
      xmin, dx, ymin, dy, width, height);
  return (int)cudaGetLastError();
}
