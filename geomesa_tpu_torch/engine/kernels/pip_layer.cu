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
//                      same crossing / band counts, walking the pair list
//                      one pair at a time    -> pip_pairs_{count,band}_launch
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
// FMA and the counts equal the plain PyTorch versions
// (engine/pip_sparse_kernels.py) bit for bit. The source is self-contained
// (it repeats pip_crossing.cu's predicate rather than sharing a header), so
// build.py's per-source hash covers everything it compiles.
//
// What bounds it on the H100: the FP32/ALU pipes. Each staged 8 KB edge
// tile meets the 512 points of its point tile: 2.6e5 predicate tests per
// 8 KB, far above the card's ~20 operations per byte. Only edges whose
// y-span straddles py need the division, so the loop branches on cond and
// pays it only there (exact: every term that reads xc is ANDed with cond).
//
// Design (simple first; speed is later work):
//   - one thread per point, 512 threads a block, the point's coordinates
//     and its counts in registers;
//   - B6/B7: one block per covered point tile (a CSR row: rows[k], the
//     edge tiles ets[row_ptr[k] .. row_ptr[k+1])), looping over the row's
//     edge tiles; each is staged into shared memory as float4 (one edge a
//     thread) before every point meets all 512 of its edges. The block
//     owns its tile, so it stores its counts without atomics; tiles in no
//     row keep the wrapper's zeros. One launch covers every covered tile
//     (the TPU's capacity classes, dummy tiles and SMEM chunking are gone);
//   - B8/B9: one block per pair, adding its partial counts into the zeroed
//     output with atomicAdd (integers: the sum is exact in any order). The
//     TPU's first-visit zeroing existed because its grid ran in order.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;

__device__ __forceinline__ float crossing_x(float4 e, float py) {
  const float den = (e.w == e.y) ? 1.0f : __fsub_rn(e.w, e.y);
  const float t = __fdiv_rn(__fsub_rn(py, e.y), den);
  return __fadd_rn(e.x, __fmul_rn(t, __fsub_rn(e.z, e.x)));
}

// Adds edge d's crossing (kCross) and band flag (kBand) for point (qx, qy).
template <bool kCross, bool kBand>
__device__ __forceinline__ void test_edge(float4 d, float qx, float qy,
                                          float eps, int& cross, int& band) {
  const bool cond = (d.y <= qy) != (d.w <= qy);  // d = (x1, y1, x2, y2)
  if (kBand) {
    const bool near_flat =
        fabsf(__fsub_rn(qy, d.y)) <= eps && fabsf(__fsub_rn(qy, d.w)) <= eps
        && qx >= __fsub_rn(fminf(d.x, d.z), eps)
        && qx <= __fadd_rn(fmaxf(d.x, d.z), eps);
    bool near_cross = false;
    if (cond) {
      const float xc = crossing_x(d, qy);
      if (kCross) cross += xc > qx;
      const float slope = __fdiv_rn(fabsf(__fsub_rn(d.z, d.x)),
                                    fmaxf(fabsf(__fsub_rn(d.w, d.y)), eps));
      const float err = __fmul_rn(eps, __fadd_rn(1.0f, slope));
      near_cross = fabsf(__fsub_rn(xc, qx)) <= err;
    }
    band += near_flat || near_cross;
  } else if (cond) {
    cross += crossing_x(d, qy) > qx;
  }
}

// Stages edge tile `et` into shared memory, one edge a thread.
__device__ __forceinline__ void stage(float4* edges, const float* x1,
                                      const float* y1, const float* x2,
                                      const float* y2, int et) {
  const long long j = (long long)et * kTile + threadIdx.x;
  edges[threadIdx.x] = make_float4(x1[j], y1[j], x2[j], y2[j]);
}

// B6 (kAssign false): out0 = crossings, out2 = band.
// B7 (kAssign true):  out0 = assign, out1 = count, out2 = band.
template <bool kAssign>
__global__ void __launch_bounds__(kTile)
grouped_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ x1, const float* __restrict__ y1,
               const float* __restrict__ x2, const float* __restrict__ y2,
               const int* __restrict__ rows, const int* __restrict__ row_ptr,
               const int* __restrict__ ets, const int* __restrict__ pinfo,
               int* __restrict__ out0, int* __restrict__ out1,
               int* __restrict__ out2, float eps) {
  __shared__ float4 edges[kTile];
  const int k = blockIdx.x;
  const long long i = (long long)rows[k] * kTile + threadIdx.x;
  const float qx = px[i];
  const float qy = py[i];
  int cross = 0, band = 0, assign = 0, count = 0;
  const int m1 = row_ptr[k + 1];
  for (int m = row_ptr[k]; m < m1; ++m) {
    __syncthreads();  // the previous tile is fully consumed
    stage(edges, x1, y1, x2, y2, ets[m]);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j)
      test_edge<true, true>(edges[j], qx, qy, eps, cross, band);
    if (kAssign) {
      const int info = pinfo[m];
      if (info < 0) {  // last edge tile of this polygon in the row: flush
        const int parity = cross & 1;
        assign += parity * (-info);
        count += parity;
        cross = 0;
      }
    }
  }
  if (kAssign) {
    out0[i] = assign;
    out1[i] = count;
  } else {
    out0[i] = cross;
  }
  out2[i] = band;
}

// B8 (kBand false): crossings; B9 (kBand true): band flags. out: int32
// [n_ptiles + 1, 512], zeroed by the wrapper.
template <bool kBand>
__global__ void __launch_bounds__(kTile)
pairs_kernel(const float* __restrict__ px, const float* __restrict__ py,
             const float* __restrict__ x1, const float* __restrict__ y1,
             const float* __restrict__ x2, const float* __restrict__ y2,
             const int* __restrict__ pair_pt, const int* __restrict__ pair_et,
             int* __restrict__ out, float eps) {
  __shared__ float4 edges[kTile];
  const int m = blockIdx.x;
  stage(edges, x1, y1, x2, y2, pair_et[m]);
  const long long i = (long long)pair_pt[m] * kTile + threadIdx.x;
  const float qx = px[i];
  const float qy = py[i];
  __syncthreads();
  int cross = 0, band = 0;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j)
    test_edge<!kBand, kBand>(edges[j], qx, qy, eps, cross, band);
  const int c = kBand ? band : cross;
  if (c) atomicAdd(out + i, c);
}

int done() { return (int)cudaGetLastError(); }

}  // namespace

// B6. rows/row_ptr/ets: int32 CSR over k covered point tiles; counts, band:
// int32 [n_ptiles * 512], zeroed.
extern "C" int pip_grouped_launch(const void* px, const void* py,
                                  const void* x1, const void* y1,
                                  const void* x2, const void* y2,
                                  const void* rows, const void* row_ptr,
                                  const void* ets, void* counts, void* band,
                                  int k, float eps, void* stream) {
  if (k <= 0) return 0;
  grouped_kernel<false><<<k, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (const int*)rows,
      (const int*)row_ptr, (const int*)ets, nullptr, (int*)counts, nullptr,
      (int*)band, eps);
  return done();
}

// B7. As B6, plus pinfo: int32 [m], the pair's polygon rank + 1, negated on
// the last edge tile of that polygon's run in its row. assign, count, band:
// int32 [n_ptiles * 512], zeroed.
extern "C" int pip_assign_launch(const void* px, const void* py,
                                 const void* x1, const void* y1,
                                 const void* x2, const void* y2,
                                 const void* rows, const void* row_ptr,
                                 const void* ets, const void* pinfo,
                                 void* assign, void* count, void* band, int k,
                                 float eps, void* stream) {
  if (k <= 0) return 0;
  grouped_kernel<true><<<k, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (const int*)rows,
      (const int*)row_ptr, (const int*)ets, (const int*)pinfo, (int*)assign,
      (int*)count, (int*)band, eps);
  return done();
}

// B8. pair_pt/pair_et: int32 [m]; out: int32 [(n_ptiles + 1) * 512], zeroed.
extern "C" int pip_pairs_count_launch(const void* px, const void* py,
                                      const void* x1, const void* y1,
                                      const void* x2, const void* y2,
                                      const void* pair_pt, const void* pair_et,
                                      void* out, int m, void* stream) {
  if (m <= 0) return 0;
  pairs_kernel<false><<<m, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (const int*)pair_pt,
      (const int*)pair_et, (int*)out, 0.0f);
  return done();
}

// B9. As B8, counting band flags.
extern "C" int pip_pairs_band_launch(const void* px, const void* py,
                                     const void* x1, const void* y1,
                                     const void* x2, const void* y2,
                                     const void* pair_pt, const void* pair_et,
                                     void* out, int m, float eps,
                                     void* stream) {
  if (m <= 0) return 0;
  pairs_kernel<true><<<m, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (const int*)pair_pt,
      (const int*)pair_et, (int*)out, eps);
  return done();
}
