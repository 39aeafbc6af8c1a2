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
// contract x1 + t*(x2-x1) into an FMA: the result agrees bit for bit with
// the plain PyTorch version (engine/pip_kernels.py) and the reference's
// f32 kernel, which round the multiply and the add separately.
//
// What bounds it on the H100: the FP32/ALU pipes. Each point is read once
// (8 bytes) but meets all E edges; at E ~ 1000 that is thousands of
// operations per byte. Only edges whose y-span straddles py (cond) need
// the division: a point's horizontal line crosses few edges of a simple
// polygon, so the kernel branches on cond and pays the IEEE division
// (a multi-instruction sequence) only there. Skipping it is exact: every
// term that reads t or xc is ANDed with cond.
//
// Design (simple first; speed is later work):
//   - one thread per point, 256 threads a block;
//   - the edge table streams through shared memory in chunks of
//     kChunk edges (float4 x1,y1,x2,y2; 16 KB), loaded cooperatively;
//   - the loop covers the real E edges only (the TPU layout's padding
//     edges are not needed).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__device__ __forceinline__ float crossing_x(float4 e, float py) {
  const float den = (e.w == e.y) ? 1.0f : __fsub_rn(e.w, e.y);
  const float t = __fdiv_rn(__fsub_rn(py, e.y), den);
  return __fadd_rn(e.x, __fmul_rn(t, __fsub_rn(e.z, e.x)));
}

template <bool kBand>
__global__ void __launch_bounds__(kThreads)
pip_kernel(const float* __restrict__ px, const float* __restrict__ py,
           const float* __restrict__ x1, const float* __restrict__ y1,
           const float* __restrict__ x2, const float* __restrict__ y2,
           unsigned char* __restrict__ out, long long n, int e, float eps) {
  __shared__ float4 edges[kChunk];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float qx = live ? px[i] : 0.0f;
  const float qy = live ? py[i] : 0.0f;
  int count = 0;
  bool flag = false;

  for (int c0 = 0; c0 < e; c0 += kChunk) {
    const int ne = min(kChunk, e - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int j = threadIdx.x; j < ne; j += kThreads)
      edges[j] = make_float4(x1[c0 + j], y1[c0 + j], x2[c0 + j], y2[c0 + j]);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < ne; ++j) {
      const float4 d = edges[j];  // (x1, y1, x2, y2)
      const bool cond = (d.y <= qy) != (d.w <= qy);
      if (kBand) {
        const bool near_flat =
            fabsf(__fsub_rn(qy, d.y)) <= eps && fabsf(__fsub_rn(qy, d.w)) <= eps
            && qx >= __fsub_rn(fminf(d.x, d.z), eps)
            && qx <= __fadd_rn(fmaxf(d.x, d.z), eps);
        bool near_cross = false;
        if (cond) {
          const float xc = crossing_x(d, qy);
          const float slope = __fdiv_rn(fabsf(__fsub_rn(d.z, d.x)),
                                        fmaxf(fabsf(__fsub_rn(d.w, d.y)), eps));
          const float err = __fmul_rn(eps, __fadd_rn(1.0f, slope));
          near_cross = fabsf(__fsub_rn(xc, qx)) <= err;
        }
        flag = flag || near_flat || near_cross;
      } else if (cond) {
        count += crossing_x(d, qy) > qx;
      }
    }
  }
  if (live) out[i] = kBand ? (unsigned char)flag : (unsigned char)(count & 1);
}

template <bool kBand>
int launch(const void* px, const void* py, const void* x1, const void* y1,
           const void* x2, const void* y2, void* out, long long n, int e,
           float eps, void* stream) {
  if (n <= 0) return 0;
  if (e < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pip_kernel<kBand><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)x1, (const float*)y1,
      (const float*)x2, (const float*)y2, (unsigned char*)out, n, e, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// out: uint8 [n] (a torch.bool tensor), 1 where the crossing count is odd.
extern "C" int pip_crossing_launch(const void* px, const void* py,
                                   const void* x1, const void* y1,
                                   const void* x2, const void* y2, void* out,
                                   long long n, int e, void* stream) {
  return launch<false>(px, py, x1, y1, x2, y2, out, n, e, 0.0f, stream);
}

// out: uint8 [n], 1 where some edge flags the point as boundary-ambiguous.
extern "C" int pip_band_launch(const void* px, const void* py, const void* x1,
                               const void* y1, const void* x2, const void* y2,
                               void* out, long long n, int e, float eps,
                               void* stream) {
  return launch<true>(px, py, x1, y1, x2, y2, out, n, e, eps, stream);
}
