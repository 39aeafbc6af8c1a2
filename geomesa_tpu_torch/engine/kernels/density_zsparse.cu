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
//   cell = row * width + col
//   out[s, j] = sum over the tile's points with ok && cell == dicts[s, j]
//               of lw
// dicts[s] is sorted ascending with -1 pads at the end; a pad never
// matches, and a point whose cell is absent from the dictionary adds
// nothing (the reference's one-hot contract, which its stale-calibration
// mass check relies on). The binning subtract and divide use _rn
// intrinsics (no FMA contraction, IEEE division), so cells agree bit for
// bit with the plain PyTorch version and the reference's f32 binning.
//
// What bounds it on the H100: HBM bytes. Each point is read once (x, y,
// lw: 12 bytes) for a handful of FP32 operations, far below the card's
// ~20 FP32 operations per byte. Rows come in Morton order, so the 32
// points of a warp fall into a few cells (chip_smoke.py logs how many):
// per point, a binary search and a shared-memory atomic on one of those
// few slots (shared f32 atomics are compare-and-swap loops on this card)
// would serialise the warp on its own adds.
//
// Design:
//   - persistent blocks: as many as fit on the SMs; block b takes the
//     selected tiles b, b + gridDim.x, ...;
//   - thread 0 feeds a ring of kStages stages in shared memory with TMA
//     bulk copies (cp.async.bulk, completing on one mbarrier a stage): a
//     stage is a chunk of up to kChunk points of x, y and lw, and the
//     stage that holds a tile's first chunk also receives the tile's
//     dictionary (its own slot of a ring of kStages dictionaries). Each
//     stage is refilled kStages chunks ahead as soon as the block has
//     consumed it, so the copies for the next tile overlap this tile's
//     compute and its row write;
//   - when a tile's first chunk has come, the block enters its dictionary
//     into a cell -> slot hash table in shared memory (open addressing, at
//     least twice capd entries), so a lookup takes one or two probes where
//     a binary search over capd slots takes log2(capd) dependent loads;
//   - a warp takes 32 consecutive points of a stage a step. A lane that
//     is out of bounds or has weight 0 (adding +0 changes no sum) takes
//     the key kSentinel (not -1, which is the pad); the others their
//     cell. __match_any_sync groups the lanes by key. When every weighted
//     lane of the warp has weight 1 (counts), a group's sum is its lane
//     count. Otherwise equal keys in consecutive lanes form runs, summed
//     by a segmented suffix scan (5 shuffles), and the group's lowest
//     lane, a run head, adds its group's other runs. That lane looks its
//     key up once and, on a hit, does one shared-memory atomicAdd: one
//     lookup and one atomic per cell group of a warp where one a point
//     was;
//   - a tile's row is written from the shared accumulator with 128-bit
//     stores, and the accumulator and the table are cleared for the
//     block's next tile.
// Summation order varies with the grouping and the atomics' order, so
// weighted sums carry f32 summation-order noise; counts of unit weights
// are exact. A NaN weight at a point whose cell is in the dictionary
// makes that slot NaN, as in the plain version.
//
// The sizes (3 stages of 1024 points, 256 threads: five blocks an SM at
// capd 256) came from scripts/torch_zsparse_sweep.py, whose variants
// take 4 stages, 2 stages of 2048 points and more; PERF.md has the
// numbers.
//
// Accepted shapes (the wrapper checks them and raises): data_tile a
// positive multiple of 32, capd a multiple of 4 up to kMaxCapd (the
// wrapper pads the dictionary), and x, y, lw, dicts and out 16-byte
// aligned, as TMA needs.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // points a stage
constexpr int kStages = 3;
constexpr int kMaxCapd = 512;
constexpr int kSentinel = -2;  // the key of a lane that adds nothing
constexpr int kEmpty = -1;     // a free entry of the cell table
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBarBytes = 128;  // the stages' mbarriers, padded
constexpr int kStageFloats = 3 * kChunk;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Tiles {
  const float* x;
  const float* y;
  const float* lw;
  const int* tile_ids;
  const int* dicts;
  int capd;
  int data_tile;
  int cpt;  // chunks a tile
};

// Fill stage c % kStages with the block's chunk c (and, for a tile's first
// chunk, the tile's dictionary). Called by every thread; thread 0 issues.
__device__ __forceinline__ void fill_stage(const Tiles& t, int c, float* ring,
                                           int* dict_ring, uint64_t* bars) {
  if (threadIdx.x != 0) return;
  const int k = c / t.cpt, q = c - k * t.cpt;
  const int s = blockIdx.x + k * gridDim.x;
  const int st = c % kStages;
  const int n = min(kChunk, t.data_tile - q * kChunk);
  const long long g = (long long)t.tile_ids[s] * t.data_tile + (long long)q * kChunk;
  float* stage = ring + st * kStageFloats;
  const uint32_t bytes = 4u * n;
  bar_expect(&bars[st], 3u * bytes + (q == 0 ? 4u * t.capd : 0u));
  bulk_copy(stage, t.x + g, bytes, &bars[st]);
  bulk_copy(stage + kChunk, t.y + g, bytes, &bars[st]);
  bulk_copy(stage + 2 * kChunk, t.lw + g, bytes, &bars[st]);
  if (q == 0)
    bulk_copy(dict_ring + (k % kStages) * t.capd, t.dicts + (long long)s * t.capd,
              4u * t.capd, &bars[st]);
}  // fill_stage

// Wait until stage c % kStages holds chunk c.
__device__ __forceinline__ void wait_stage(uint64_t* bars, int c) {
  const uint32_t bar = smem_u32(&bars[c % kStages]);
  const uint32_t parity = (uint32_t)(c / kStages) & 1u;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}  // wait_stage

struct Grid {
  float xmin, dx, ymin, dy;
  int width, height;
};

// The tile's cell -> slot table: open addressing over 2^tbits entries (at
// least twice capd, so at least half are empty), multiplicative hash,
// linear probing.
__host__ __device__ __forceinline__ int table_bits(int capd) {
  int bits = 1;
  while ((1 << bits) < 2 * capd) ++bits;
  return bits;
}

__device__ __forceinline__ int table_home(int key, int tbits) {
  return (int)(((unsigned)key * 2654435761u) >> (32 - tbits));
}

// Enter each of the tile's dictionary cells with its slot (the table is
// empty; pads, -1, sit at the end and enter nothing).
__device__ __forceinline__ void fill_table(const int* dict, int capd, int2* table,
                                           int tbits) {
  const int tmask = (1 << tbits) - 1;
  for (int j = threadIdx.x; j < capd; j += kThreads) {
    const int key = dict[j];
    if (key < 0) break;
    int h = table_home(key, tbits);
    while (atomicCAS(&table[h].x, kEmpty, key) != kEmpty) h = (h + 1) & tmask;
    table[h].y = j;
  }
}  // fill_table

// The slot of `key` in the tile's dictionary, or -1 if it is not there.
__device__ __forceinline__ int find_slot(int key, const int2* table, int tbits) {
  const int tmask = (1 << tbits) - 1;
  for (int h = table_home(key, tbits);; h = (h + 1) & tmask) {
    const int2 e = table[h];
    if (e.x == key) return e.y;
    if (e.x == kEmpty) return -1;
  }
}  // find_slot

// One warp's 32 consecutive points: group by key, one lookup and one
// atomic per group (file comment).
__device__ __forceinline__ void warp_step(float px, float py, float w,
                                          const int2* table, int tbits,
                                          float* acc, const Grid& gr) {
  const int lane = threadIdx.x & 31;
  float colf = floorf(__fdiv_rn(__fsub_rn(px, gr.xmin), gr.dx));
  float rowf = floorf(__fdiv_rn(__fsub_rn(py, gr.ymin), gr.dy));
  // a NaN coordinate bins to index 0, as the reference's int32 cast
  // (before its bounds check) takes it
  if (colf != colf) colf = 0.0f;
  if (rowf != rowf) rowf = 0.0f;
  const bool ok = colf >= 0.0f && colf < (float)gr.width && rowf >= 0.0f &&
                  rowf < (float)gr.height && w != 0.0f;
  const int key = ok ? (int)rowf * gr.width + (int)colf : kSentinel;
  const unsigned group = __match_any_sync(kFull, key);
  const bool leader = lane == __ffs(group) - 1;
  float v;
  if (__all_sync(kFull, !ok || w == 1.0f)) {
    v = (float)__popc(group);  // unit weights: the group's count, exact
  } else {
    // runs of equal keys in consecutive lanes: each lane's sum from itself
    // to its run's end (a head holds its run's total)
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || key != prev);
    const unsigned later = lane == 31 ? 0u : heads & (~0u << (lane + 1));
    const int end = later ? __ffs(later) - 2 : 31;
    v = ok ? w : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_down_sync(kFull, v, d);
      if (lane + d <= end) v += u;
    }
    // the group's lowest lane is a run head: it adds its group's other runs
    unsigned rest = 0u;
    if (leader) {
      rest = group & heads;
      rest &= rest - 1u;
    }
    while (__any_sync(kFull, rest != 0u)) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const float u = __shfl_sync(kFull, v, src);
      if (rest) {
        v += u;
        rest &= rest - 1u;
      }
    }
  }
  if (!leader || key < 0) return;
  const int slot = find_slot(key, table, tbits);
  if (slot >= 0) atomicAdd(&acc[slot], v);  // a miss adds nothing
}

__global__ void __launch_bounds__(kThreads)
zsparse_kernel(Tiles t, float* __restrict__ out, int s_total, Grid gr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int capd = t.capd;
  const int tbits = table_bits(capd);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  int* dict_ring = reinterpret_cast<int*>(ring + kStages * kStageFloats);
  float* acc = reinterpret_cast<float*>(dict_ring + kStages * capd);
  int2* table = reinterpret_cast<int2*>(acc + capd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_tiles = (s_total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * t.cpt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = 0; c < kStages && c < total; ++c) fill_stage(t, c, ring, dict_ring, bars);
  for (int j = threadIdx.x; j < capd; j += kThreads) acc[j] = 0.0f;
  for (int j = threadIdx.x; j < (1 << tbits); j += kThreads) table[j] = make_int2(kEmpty, 0);
  __syncthreads();

  for (int c = 0; c < total; ++c) {
    const int k = c / t.cpt, q = c - k * t.cpt;
    const int n = min(kChunk, t.data_tile - q * kChunk);
    const float* stage = ring + (c % kStages) * kStageFloats;
    wait_stage(bars, c);
    if (q == 0) {  // the tile's dictionary has come with its first chunk
      fill_table(dict_ring + (k % kStages) * capd, capd, table, tbits);
      __syncthreads();
    }
    for (int i = warp * 32 + lane; i < n; i += kThreads)  // n % 32 == 0
      warp_step(stage[i], stage[kChunk + i], stage[2 * kChunk + i], table, tbits,
                acc, gr);
    __syncthreads();  // every warp is done with this stage
    if (c + kStages < total) {
      if (threadIdx.x == 0)  // the async proxy writes what generic reads read
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fill_stage(t, c + kStages, ring, dict_ring, bars);
    }
    if (q == t.cpt - 1) {  // the tile's last chunk: its row, then an empty
                           // accumulator and table for the next tile
      const int s = blockIdx.x + k * gridDim.x;
      float4* row = reinterpret_cast<float4*>(out + (long long)s * capd);
      float4* a = reinterpret_cast<float4*>(acc);
      for (int j = threadIdx.x; j < capd / 4; j += kThreads) {
        row[j] = a[j];
        a[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      for (int j = threadIdx.x; j < (1 << tbits); j += kThreads)
        table[j] = make_int2(kEmpty, 0);
      __syncthreads();
    }
  }
}

size_t smem_bytes(int capd) {
  return kBarBytes + sizeof(float) * (size_t)kStages * kStageFloats +
         sizeof(int) * (size_t)(kStages + 1) * capd +
         sizeof(int2) * ((size_t)1 << table_bits(capd));
}

cudaError_t grid_blocks(int capd, int* blocks) {
  const size_t smem = smem_bytes(capd);
  cudaError_t err = cudaFuncSetAttribute(
      zsparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zsparse_kernel,
                                                           kThreads, smem)) !=
      cudaSuccess)
    return err;
  *blocks = std::max(1, sms * per_sm);
  return cudaSuccess;
}

}  // namespace

// The persistent grid for a dictionary width (blocks launched when there
// are at least as many selected tiles), or a negative CUDA error.
extern "C" int zsparse_grid_blocks(int capd) {
  if (capd <= 0 || capd > kMaxCapd || capd % 4 != 0) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = grid_blocks(capd, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int zsparse_launch(const void* x, const void* y, const void* lw,
                              const void* tile_ids, const void* dicts,
                              void* out, int s, int capd, int data_tile,
                              float xmin, float dx, float ymin, float dy,
                              int width, int height, void* stream) {
  if (s <= 0) return 0;
  if (capd <= 0 || capd > kMaxCapd || capd % 4 != 0 || data_tile <= 0 ||
      data_tile % 32 != 0)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, y, lw, dicts, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int blocks = 0;
  cudaError_t err = grid_blocks(capd, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Tiles t{(const float*)x, (const float*)y, (const float*)lw,
                (const int*)tile_ids, (const int*)dicts, capd, data_tile,
                (data_tile + kChunk - 1) / kChunk};
  const Grid gr{xmin, dx, ymin, dy, width, height};
  zsparse_kernel<<<std::min(s, blocks), kThreads, smem_bytes(capd),
                   (cudaStream_t)stream>>>(t, (float*)out, s, gr);
  return (int)cudaGetLastError();
}
