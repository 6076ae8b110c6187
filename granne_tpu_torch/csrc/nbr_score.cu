// The two neighbor-cache scorers of ops/nbr_cache.py: K1 over the flat
// layout, K2 over the tiled layout.
//
// ---------------------------------------------------------------------------
// K1: fused flat neighbor-cache gather + candidate scoring + id unpack.
//
// Replaces the Pallas TPU kernel
// granne_tpu/ops/pallas/nbr_score.py::gather_score_flat (_flat_kernel).
//
// For each query b and each of its E selected node ids, read that node's
// flat cache row (ops/nbr_cache.py: M bf16 neighbor vectors back to back,
// then the M int32 neighbor ids as 2M int16 lanes, zero padded to a
// multiple of 128 lanes), compute the M dot products with the query, and
// unpack the M embedded neighbor ids.
//
//   tab      int16[n, RW]   RW = pad128(M*d + 2M)
//   sel_ids  int32[B, E]    negative ids clip to row 0, ids >= n to row n-1
//   q        bf16[B, d]     plain query (no tiled pattern, unlike the TPU)
//   dots     f32[B, E*M]    exact bf16 x bf16 products, f32 accumulation
//   nbrs     int32[B, E*M]
//
// Only the first M*d lanes of a row enter a dot.  The id lanes hold
// UNUSED = -1 as 0xFFFF, a bf16 NaN, so they are read as integers only and
// never multiplied (0 * NaN = NaN would poison every dot of the row).
//
// What bounds it on the H100: one random ~4 KB row per expanded node (M=20,
// d=100) and ~2 KFLOP per row, so it is bound by random-gather bytes and, at
// the serve shape (B=1024, E=1: 4 MB in all), by launch latency, never by
// FLOPs.  The design therefore spends nothing on tensor cores: one warp per
// (b, e) row issues the whole row as back-to-back 16-byte loads into shared
// memory (every lane has all its loads in flight before it uses one), then
// scores the M vectors from shared memory with one warp reduction each.
// Eight rows per block keep enough loads in flight to cover HBM latency.
// TMA and wgmma are for later work.
//
// ---------------------------------------------------------------------------
// K2: fused tiled neighbor-cache gather + candidate scoring.
//
// Replaces the Pallas TPU kernel
// granne_tpu/ops/pallas/nbr_score.py::gather_score (_kernel).
//
// For each query b and each of its E selected node ids, read that node's
// tiled cache row (ops/nbr_cache.py: Mp = pad8(M) vectors of 128 bf16 lanes,
// each vector zero padded past d, no ids) and compute the M dot products
// with the query.
//
//   tab      bf16[n, Mp, 128]
//   sel_ids  int32[B, E]    negative ids clip to row 0, ids >= n to row n-1
//   q        bf16[B, d]     d <= 128, the plain query: the JAX wrapper pads it
//                           to 128 zero lanes, which adds only zero products
//   dots     f32[B, E*M]    exact bf16 x bf16 products, f32 accumulation
//
// Only the first M of the Mp vectors and the first d of the 128 lanes carry
// data (the 8-vector pad is the TPU's DMA granule), so the kernel reads
// nothing else.  What bounds it on the H100 is the same as K1: one random
// row of M x 256-byte vectors per expanded node (M=20: 5 KB, of which d=100
// leaves 4 KB to read) and ~4 KFLOP per row, so random-gather bytes and, at
// B*E = 1024 rows, launch latency.  Every vector starts on a 256-byte
// boundary, so no staging is needed: one warp per (b, e) row, each half warp
// takes one vector with a 16-byte load per lane (8 bf16 lanes), the query's
// matching 8 lanes stay in registers, and four vector pairs are loaded
// before the first is reduced, to keep loads in flight.  One 4-step shuffle
// reduction per vector.  TMA and wgmma are for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kTileLanes = 128;  // bf16 lanes of one tiled-layout vector
constexpr int kHalfWarp = 16;    // lanes that cover one vector, 8 bf16 each
constexpr int kVecPairs = 4;     // vector pairs in flight per warp (K2)

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// int16 lanes of a row that carry data (vectors + ids), rounded up to whole
// 16-byte chunks: the per-warp shared-memory row buffer.
__host__ __device__ __forceinline__ int row_lanes(int M, int d) {
  return (M * d + 2 * M + 7) / 8 * 8;
}

__global__ void gather_score_flat_kernel(
    const int16_t* __restrict__ tab, int64_t n_rows, int row_w,
    const int32_t* __restrict__ sel_ids, int64_t pairs, int expand,
    const uint16_t* __restrict__ q, int M, int d,
    float* __restrict__ dots, int32_t* __restrict__ nbrs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  const int lanes = row_lanes(M, d);

  const int64_t p = static_cast<int64_t>(blockIdx.x) * warps + warp;  // b * E + e
  if (p >= pairs) return;  // whole warp leaves together
  uint16_t* row = reinterpret_cast<uint16_t*>(smem) + static_cast<int64_t>(warp) * lanes;
  float* qs = reinterpret_cast<float*>(reinterpret_cast<uint16_t*>(smem) +
                                       static_cast<int64_t>(warps) * lanes) + warp * d;

  int64_t id = sel_ids[p];
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  const uint4* src = reinterpret_cast<const uint4*>(tab + id * row_w);
  uint4* dst = reinterpret_cast<uint4*>(row);
  const int chunks = lanes / 8;
  for (int i = lane; i < chunks; i += kWarp) dst[i] = src[i];

  const uint16_t* qb = q + (p / expand) * d;
  for (int j = lane; j < d; j += kWarp) qs[j] = bf16_bits_to_float(qb[j]);
  __syncwarp();

  float* out_d = dots + p * M;
  for (int m = 0; m < M; ++m) {
    const uint16_t* v = row + m * d;
    float acc = 0.f;
    for (int j = lane; j < d; j += kWarp) acc = fmaf(bf16_bits_to_float(v[j]), qs[j], acc);
    for (int off = kWarp / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out_d[m] = acc;
  }
  const uint16_t* idl = row + M * d;  // id lanes: low half, then high half
  for (int m = lane; m < M; m += kWarp) {
    const uint32_t lo = idl[2 * m];
    const uint32_t hi = idl[2 * m + 1];
    nbrs[p * M + m] = static_cast<int32_t>(lo | (hi << 16));
  }
}

// The two bf16 lanes of a 32-bit word (little endian: the lower lane first).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void gather_score_tiled_kernel(
    const uint16_t* __restrict__ tab, int64_t n_rows, int Mp,
    const int32_t* __restrict__ sel_ids, int64_t pairs, int expand,
    const uint16_t* __restrict__ q, int M, int d,
    float* __restrict__ dots) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;  // b * E + e
  if (p >= pairs) return;  // whole warp leaves together
  const int half = lane / kHalfWarp;      // which vector of a pair this lane reads
  const int j0 = (lane % kHalfWarp) * 8;  // the first of its 8 lanes
  const bool live = j0 < d;               // lanes wholly past d read nothing

  // the query's matching 8 lanes in f32, zero past d (the table's pad lanes
  // are zero by the layout, so they add only zero products)
  const uint16_t* qb = q + (p / expand) * d;
  float qf[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qf[i] = j0 + i < d ? bf16_bits_to_float(qb[j0 + i]) : 0.f;

  int64_t id = sel_ids[p];
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  const uint16_t* row = tab + id * Mp * kTileLanes;
  float* out = dots + p * M;
  for (int m0 = 0; m0 < M; m0 += 2 * kVecPairs) {
    uint4 v[kVecPairs];
#pragma unroll
    for (int k = 0; k < kVecPairs; ++k) {  // every load issued before the first use
      const int m = m0 + 2 * k + half;
      v[k] = live && m < M ? __ldg(reinterpret_cast<const uint4*>(row + m * kTileLanes + j0))
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kVecPairs; ++k) {
      const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc = fmaf(bf16_lo(w[i]), qf[2 * i], acc);
        acc = fmaf(bf16_hi(w[i]), qf[2 * i + 1], acc);
      }
      for (int off = kHalfWarp / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int m = m0 + 2 * k + half;
      if (j0 == 0 && m < M) out[m] = acc;
    }
  }
}

}  // namespace

// Launches on `stream` (the caller's current CUDA stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int gt_gather_score_flat(const void* tab, long long n_rows, int row_w,
                                    const void* sel_ids, long long pairs, int expand,
                                    const void* q, int M, int d, void* dots, void* nbrs,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pairs <= 0) return 0;
  const size_t per_warp = row_lanes(M, d) * sizeof(uint16_t) + d * sizeof(float);
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kDefaultSmem) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(gather_score_flat_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (pairs + warps - 1) / warps;
  gather_score_flat_kernel<<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tab), n_rows, row_w, static_cast<const int32_t*>(sel_ids),
      pairs, expand, static_cast<const uint16_t*>(q), M, d, static_cast<float*>(dots),
      static_cast<int32_t*>(nbrs));
  return static_cast<int>(cudaGetLastError());
}

// K2.  Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int gt_gather_score(const void* tab, long long n_rows, int Mp,
                               const void* sel_ids, long long pairs, int expand,
                               const void* q, int M, int d, void* dots,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pairs <= 0) return 0;
  const long long blocks = (pairs + kMaxWarpsPerBlock - 1) / kMaxWarpsPerBlock;
  gather_score_tiled_kernel<<<static_cast<unsigned>(blocks), kMaxWarpsPerBlock * kWarp, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tab), n_rows, Mp, static_cast<const int32_t*>(sel_ids),
      pairs, expand, static_cast<const uint16_t*>(q), M, d, static_cast<float*>(dots));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
