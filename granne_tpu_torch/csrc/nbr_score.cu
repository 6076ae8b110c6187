// Fused flat neighbor-cache gather + candidate scoring + id unpack (K1).
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;

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

extern "C" const char* gt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
