// IVF slot scoring (K3, K4) and fused slot scoring + per-row top-k (K5).
//
// Replaces the Pallas TPU kernels in granne_tpu/ops/pallas/ivf_score.py:
//   K3 ivf_score_slots          (_kernel)          one slot per program
//   K4 ivf_score_slots_grouped  (_kernel_grouped)  G slots per program, the
//                                                  next block's copy in flight
//   K5 _ivf_score_topk          (_kernel_topk)     scores never leave the chip
//
// A slot s pairs one cluster block blocks[key[s]] (L rows of d elements,
// bf16, f32 or int8) with a group of `cap` bf16 queries qg[s]:
//   scores[s, c, l] = sum_j bf16(blocks[key, l, j]) * qg[s, c, j]
// Every block element is first rounded to bf16 exactly as the JAX einsum
// does (int8 -> bf16 is exact, f32 -> bf16 rounds to nearest even), so every
// product is exact in f32; products accumulate in f32 with fmaf.
//
// One kernel body serves all three.  A thread block takes G consecutive
// slots (G = 1 is K3, G = `group` is K4; the last group may be shorter, S is
// never padded) and walks work items (slot, query tile, row tile).  For each
// item it copies the block's row tile, one contiguous span of rows * d
// elements, into shared memory with 16-byte cp.async copies (d = 100 makes
// single bf16 rows only 8-byte aligned, so the span is copied as a whole
// from the 16-byte boundary below it), and it starts the NEXT item's copy
// before it scores the current one: the double buffering of the Pallas
// kernel's make_async_copy pair.  Rows are tiled so that any (L, d) fits
// the 227 KB of shared memory (a block of L = 512, d = 300 in f32 is 614 KB).
//
// K5 keeps the [query tile, L] score tile in shared memory, applies
// block_scales and the block_ids < 0 mask, then one warp per query row runs
// K' = min(k_out, L) rounds of warp argmax: the largest value, and among
// equal values the smallest column, as ivf_score.py:177-182 picks.  Only
// [cap, K'] values and element ids are written (ids -1 where the value is
// -inf).
//
// What bounds it on the H100: at the serve shape (L = 256, d = 100,
// cap = 32, ~1,500 slots) each slot reads a 51 KB block once and does
// ~1.6 MFLOP with it, ~32 FLOP per byte.  This first version scores on the
// CUDA cores (each thread holds 8 accumulators: one block row against 8
// queries, the query values broadcast from shared memory), so it is bound by
// shared-memory loads, not by HBM.  Tensor cores (mma.sync / wgmma on bf16
// tiles) are what a later version adds.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kQ = 8;  // queries per thread (accumulators)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// A block element rounded to bf16, as a float.
template <typename T>
__device__ __forceinline__ float to_bf16_value(T v);
template <>
__device__ __forceinline__ float to_bf16_value<uint16_t>(uint16_t v) {
  return bf16_bits_to_float(v);
}
template <>
__device__ __forceinline__ float to_bf16_value<float>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float to_bf16_value<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_0() { asm volatile("cp.async.wait_group 0;\n" ::); }

struct Args {
  const unsigned char* blocks;  // [k, L, d] elements of `esize` bytes
  long long k_blocks;
  int L, d;
  const int32_t* slot_keys;  // [S]
  int S, G;
  const uint16_t* qg;  // bf16 [S, cap, d]
  int cap;
  float* out;  // [S, cap, L] (scoring)
  const int32_t* block_ids;  // [k, L] (top-k)
  const float* block_scales;  // [k, L] (top-k)
  int kp, k_out;
  float* out_v;  // [S, cap, k_out] (top-k)
  int32_t* out_i;
  // the tile plan (make_plan)
  int LT;    // rows per tile
  int CQ;    // queries per tile (a multiple of kQ)
  int nbuf;  // tile buffers (1 or 2)
  size_t tile_bytes;
};

__device__ __forceinline__ long long slot_key(const Args& a, int s) {
  long long key = a.slot_keys[s];
  return key < 0 ? 0 : (key >= a.k_blocks ? a.k_blocks - 1 : key);
}

// Start copying row tile `lt` of slot `s`'s block into `buf`, from the
// 16-byte boundary at or below the tile's first byte; the compute side
// recomputes the same offsets.
template <typename T>
__device__ void issue_tile(const Args& a, int s, int lt, unsigned char* buf) {
  const long long key = slot_key(a, s);
  const int row0 = lt * a.LT;
  const int rows = min(a.LT, a.L - row0);
  const long long start = ((key * a.L + row0) * a.d) * static_cast<long long>(sizeof(T));
  const long long len = static_cast<long long>(rows) * a.d * sizeof(T);
  const long long total = a.k_blocks * a.L * a.d * static_cast<long long>(sizeof(T));
  const long long a0 = start & ~15LL;
  const int chunks = static_cast<int>((start - a0 + len + 15) / 16);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const long long g = a0 + 16LL * c;
    if (g + 16 <= total) {
      cp_async16(buf + 16 * c, a.blocks + g);
    } else {  // the tensor's last, ragged 16 bytes: plain loads
      for (long long b = g; b < total; ++b) buf[16 * c + (b - g)] = a.blocks[b];
    }
  }
}

template <typename T, bool kTopk>
__global__ void __launch_bounds__(kThreads) ivf_score_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* bufs = smem;
  float* qs = reinterpret_cast<float*>(smem + a.nbuf * a.tile_bytes);  // [CQ, d]
  float* sc = qs + static_cast<size_t>(a.CQ) * a.d;                   // [CQ, L] (top-k)

  const int s0 = blockIdx.x * a.G;
  const int ns = min(a.G, a.S - s0);
  const int nq = (a.cap + a.CQ - 1) / a.CQ;
  const int nl = (a.L + a.LT - 1) / a.LT;
  const int items = ns * nq * nl;
  const int tid = threadIdx.x;

  issue_tile<T>(a, s0, 0, bufs);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    const int lt = it % nl;
    const int qt = (it / nl) % nq;
    const int s = s0 + it / (nl * nq);
    if (it + 1 < items) {
      const int nxt = it + 1;
      issue_tile<T>(a, s0 + nxt / (nl * nq), nxt % nl, bufs + (nxt % a.nbuf) * a.tile_bytes);
      cp_async_commit();
      cp_async_wait_1();
    } else {
      cp_async_wait_0();
    }
    const int c0 = qt * a.CQ;
    const int nqr = min(a.CQ, a.cap - c0);
    if (lt == 0) {  // a new query tile: bf16 -> f32 into shared memory
      const uint16_t* src = a.qg + (static_cast<long long>(s) * a.cap + c0) * a.d;
      for (int i = tid; i < nqr * a.d; i += blockDim.x) qs[i] = bf16_bits_to_float(src[i]);
    }
    __syncthreads();

    const long long key = slot_key(a, s);
    const int row0 = lt * a.LT;
    const int rows = min(a.LT, a.L - row0);
    const long long start = ((key * a.L + row0) * a.d) * static_cast<long long>(sizeof(T));
    const T* tile = reinterpret_cast<const T*>(bufs + (it % a.nbuf) * a.tile_bytes + (start & 15LL));
    const int qgroups = (nqr + kQ - 1) / kQ;
    for (int u = tid; u < rows * qgroups; u += blockDim.x) {
      const int r = u % rows;  // neighbouring threads: neighbouring rows, the same queries
      const int cq = (u / rows) * kQ;
      const T* row = tile + static_cast<long long>(r) * a.d;
      const float* qrow = qs + static_cast<long long>(cq) * a.d;
      float acc[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int j = 0; j < a.d; ++j) {
        const float b = to_bf16_value<T>(row[j]);
#pragma unroll
        for (int i = 0; i < kQ; ++i) acc[i] = fmaf(b, qrow[i * a.d + j], acc[i]);
      }
      const int l = row0 + r;
      if (kTopk) {
        const long long col = key * a.L + l;
        const float scale = a.block_scales[col];
        const bool live = a.block_ids[col] >= 0;
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          if (cq + i < nqr) sc[static_cast<long long>(cq + i) * a.L + l] = live ? acc[i] * scale : neg_inf();
      } else {
        float* o = a.out + (static_cast<long long>(s) * a.cap + c0 + cq) * a.L + l;
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          if (cq + i < nqr) o[static_cast<long long>(i) * a.L] = acc[i];
      }
    }
    __syncthreads();  // the tile buffer and qs are free again

    if (kTopk && lt == nl - 1) {  // the query tile's full [nqr, L] scores are in `sc`
      const int warp = tid / kWarp, lane = tid % kWarp;
      for (int r = warp; r < nqr; r += blockDim.x / kWarp) {
        float* srow = sc + static_cast<long long>(r) * a.L;
        const long long o = (static_cast<long long>(s) * a.cap + c0 + r) * a.k_out;
        for (int t = 0; t < a.kp; ++t) {
          float bv = neg_inf();
          int bi = 0x7fffffff;  // stays so only if every value is NaN
          for (int l = lane; l < a.L; l += kWarp) {
            const float v = srow[l];
            if (v > bv || (v == bv && l < bi)) { bv = v; bi = l; }
          }
#pragma unroll
          for (int off = kWarp / 2; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
          }
          if (lane == 0) {
            const bool hit = bi < a.L && bv != neg_inf();
            a.out_v[o + t] = bv;
            a.out_i[o + t] = hit ? a.block_ids[key * a.L + bi] : -1;
            if (bi < a.L) srow[bi] = neg_inf();
          }
          __syncwarp();
        }
      }
      __syncthreads();  // `sc` is free again
    }
  }
}

// Tile sizes for one call, into `a`; `*smem` gets the dynamic shared memory.
// Query tiles of CQ rows (a multiple of kQ, at most 32), row tiles of LT
// rows; two tile buffers whenever a thread block has more than one item.
cudaError_t make_plan(int device, int esize, bool topk, Args* a, size_t* smem) {
  const int L = a->L, d = a->d, cap = a->cap;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(optin);
  int CQ = ((cap + kQ - 1) / kQ) * kQ;
  if (CQ > 32) CQ = 32;
  while (CQ > kQ && (static_cast<size_t>(CQ) * d * 4 > budget / 4 ||
                     (topk && static_cast<size_t>(CQ) * L * 4 > budget / 2)))
    CQ -= kQ;
  const size_t fixed = static_cast<size_t>(CQ) * d * 4 + (topk ? static_cast<size_t>(CQ) * L * 4 : 0);
  const size_t row_bytes = static_cast<size_t>(d) * esize;
  if (fixed + 2 * (row_bytes + 32) > budget) return cudaErrorInvalidValue;
  const size_t per_buf = (budget - fixed) / 2 - 32;  // room for the 16-byte head and tail
  int LT = static_cast<int>(per_buf / row_bytes);
  if (LT > L) LT = L;
  const int nq = (cap + CQ - 1) / CQ;
  const int nl = (L + LT - 1) / LT;
  const int items = (a->G < a->S ? a->G : a->S) * nq * nl;
  a->LT = LT;
  a->CQ = CQ;
  a->nbuf = items > 1 ? 2 : 1;
  a->tile_bytes = ((static_cast<size_t>(LT) * row_bytes + 16 + 15) / 16) * 16;
  *smem = a->nbuf * a->tile_bytes + fixed;
  return cudaSuccess;
}

template <typename T, bool kTopk>
cudaError_t launch_typed(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = ivf_score_kernel<T, kTopk>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(a.S + a.G - 1) / a.G, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kTopk>
int launch(Args a, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.S <= 0 || a.cap <= 0 || a.L <= 0) return 0;
  const int esize = dtype == 1 ? 4 : (dtype == 2 ? 1 : 2);
  size_t smem = 0;
  err = make_plan(device, esize, kTopk, &a, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_typed<uint16_t, kTopk>(a, smem, st); break;
    case 1: err = launch_typed<float, kTopk>(a, smem, st); break;
    case 2: err = launch_typed<int8_t, kTopk>(a, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// Block dtype codes: 0 = bf16, 1 = f32, 2 = int8.  Both functions launch on
// `stream` (the caller's current CUDA stream) and return cudaGetLastError()
// as an int: 0 when the launch was accepted.

extern "C" int gt_ivf_score_slots(const void* blocks, int dtype, long long k_blocks, int L, int d,
                                  const void* slot_keys, int S, const void* qg, int cap, int group,
                                  void* out, int device, void* stream) {
  Args a = {};
  a.blocks = static_cast<const unsigned char*>(blocks);
  a.k_blocks = k_blocks;
  a.L = L;
  a.d = d;
  a.slot_keys = static_cast<const int32_t*>(slot_keys);
  a.S = S;
  a.G = group < 1 ? 1 : group;
  a.qg = static_cast<const uint16_t*>(qg);
  a.cap = cap;
  a.out = static_cast<float*>(out);
  return launch<false>(a, dtype, device, stream);
}

extern "C" int gt_ivf_score_topk(const void* blocks, int dtype, long long k_blocks, int L, int d,
                                 const void* block_ids, const void* block_scales,
                                 const void* slot_keys, int S, const void* qg, int cap, int group,
                                 int kp, int k_out, void* out_v, void* out_i, int device,
                                 void* stream) {
  Args a = {};
  a.blocks = static_cast<const unsigned char*>(blocks);
  a.k_blocks = k_blocks;
  a.L = L;
  a.d = d;
  a.slot_keys = static_cast<const int32_t*>(slot_keys);
  a.S = S;
  a.G = group < 1 ? 1 : group;
  a.qg = static_cast<const uint16_t*>(qg);
  a.cap = cap;
  a.block_ids = static_cast<const int32_t*>(block_ids);
  a.block_scales = static_cast<const float*>(block_scales);
  a.kp = kp;
  a.k_out = k_out;
  a.out_v = static_cast<float*>(out_v);
  a.out_i = static_cast<int32_t*>(out_i);
  return launch<true>(a, dtype, device, stream);
}

extern "C" const char* gt_ivf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
