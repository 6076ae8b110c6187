// IVF slot scoring (K3, K4) and fused slot scoring + per-row top-k (K5).
//
// Replaces the Pallas TPU kernels in granne_tpu/ops/pallas/ivf_score.py:
//   K3 ivf_score_slots          (_kernel)          one slot per program
//   K4 ivf_score_slots_grouped  (_kernel_grouped)  G slots per program, the
//                                                  next block's copy in flight
//   K5 _ivf_score_topk          (_kernel_topk)     scores never leave the chip
//
// A slot s pairs one cluster block blocks[key[s]] (L rows of d elements,
// bf16, f32 or int8; the key clamped into [0, k)) with a group of `cap`
// bf16 queries qg[s]:
//   scores[s, c, l] = sum_j bf16(blocks[key, l, j]) * qg[s, c, j]
// Every block element is first rounded to bf16 exactly as the JAX einsum
// does (int8 -> bf16 is exact, f32 -> bf16 rounds to nearest even), so every
// product is exact in f32 and only the summation order differs from the
// plain version.
//
// ---------------------------------------------------------------------------
// K3 and K4: one kernel body (slot_score_kernel), G = 1 for K3.
//
// What bounds them on the H100.  At the serve shape (1,000 blocks of L 256
// x d 100 bf16, 1,520 slots of cap 32) a slot reads its 51 KB block and
// 6.4 KB of queries and writes 32 KB of f32 scores for 1.6 MFLOP, ~18 FLOP
// a byte against the card's ridge of ~295: 137 MB in all, 41 us at
// 3.35 TB/s, where the tensor cores need ~2.5 us.  (The bound in
// chip_smoke.py counts each distinct block once, 30 us; this body reads a
// block once per slot.)  So the design streams bytes and spends little SM
// time on each.  On the card (PERF.md, PR 6) it moves them at ~1.8 TB/s
// (K3) and ~1.6 TB/s (K4): the copies keep up, and what sets the time is
// each thread block's chain of shared-memory round trips per item, the
// staging pass first and the scoring next (diagnostic builds timed each
// phase with clock64, and a block alone on the card took as long per item
// as one among 263 others).
//
// * Bulk copies.  A slot's row tile is one contiguous span of rows * d
//   elements, and its query tile another of up to 32 * d bf16.  One thread
//   arms the stage's mbarrier with the byte count and issues one
//   cp.async.bulk for each span, from the 16-byte granule at or below its
//   first byte up to the last whole granule inside the tensor; the tensor's
//   last ragged bytes, if a span reaches them, are plain loads (a copy
//   rounded up past the last block would read out of bounds).  A 2D tensor
//   map is not possible: TMA wants global strides that are multiples of 16
//   bytes, and a row is 200 B at d 100 bf16, 100 B in int8.
// * Two stages, two thread blocks an SM.  Rows are tiled (LT rows a tile:
//   L, or a multiple of 32) so that two stages, the converted tiles and the
//   barriers fit in half an SM's shared memory (serve: LT 128, 100 KB a
//   block), and larger blocks (L 512 x d 300 f32 is 614 KB) still fit.  A
//   thread block of 8 warps walks its G slots' items (slot, query tile, row
//   tile) with the next item's copy in flight, the Pallas K4's double
//   buffer; the item after it is issued as soon as its stage is converted.
//   At the serve shape K4's 190 groups are all resident at once (264
//   places).  An SM that holds two groups still takes longer than one that
//   holds one: K4 stays ~15% slower than K3, whose 1,520 short blocks
//   balance.
// * A staging pass into a padded pitch.  All threads convert the landed
//   tile to bf16 (bf16 as is, f32 by __float2bfloat16_rn, int8 exactly)
//   into rows of pad16(d) + 8 lanes, zero from d up to pad16(d): one 4-lane
//   load and one 8-byte store at a time when d % 4 == 0, lane by lane
//   otherwise.  The pitch is an odd number of 16-byte granules, so the
//   eight row addresses of an ldmatrix fall in eight different bank groups
//   (a dense 200-byte pitch conflicts 2 ways; 256 bytes, d 128 bf16, 8
//   ways), and any d, alignment and element type reach the tensor cores the
//   same way.  This pass is the largest part of an item (above).
// * Tensor cores.  mma.sync m16n8k16 bf16 -> f32: A is the query tile
//   (two m16 tiles), B the block rows (row l is column n of B, contiguous
//   in k: the .col layout as stored), both by ldmatrix.  A warp scores 32
//   rows against the 32 queries (32 accumulators a lane), k steps of 16 in
//   order over pad16(d) lanes, zero on both operands past d.  Rows past the
//   tile and queries past cap read the last live row (finite) and are never
//   stored.  Every output's sum runs over the same k steps whatever G is,
//   so K3 and K4 agree bit for bit.
// * Stores: a quad of lanes writes 32 contiguous bytes of a score row
//   (float2 each when L is even).
// * A lean, capture-safe launch, as in nbr_score.cu: the device's limits
//   are read and every kernel's shared-memory limit set once per device,
//   cudaSetDevice only when the current device differs, no allocation.
//
// -Xptxas -v (sm_90a, CUDA 12.8): 80 registers for each K3/K4 instance, no
// spills (chip_smoke.py prints the report).
//
// ---------------------------------------------------------------------------
// K5 (ivf_score_kernel, the PR 2 body): one slot per thread block, its row
// tiles copied with 16-byte cp.async into two buffers, scored on the CUDA
// cores (each thread one block row against 8 queries, fmaf).  It keeps the
// [query tile, L] score tile in shared memory, applies block_scales and the
// block_ids < 0 mask, then one warp per query row runs K' = min(k_out, L)
// rounds of warp argmax: the largest value, and among equal values the
// smallest column, as ivf_score.py:177-182 picks.  Only [cap, K'] values and
// element ids are written (ids -1 where the value is -inf).  Bound by
// shared-memory loads (one query value a fmaf), not by HBM.

#include <cstdint>
#include <mutex>
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

// ---------------------------------------------------------------------------
// K3/K4: the tensor-core slot scorer.

constexpr int kSlotWarps = 8;
constexpr int kSlotThreads = kSlotWarps * kWarp;
constexpr int kBlocksPerSm = 2;  // shared memory is planned so that this many blocks share an SM
constexpr int kQT = 32;          // queries a tile: two m16 tiles
constexpr int kUnit = 32;        // block rows a warp scores at once: kUnit / 8 n8 tiles
constexpr int kStages = 2;
constexpr int kBarBytes = 128;   // the mbarriers, ahead of the stages
constexpr int kSpanSlack = 30;   // a span copied from the granule below its start, rounded up to 16
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr long long pad_to(long long v, long long to) { return (v + to - 1) / to * to; }

struct SlotArgs {
  const unsigned char* blocks;  // [k, L, d] elements of `esize` bytes
  long long k_blocks;
  int L, d;
  const int32_t* slot_keys;  // [S]
  int S, G;
  const unsigned char* qg;  // bf16 [S, cap, d]
  int cap;
  float* out;  // f32 [S, cap, L]
  // the plan (plan_slots)
  int LT;          // block rows a tile: L, or a multiple of kUnit
  int dp;          // lanes between two converted rows: pad16(d) + 8
  int nbuf;        // stages (1 or 2)
  int blk_area;    // bytes of a stage that take the block tile's span
  int stage_bytes; // blk_area + the query tile's span area
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// global -> shared bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// D += A x B on the tensor cores: A a 16 x 16 bf16 tile (rows g and g + 8,
// columns 2c, 2c + 1 and 2c + 8, 2c + 9 of lane 4g + c), B 16 x 8 bf16
// (column g, rows 2c, 2c + 1 and 2c + 8, 2c + 9), D 16 x 8 f32 (rows g and
// g + 8, columns 2c and 2c + 1).
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four 8 x 8 bf16 matrices whose rows lanes 8i..8i+7 address, one a
// register.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(addr)));
}

// Bytes [start, start + len) of a tensor of `total` bytes at `base`: a bulk
// copy of the whole 16-byte granules from the one at or below the start up
// to the last granule inside the tensor, then plain loads of what is left
// (the tensor's last, ragged bytes).  Staged at dst, which stands for the
// granule below the start.
struct Span {
  const unsigned char* from;  // the granule at or below the start
  uint32_t bulk;              // bytes of the bulk copy
  const unsigned char* tail;  // the plain loads: [tail, end)
  const unsigned char* end;
};

__device__ __forceinline__ Span span_of(const unsigned char* base, long long total, long long start, long long len) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(base) + start, e = s + len;
  const uintptr_t from = s & ~uintptr_t{15};
  const uintptr_t last = (reinterpret_cast<uintptr_t>(base) + total) & ~uintptr_t{15};
  uintptr_t to = (e + 15) & ~uintptr_t{15};
  if (to > last) to = last;
  Span sp;
  sp.from = reinterpret_cast<const unsigned char*>(from);
  sp.bulk = to > from ? static_cast<uint32_t>(to - from) : 0u;
  sp.tail = reinterpret_cast<const unsigned char*>(from + sp.bulk > s ? from + sp.bulk : s);
  sp.end = reinterpret_cast<const unsigned char*>(e);
  return sp;
}

__device__ __forceinline__ void load_tail(unsigned char* dst, const Span& sp) {
  for (const unsigned char* p = sp.tail; p < sp.end; ++p) dst[p - sp.from] = *p;
}

// The work item `it` of a block whose first slot is s0: slot, query tile,
// row tile, the row tile fastest.
struct Item {
  int s, qt, lt;
};

__device__ __forceinline__ Item item_of(int s0, int it, int nq, int nl) {
  return {s0 + it / (nl * nq), (it / nl) % nq, it % nl};
}

__device__ __forceinline__ long long clamp_key(long long key, long long k) {
  return key < 0 ? 0 : (key >= k ? k - 1 : key);
}

// One thread: arm `bar` and start the copies of item `m` (block row tile,
// and with the first row tile its query tile) into `stage`.
template <typename T>
__device__ void issue_item(const SlotArgs& a, const Item& m, long long key, unsigned char* stage, uint64_t* bar) {
  constexpr long long es = sizeof(T);
  const int row0 = m.lt * a.LT;
  const int rows = min(a.LT, a.L - row0);
  const Span blk = span_of(a.blocks, a.k_blocks * a.L * a.d * es, (key * a.L + row0) * a.d * es,
                           static_cast<long long>(rows) * a.d * es);
  Span q = {nullptr, 0u, nullptr, nullptr};
  if (m.lt == 0) {
    const int c0 = m.qt * kQT;
    const int nqr = min(kQT, a.cap - c0);
    q = span_of(a.qg, static_cast<long long>(a.S) * a.cap * a.d * 2, (static_cast<long long>(m.s) * a.cap + c0) * a.d * 2,
                static_cast<long long>(nqr) * a.d * 2);
  }
  mbar_arrive_expect_tx(bar, blk.bulk + q.bulk);
  if (blk.bulk) bulk_copy(stage, blk.from, blk.bulk, bar);
  if (q.bulk) bulk_copy(stage + a.blk_area, q.from, q.bulk, bar);
  load_tail(stage, blk);
  if (m.lt == 0) load_tail(stage + a.blk_area, q);
}

__device__ __forceinline__ uint32_t bf16_bits(uint16_t v) { return v; }
__device__ __forceinline__ uint32_t bf16_bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
__device__ __forceinline__ uint32_t bf16_bits(int8_t v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(v)));  // exact
}

// Four consecutive elements of T at `p` (aligned to 4 elements), as two
// bf16 pairs, the lower index in the low half.
template <typename T>
__device__ __forceinline__ uint2 load_quad(const T* p);
template <>
__device__ __forceinline__ uint2 load_quad<uint16_t>(const uint16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}
template <>
__device__ __forceinline__ uint2 load_quad<float>(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16), bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}
template <>
__device__ __forceinline__ uint2 load_quad<int8_t>(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_uint2(bf16_bits(static_cast<int8_t>(v.x)) | (bf16_bits(static_cast<int8_t>(v.y)) << 16),
                    bf16_bits(static_cast<int8_t>(v.z)) | (bf16_bits(static_cast<int8_t>(v.w)) << 16));
}

// All threads: `rows` staged rows of d elements of T, back to back from
// `src`, into bf16 rows of `dp` lanes at `dst`, zero from d up to pad16(d).
// kVec: d % 4 == 0 and src on a 4-element boundary, so 4 lanes are one load.
// The loops stay rolled: unrolled copies of this pass made it slower on the
// card.
template <typename T, bool kVec>
__device__ __forceinline__ void convert_rows(const unsigned char* src, int rows, int d, int dp, uint16_t* dst) {
  const int quads = (d + 15) / 16 * 4;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll 1
  for (int r = warp; r < rows; r += kSlotWarps) {
    const T* row = reinterpret_cast<const T*>(src) + static_cast<long long>(r) * d;
    uint16_t* out = dst + static_cast<long long>(r) * dp;
#pragma unroll 1
    for (int u = lane; u < quads; u += kWarp) {
      const int j = 4 * u;
      uint2 w;
      if (kVec && j < d) {
        w = load_quad<T>(row + j);
      } else {
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = j + i < d ? bf16_bits(row[j + i]) : 0u;
        w = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
      }
      *reinterpret_cast<uint2*>(out + j) = w;
    }
  }
}

// All warps: the scores of `nqr` converted queries at A against `rows`
// converted block rows at B, into out[c, l] = out + c * L + l.  A warp takes
// kUnit rows at a time (four n8 tiles) against all kQT queries (two m16
// tiles); rows and queries past the live ones read the last live one and
// are not stored.  pairs: every score row starts on an 8-byte boundary.
__device__ __forceinline__ void score_tile(const uint16_t* A, int nqr, const uint16_t* B, int rows, int d, int dp,
                                           float* out, int L, bool pairs) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, c = lane & 3;
  const int kend = (d + 15) / 16 * 16;
  // ldmatrix addressing: A matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
  // B matrices (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): b0, b1 of two n8 tiles
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const uint16_t* pa[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) pa[t] = A + min(16 * t + arow, nqr - 1) * dp + acol;
  constexpr int NT = kUnit / 8;  // n8 tiles a unit, two an ldmatrix
  for (int n0 = warp * kUnit; n0 < rows; n0 += kSlotWarps * kUnit) {
    const uint16_t* pb[NT / 2];
#pragma unroll
    for (int t = 0; t < NT / 2; ++t) pb[t] = B + min(n0 + 16 * t + brow, rows - 1) * dp + bcol;
    float acc[2][NT][4] = {};
    for (int k = 0; k < kend; k += 16) {
      uint32_t af[2][4], bf[NT / 2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) ldmatrix_x4(af[t], pa[t] + k);
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) ldmatrix_x4(bf[t], pb[t] + k);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 16 * mt + 8 * h + g;
        if (q >= nqr) continue;
        float* orow = out + static_cast<long long>(q) * L;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int l = n0 + 8 * nt + 2 * c;
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (pairs && l + 1 < rows) {
            *reinterpret_cast<float2*>(orow + l) = make_float2(v0, v1);
          } else {
            if (l < rows) orow[l] = v0;
            if (l + 1 < rows) orow[l + 1] = v1;
          }
        }
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kSlotThreads) slot_score_kernel(const __grid_constant__ SlotArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + kBarBytes;
  uint16_t* Bc = reinterpret_cast<uint16_t*>(stages + a.nbuf * a.stage_bytes);  // [LT, dp]
  uint16_t* Ac = Bc + static_cast<long long>(a.LT) * a.dp;                       // [min(cap, kQT), dp]

  const int s0 = blockIdx.x * a.G;
  const int nq = (a.cap + kQT - 1) / kQT;
  const int nl = (a.L + a.LT - 1) / a.LT;
  const int items = min(a.G, a.S - s0) * nq * nl;
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    for (int b = 0; b < a.nbuf; ++b) mbar_init(&bars[b]);
    for (int it = 0; it < a.nbuf && it < items; ++it) {
      const Item m = item_of(s0, it, nq, nl);
      issue_item<T>(a, m, clamp_key(a.slot_keys[m.s], a.k_blocks), stages + it * a.stage_bytes, &bars[it]);
    }
  }
  __syncthreads();
  for (int it = 0; it < items; ++it) {
    const int b = it % a.nbuf;
    const Item m = item_of(s0, it, nq, nl);
    const int nxt = it + a.nbuf;
    const Item mn = item_of(s0, nxt, nq, nl);
    // the next key's load is in flight while this item lands and converts
    const long long next_key = issuer && nxt < items ? clamp_key(a.slot_keys[mn.s], a.k_blocks) : 0;
    unsigned char* stage = stages + b * a.stage_bytes;
    mbar_wait(&bars[b], (it / a.nbuf) & 1);

    const int row0 = m.lt * a.LT;
    const int rows = min(a.LT, a.L - row0);
    const int c0 = m.qt * kQT;
    const int nqr = min(kQT, a.cap - c0);
    if (m.lt == 0) {
      const uintptr_t q0 = reinterpret_cast<uintptr_t>(a.qg) + (static_cast<long long>(m.s) * a.cap + c0) * a.d * 2;
      convert_rows<uint16_t, kVec>(stage + a.blk_area + (q0 & 15), nqr, a.d, a.dp, Ac);
    }
    const long long key = clamp_key(a.slot_keys[m.s], a.k_blocks);
    const uintptr_t r0 = reinterpret_cast<uintptr_t>(a.blocks) + (key * a.L + row0) * a.d * static_cast<long long>(sizeof(T));
    convert_rows<T, kVec>(stage + (r0 & 15), rows, a.d, a.dp, Bc);
    __syncthreads();  // the converted tiles are in place; the stage is free
    if (issuer && nxt < items) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stage's reads before its async refill
      issue_item<T>(a, mn, next_key, stage, &bars[b]);
    }
    score_tile(Ac, nqr, Bc, rows, a.d, a.dp, a.out + (static_cast<long long>(m.s) * a.cap + c0) * a.L + row0, a.L,
               a.L % 2 == 0 && a.LT % 2 == 0);
    __syncthreads();  // the converted tiles are free again
  }
}

// ---------------------------------------------------------------------------
// The launches.

struct DeviceLimits {
  int smem_block = 0;  // opt-in dynamic shared memory a block may use
  int smem_sm = 0;     // shared memory of one SM
  cudaError_t err = cudaSuccess;
};

DeviceLimits g_limits[kMaxDevices];
std::once_flag g_once[kMaxDevices];

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The device's limits, and every kernel instance allowed all of a block's
// shared memory (the current device must be `device`).
DeviceLimits read_limits(int device) {
  DeviceLimits l;
  cudaError_t err = cudaDeviceGetAttribute(&l.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (!err) err = cudaDeviceGetAttribute(&l.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  const int b = l.smem_block;
  if (!err) err = allow_smem(slot_score_kernel<uint16_t, true>, b);
  if (!err) err = allow_smem(slot_score_kernel<uint16_t, false>, b);
  if (!err) err = allow_smem(slot_score_kernel<float, true>, b);
  if (!err) err = allow_smem(slot_score_kernel<float, false>, b);
  if (!err) err = allow_smem(slot_score_kernel<int8_t, true>, b);
  if (!err) err = allow_smem(slot_score_kernel<int8_t, false>, b);
  if (!err) err = allow_smem(ivf_score_kernel<uint16_t, true>, b);
  if (!err) err = allow_smem(ivf_score_kernel<float, true>, b);
  if (!err) err = allow_smem(ivf_score_kernel<int8_t, true>, b);
  l.err = err;
  return l;
}

// Make `device` current if it is not, and read its limits once.
cudaError_t use_device(int device, const DeviceLimits** limits) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  std::call_once(g_once[device], [device] { g_limits[device] = read_limits(device); });
  *limits = &g_limits[device];
  return g_limits[device].err;
}

// K5's tile sizes for one call, into `a`; `*smem` gets the dynamic shared
// memory.  Query tiles of CQ rows (a multiple of kQ, at most 32), row tiles
// of LT rows; two tile buffers whenever a thread block has more than one
// item.
cudaError_t make_plan(int optin, int esize, Args* a, size_t* smem) {
  const int L = a->L, d = a->d, cap = a->cap;
  const size_t budget = static_cast<size_t>(optin);
  int CQ = ((cap + kQ - 1) / kQ) * kQ;
  if (CQ > 32) CQ = 32;
  while (CQ > kQ && (static_cast<size_t>(CQ) * d * 4 > budget / 4 || static_cast<size_t>(CQ) * L * 4 > budget / 2))
    CQ -= kQ;
  const size_t fixed = static_cast<size_t>(CQ) * d * 4 + static_cast<size_t>(CQ) * L * 4;
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

int launch_topk(Args a, int dtype, int device, void* stream) {
  const DeviceLimits* lim = nullptr;
  cudaError_t err = use_device(device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.S <= 0 || a.cap <= 0 || a.L <= 0) return 0;
  const int esize = dtype == 1 ? 4 : (dtype == 2 ? 1 : 2);
  size_t smem = 0;
  err = make_plan(lim->smem_block, esize, &a, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((a.S + a.G - 1) / a.G);
  switch (dtype) {
    case 0: ivf_score_kernel<uint16_t, true><<<grid, kThreads, smem, st>>>(a); break;
    case 1: ivf_score_kernel<float, true><<<grid, kThreads, smem, st>>>(a); break;
    case 2: ivf_score_kernel<int8_t, true><<<grid, kThreads, smem, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a K3/K4 block at row tile LT.
long long slot_smem(const SlotArgs& a, int esize, int LT, int nbuf) {
  const long long q_rows = a.cap < kQT ? a.cap : kQT;
  const long long blk = pad_to(static_cast<long long>(LT) * a.d * esize + kSpanSlack, 16);
  const long long qry = pad_to(q_rows * a.d * 2 + kSpanSlack, 16);
  return kBarBytes + nbuf * (blk + qry) + (LT + q_rows) * a.dp * 2;
}

// The row tile, stages and shared memory of a K3/K4 call, into `a`.  The
// tile is the largest (L, or a multiple of kUnit rows) with which
// kBlocksPerSm blocks share an SM, else with which one block fits; it does
// not depend on G or S, so neither does any output's summation order.
cudaError_t plan_slots(const DeviceLimits& lim, int esize, SlotArgs* a, int* smem) {
  a->dp = static_cast<int>(pad_to(a->d, 16)) + 8;
  const long long shared = lim.smem_sm / kBlocksPerSm - 1024;  // 1 KB a block for the runtime
  int LT = 0;
  for (const long long budget : {shared < lim.smem_block ? shared : static_cast<long long>(lim.smem_block),
                                 static_cast<long long>(lim.smem_block)}) {
    if (slot_smem(*a, esize, a->L, kStages) <= budget) {
      LT = a->L;
      break;
    }
    int lt = a->L / kUnit * kUnit;
    while (lt > kUnit && slot_smem(*a, esize, lt, kStages) > budget) lt -= kUnit;
    if (lt >= kUnit && slot_smem(*a, esize, lt, kStages) <= budget) {
      LT = lt;
      break;
    }
    lt = a->L < kUnit ? a->L : kUnit;  // very long rows: fewer rows a tile
    while (lt > 1 && slot_smem(*a, esize, lt, kStages) > budget) --lt;
    if (slot_smem(*a, esize, lt, kStages) <= budget) {
      LT = lt;
      break;
    }
  }
  if (LT == 0) return cudaErrorInvalidValue;  // one row does not fit in shared memory
  const int nq = (a->cap + kQT - 1) / kQT;
  const int nl = (a->L + LT - 1) / LT;
  const int items = (a->G < a->S ? a->G : a->S) * nq * nl;
  a->LT = LT;
  a->nbuf = items > 1 ? kStages : 1;
  a->blk_area = static_cast<int>(pad_to(static_cast<long long>(LT) * a->d * esize + kSpanSlack, 16));
  a->stage_bytes = a->blk_area + static_cast<int>(pad_to((a->cap < kQT ? a->cap : kQT) * 2LL * a->d + kSpanSlack, 16));
  *smem = static_cast<int>(slot_smem(*a, esize, LT, a->nbuf));
  return cudaSuccess;
}

int launch_slots(SlotArgs a, int dtype, int device, cudaStream_t stream) {
  const DeviceLimits* lim = nullptr;
  cudaError_t err = use_device(device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.S <= 0 || a.cap <= 0 || a.L <= 0) return 0;
  const int esize = dtype == 1 ? 4 : (dtype == 2 ? 1 : 2);
  int smem = 0;
  err = plan_slots(*lim, esize, &a, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = a.d % 4 == 0;  // 4 lanes of a row are one aligned load
  const unsigned grid = static_cast<unsigned>((a.S + a.G - 1) / a.G);
  switch (dtype * 2 + (vec ? 1 : 0)) {
    case 0: slot_score_kernel<uint16_t, false><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 1: slot_score_kernel<uint16_t, true><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 2: slot_score_kernel<float, false><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 3: slot_score_kernel<float, true><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 4: slot_score_kernel<int8_t, false><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 5: slot_score_kernel<int8_t, true><<<grid, kSlotThreads, smem, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Block dtype codes: 0 = bf16, 1 = f32, 2 = int8.  Both functions launch on
// `stream` (the caller's current CUDA stream) and return cudaGetLastError()
// as an int: 0 when the launch was accepted.  `blocks` and `qg` start on
// 16-byte boundaries.

extern "C" int gt_ivf_score_slots(const void* blocks, int dtype, long long k_blocks, int L, int d,
                                  const void* slot_keys, int S, const void* qg, int cap, int group,
                                  void* out, int device, void* stream) {
  SlotArgs a = {};
  a.blocks = static_cast<const unsigned char*>(blocks);
  a.k_blocks = k_blocks;
  a.L = L;
  a.d = d;
  a.slot_keys = static_cast<const int32_t*>(slot_keys);
  a.S = S;
  a.G = group < 1 ? 1 : group;
  a.qg = static_cast<const unsigned char*>(qg);
  a.cap = cap;
  a.out = static_cast<float*>(out);
  return launch_slots(a, dtype, device, static_cast<cudaStream_t>(stream));
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
  return launch_topk(a, dtype, device, stream);
}

extern "C" const char* gt_ivf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
