// IVF slot scoring (K3, K4), the same scoring stored straight into each
// query's rows of the merge (the pair store), and fused slot scoring +
// per-row top-k (K5), one kernel body.
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
//   (float2 each when L is even).  K5 hands the same accumulators to its
//   own epilogue (below), and so does the pair store.
// * The pair store (gt_ivf_score_pairs, the search's K3/K4 route): each
//   item's stage also takes the row tile's block_ids and block_scales, as
//   K5's does, and the scores go to the merge's own [P, L] rows, one a
//   (query, probed block) pair: query row q of slot s holds the pair p =
//   slot_pairs[s, c0 + q] (read once an item), and its scores times the
//   row's scale (one f32 multiply after the mma, as the plain version's
//   `scores * scale`), -inf where the row's id is negative, go to
//   out[p, row0 + l] with the same quad stores.  An empty place (p < 0)
//   stores nothing, so a call writes only the rows of queries (at the
//   serve shapes 28-30% of K4's), and the pairs no slot holds keep the
//   caller's -inf fill.  A thread block skips its items past the last
//   query tile that holds a pair (group_pairs leaves the unused slots
//   last, so whole blocks at the grid's end exit at once), and a warp
//   skips the second m16 tile's ldmatrix and mma where none of queries
//   16-31 holds a pair.  A row segment is contiguous, so the scattered
//   rows cost no more DRAM sectors than K4's, and no pass over every
//   slot's [cap, L] f32 scores follows the kernel (a scale, a mask, a row
//   gather and a scatter to the pairs would each read and write them).
// * A lean, capture-safe launch, as in nbr_score.cu: the device's limits
//   are read and every kernel's shared-memory limit set once per device,
//   cudaSetDevice only when the current device differs, no allocation.
//
// ---------------------------------------------------------------------------
// K5: the same body (slot_score_kernel with a top-k output kind), one slot
// per thread block as the Pallas kernel has one per grid step.
//
// What bounds it on the H100.  At the serve shape (k_out 10) a slot reads
// what a K3 slot reads plus its block's ids and scales (2 KB) and writes only
// 32 x 10 values and ids (2.5 KB): ~95 MB in all, 28 us at 3.35 TB/s, against
// K3's 137 MB.  The [cap, L] scores never leave the SM, so the time is each
// block's chain per item: the staging pass and scoring (as for K3/K4), then
// the top-k merge, whose shuffle networks run one after another within a
// warp (PERF.md §6: clock64 builds put most of an item there and in the
// staging pass).
//
// * Copies, staging and scoring as K3/K4.  Each item's stage also takes the
//   row tile's block_ids and block_scales (L * 4 bytes each per block, bulk
//   copied with the rows), moved out of the stage with the staging pass so
//   the stage can refill at once.
// * Row tiles of at most 128 rows (kMaxLT), so a warp scores at most one
//   unit and holds its accumulators across a barrier: once every warp has
//   read the converted block tile, the accumulators times the row's scale,
//   -inf where the row's id is negative, go into a [query tile, LT] f32
//   score tile over it (pitch 8 mod 32 floats: conflict-free float2 stores).
//   So the plan keeps two blocks an SM at LT 128 (serve: ~104 KB a block): a
//   whole [32, L] f32 tile beside K3/K4's stages would not fit.
// * A running top-K' per query row across row tiles (a 614 KB block is
//   scored in many): a warp owns four query rows, and with K' <= 16 a row's
//   list lives in registers, entry t in lane t, sorted best first.  A tile's
//   candidates are its scores above the list's K'-th; for an empty list,
//   those at or above the K'-th largest of the lanes' maxima (a values-only
//   bitonic sort), a bound K' scores of the tile reach, so a random tile of
//   128 gives ~K' of them.  They are packed in column order beside the list,
//   32 - K' at a time, and a bitonic sort of 32 (value, column) pairs, the
//   larger value and then the lower column first, makes the new list: among
//   equal values the lower column comes first, as ivf_score.py:177-182
//   picks, across tile boundaries too.  The four rows' networks interleave.
//   Ids are read for the K' winners only, at the end.  With K' > 16 the list
//   lives in the row's own output columns, and each candidate is inserted
//   after every entry of equal value, the entries below it moving down a
//   chunk of 32 at a time (the slower path, for large k_out).
// * Every one of the k_out output columns is written, (-inf, -1) past K' and
//   wherever the value is -inf, so the outputs need no fill.
//
// -Xptxas -v (sm_90a, CUDA 12.8): 116-121 registers for each K5 instance, no
// spills; K3/K4 unchanged at 80 (chip_smoke.py prints the report).

#include <cstdint>
#include <mutex>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// ---------------------------------------------------------------------------
// The slot scorer (K3, K4, K5).

constexpr int kSlotWarps = 8;
constexpr int kSlotThreads = kSlotWarps * kWarp;
constexpr int kBlocksPerSm = 2;  // shared memory is planned so that this many blocks share an SM
constexpr int kQT = 32;          // queries a tile: two m16 tiles
constexpr int kUnit = 32;        // block rows a warp scores at once: kUnit / 8 n8 tiles
constexpr int kStages = 2;
constexpr int kBarBytes = 128;   // the mbarriers, ahead of the stages
constexpr int kSpanSlack = 30;   // a span copied from the granule below its start, rounded up to 16
constexpr int kMaxDevices = 64;
constexpr int kRowsPerWarp = kQT / kSlotWarps;  // K5: query rows whose top-K' a warp keeps
constexpr int kRegK = 16;                       // K5: the longest top-K' kept in registers, an entry a lane
constexpr int kMaxLT = 4 * kUnit;               // K5: the longest row tile (a warp scores one unit at most)
constexpr int kMaxJ = kMaxLT / kWarp;           // K5: a row tile's scores of one query row per lane

// What a slot_score_kernel instance writes.
constexpr int kScores = 0;      // K3/K4: the raw scores
constexpr int kTopkRegs = 1;    // K5 with K' <= kRegK: each row's running top-K' in registers, an entry a lane
constexpr int kTopkGlobal = 2;  // K5 with K' > kRegK: each row's running top-K' in its own output row
constexpr int kPairs = 3;       // the pair store: scaled, masked scores in each query's row of the merge

__host__ __device__ constexpr long long pad_to(long long v, long long to) { return (v + to - 1) / to * to; }

struct SlotArgs {
  const unsigned char* blocks;  // [k, L, d] elements of `esize` bytes
  long long k_blocks;
  int L, d;
  const int32_t* slot_keys;  // [S]
  int S, G;
  const unsigned char* qg;  // bf16 [S, cap, d]
  int cap;
  float* out;  // K3/K4: f32 [S, cap, L]; the pair store: f32 [P, L]
  // K5 (kp > 0) and the pair store (slot_pairs set)
  const int32_t* block_ids;   // [k, L], -1 masks a row
  const float* block_scales;  // [k, L]
  const int32_t* slot_pairs;  // the pair store: [S, cap], the out row of each place, -1 empty
  int kp, k_out;              // K' = min(k_out, L) kept of each query row; k_out columns written
  float* out_v;               // f32 [S, cap, k_out]
  int32_t* out_i;             // int32 [S, cap, k_out]
  // the plan (plan_slots)
  int LT;          // block rows a tile: L, or a multiple of kUnit
  int dp;          // lanes between two converted rows: pad16(d) + 8
  int nbuf;        // stages (1 or 2)
  int blk_area;    // bytes of a stage that take the block tile's span
  int qry_area;    // bytes of a stage that take the query tile's span
  int col_area;    // K5, pair store: bytes of a stage for each of the tile's ids and scales; 0 for K3/K4
  int sp;          // K5: floats between two rows of the score tile (8 mod 32); 0 for K3/K4
  int bc_area;     // bytes from the converted block tile to the converted query tile
  int stage_bytes; // blk_area + qry_area + 2 col_area
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

// Whether a stage also carries the row tile's ids and scales (K5 and the
// pair store).
__host__ __device__ __forceinline__ bool has_cols(const SlotArgs& a) { return a.kp > 0 || a.slot_pairs != nullptr; }

// One thread: start the copies of item `m` into `stage` (the block row tile,
// with the first row tile its query tile, and for K5 and the pair store the
// tile's ids and scales) and arm `bar` with their bytes.  The plain tail
// loads come first, so the stage is whole once the bulk bytes have landed.
template <typename T>
__device__ void issue_item(const SlotArgs& a, const Item& m, long long key, unsigned char* stage, uint64_t* bar) {
  constexpr long long es = sizeof(T);
  const int row0 = m.lt * a.LT;
  const int rows = min(a.LT, a.L - row0);
  const Span blk = span_of(a.blocks, a.k_blocks * a.L * a.d * es, (key * a.L + row0) * a.d * es,
                           static_cast<long long>(rows) * a.d * es);
  Span q = {nullptr, 0u, nullptr, nullptr}, ids = q, scl = q;
  if (m.lt == 0) {
    const int c0 = m.qt * kQT;
    const int nqr = min(kQT, a.cap - c0);
    q = span_of(a.qg, static_cast<long long>(a.S) * a.cap * a.d * 2, (static_cast<long long>(m.s) * a.cap + c0) * a.d * 2,
                static_cast<long long>(nqr) * a.d * 2);
  }
  if (has_cols(a)) {
    const long long total = a.k_blocks * a.L * 4, start = (key * a.L + row0) * 4;
    ids = span_of(reinterpret_cast<const unsigned char*>(a.block_ids), total, start, rows * 4LL);
    scl = span_of(reinterpret_cast<const unsigned char*>(a.block_scales), total, start, rows * 4LL);
  }
  unsigned char* qst = stage + a.blk_area;
  unsigned char* ist = qst + a.qry_area;
  unsigned char* sst = ist + a.col_area;
  load_tail(stage, blk);
  load_tail(qst, q);
  load_tail(ist, ids);
  load_tail(sst, scl);
  mbar_arrive_expect_tx(bar, blk.bulk + q.bulk + ids.bulk + scl.bulk);
  if (blk.bulk) bulk_copy(stage, blk.from, blk.bulk, bar);
  if (q.bulk) bulk_copy(qst, q.from, q.bulk, bar);
  if (ids.bulk) bulk_copy(ist, ids.from, ids.bulk, bar);
  if (scl.bulk) bulk_copy(sst, scl.from, scl.bulk, bar);
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

constexpr int kNT = kUnit / 8;  // n8 tiles a unit, two an ldmatrix

// One warp: the scores of `nqr` converted queries at A against the kUnit
// converted block rows from n0 at B (`rows` live), into acc: two m16 tiles
// of queries by kNT n8 tiles of rows, k steps of 16 in order.  Rows and
// queries past the live ones read the last live one and are not stored.
// Without `upper` the second m16 tile (queries 16-31) is not scored: its
// accumulators stay 0 and must not be stored.
__device__ __forceinline__ void mma_unit(const uint16_t* A, int nqr, const uint16_t* B, int n0, int rows, int d, int dp,
                                         float (&acc)[2][kNT][4], bool upper = true) {
  const int lane = threadIdx.x % kWarp;
  const int kend = (d + 15) / 16 * 16;
  // ldmatrix addressing: A matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
  // B matrices (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): b0, b1 of two n8 tiles
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const uint16_t* pa[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) pa[t] = A + min(16 * t + arow, nqr - 1) * dp + acol;
  const uint16_t* pb[kNT / 2];
#pragma unroll
  for (int t = 0; t < kNT / 2; ++t) pb[t] = B + min(n0 + 16 * t + brow, rows - 1) * dp + bcol;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int k = 0; k < kend; k += 16) {
    uint32_t af[2][4], bf[kNT / 2][4];
    ldmatrix_x4(af[0], pa[0] + k);
    if (upper) ldmatrix_x4(af[1], pa[1] + k);
#pragma unroll
    for (int t = 0; t < kNT / 2; ++t) ldmatrix_x4(bf[t], pb[t] + k);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt == 1 && !upper) break;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
}

// One warp (K3/K4): a unit's scores into out[q, l] = out + q * L + l; a
// quad of lanes writes 32 contiguous bytes of a score row (float2 each when
// every score row starts on an 8-byte boundary: `pairs`).
__device__ __forceinline__ void store_unit(const float (&acc)[2][kNT][4], int nqr, int n0, int rows, float* out, int L,
                                           bool pairs) {
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * mt + 8 * h + g;
      if (q >= nqr) continue;
      float* orow = out + static_cast<long long>(q) * L;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
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

// One warp (K5): a unit's accumulators times the row's scale, -inf where the
// row's id is negative, into the shared score tile (rows sp floats apart,
// sp = 8 mod 32, so the float2 stores of a half warp meet 32 different
// banks).  A lane's eight columns' scales and masks are read once.
__device__ __forceinline__ void store_topk_unit(const float (&acc)[2][kNT][4], int nqr, int n0, int rows, float* sc,
                                                int sp, const float* scales, const int32_t* ids) {
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2, c = lane & 3;
  float scl[kNT][2];
  bool live[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = n0 + 8 * nt + 2 * c + e;
      live[nt][e] = l < rows && ids[l] >= 0;
      scl[nt][e] = l < rows ? scales[l] : 0.f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * mt + 8 * h + g;
      if (q >= nqr) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int l = n0 + 8 * nt + 2 * c;
        const float v0 = live[nt][0] ? acc[mt][nt][2 * h] * scl[nt][0] : neg_inf();
        const float v1 = live[nt][1] ? acc[mt][nt][2 * h + 1] * scl[nt][1] : neg_inf();
        if (l + 1 < rows) {
          *reinterpret_cast<float2*>(sc + q * sp + l) = make_float2(v0, v1);
        } else if (l < rows) {
          sc[q * sp + l] = v0;
        }
      }
    }
  }
}

// One warp (the pair store): a unit's accumulators times the row's scale,
// -inf where the row's id is negative, into out[pair[i] * L + row0 + l] for
// each of the lane's four query rows i (16 mt + 8 h + g) whose place holds
// a pair; a quad of lanes writes 32 contiguous bytes of a row, as
// store_unit does.  __fmul_rn keeps the multiply a multiply (no FMA).
__device__ __forceinline__ void store_pairs_unit(const float (&acc)[2][kNT][4], const int (&pair)[4], int n0,
                                                 int rows, float* out, int L, int row0, bool pairs,
                                                 const float* scales, const int32_t* ids) {
  const int lane = threadIdx.x % kWarp;
  const int c = lane & 3;
  float scl[kNT][2];
  bool live[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = n0 + 8 * nt + 2 * c + e;
      live[nt][e] = l < rows && ids[l] >= 0;
      scl[nt][e] = l < rows ? scales[l] : 0.f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pair[2 * mt + h];
      if (p < 0) continue;
      float* orow = out + static_cast<long long>(p) * L + row0;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int l = n0 + 8 * nt + 2 * c;
        const float v0 = live[nt][0] ? __fmul_rn(acc[mt][nt][2 * h], scl[nt][0]) : neg_inf();
        const float v1 = live[nt][1] ? __fmul_rn(acc[mt][nt][2 * h + 1], scl[nt][1]) : neg_inf();
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

// All warps (K3/K4): the scores of `nqr` converted queries at A against
// `rows` converted block rows at B into out (rows L floats apart), each warp
// kUnit rows at a time against all kQT queries.
__device__ __forceinline__ void score_tile(const uint16_t* A, int nqr, const uint16_t* B, int rows, int d, int dp,
                                           float* out, int L, bool pairs) {
  const int warp = threadIdx.x / kWarp;
  for (int n0 = warp * kUnit; n0 < rows; n0 += kSlotWarps * kUnit) {
    float acc[2][kNT][4];
    mma_unit(A, nqr, B, n0, rows, d, dp, acc);
    store_unit(acc, nqr, n0, rows, out, L, pairs);
  }
}

// One warp: sort each row's (v[r], c[r]) across the lanes best first (the
// larger value, and among equal values the lower c), the rows' bitonic
// networks of 15 exchanges interleaved.
__device__ __forceinline__ void warp_sort(float (&v)[kRowsPerWarp], int32_t (&c)[kRowsPerWarp]) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int k = 2; k <= kWarp; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ov = __shfl_xor_sync(kAll, v[r], j);
        const int32_t oc = __shfl_xor_sync(kAll, c[r], j);
        // no short circuit: a branch here costs a reconvergence barrier per exchange
        const bool take = ((ov > v[r]) | ((ov == v[r]) & (oc < c[r]))) == keep_better;
        v[r] = take ? ov : v[r];
        c[r] = take ? oc : c[r];
      }
    }
  }
}

// One warp, each row's kp-th largest of v[r] across the lanes (a values-only
// bitonic network, the rows interleaved).
__device__ __forceinline__ void warp_kth(float (&v)[kRowsPerWarp], int kp) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int k = 2; k <= kWarp; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ov = __shfl_xor_sync(kAll, v[r], j);
        v[r] = keep_better ? fmaxf(v[r], ov) : fminf(v[r], ov);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) v[r] = __shfl_sync(kAll, v[r], kp - 1);
}

// One warp, K' <= kRegK: merge a row tile's scores of the warp's query rows
// q0 + 8 r (sc rows sp floats apart, [0, rows) live, columns row0 + l) into
// each row's running top-K', entry `lane` in (lv[r], lc[r]) (value,
// column), sorted best first; rows from nqr on hold no scores.  A row's
// candidates are its scores above the list's K'-th; for an empty list
// (`fresh`), those at or above the K'-th largest of the lanes' maxima, a
// bound that K' scores of the tile reach.  They are packed, in column
// order, into the row's own storage (read into registers first), kWarp - K'
// at a time beside the list, and each batch is sorted with the list.  The
// rows' steps interleave.
__device__ __forceinline__ void merge_rows(float* sc, int sp, int q0, int nqr, int row0, int rows, int kp, bool fresh,
                                           float (&lv)[kRowsPerWarp], int32_t (&lc)[kRowsPerWarp]) {
  const int lane = threadIdx.x % kWarp;
  float v[kRowsPerWarp][kMaxJ], t[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float* srow = sc + (q0 + kSlotWarps * r) * sp;
    const bool live = q0 + kSlotWarps * r < nqr;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) v[r][j] = live && kWarp * j + lane < rows ? srow[kWarp * j + lane] : neg_inf();
  }
  if (fresh) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      t[r] = v[r][0];
#pragma unroll
      for (int j = 1; j < kMaxJ; ++j) t[r] = fmaxf(t[r], v[r][j]);
      lv[r] = neg_inf();
      lc[r] = 0x7fffffff;
    }
    warp_kth(t, kp);
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) t[r] = __shfl_sync(kAll, lv[r], kp - 1);
  }
  unsigned bits[kRowsPerWarp][kMaxJ];
  int total[kRowsPerWarp], most = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    total[r] = 0;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      bits[r][j] = __ballot_sync(kAll, v[r][j] > neg_inf() && (fresh ? v[r][j] >= t[r] : v[r][j] > t[r]));
      total[r] += __popc(bits[r][j]);
    }
    most = max(most, total[r]);
  }
  if (most == 0) return;
  const int room = kWarp - kp;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < most; base += room) {
    __syncwarp();  // the rows' storage is read (scores, or the last batch): it takes this batch
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float* srow = sc + (q0 + kSlotWarps * r) * sp;
      int32_t* scol = reinterpret_cast<int32_t*>(srow + kWarp);
      int before = 0;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int at = before + __popc(bits[r][j] & below) - base;
        if (((bits[r][j] >> lane) & 1u) && at >= 0 && at < room) {
          srow[at] = v[r][j];
          scol[at] = row0 + kWarp * j + lane;
        }
        before += __popc(bits[r][j]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* srow = sc + (q0 + kSlotWarps * r) * sp;
      if (lane >= kp) {
        const bool has = lane - kp < total[r] - base;
        lv[r] = has ? srow[lane - kp] : neg_inf();
        lc[r] = has ? reinterpret_cast<const int32_t*>(srow + kWarp)[lane - kp] : 0x7fffffff;
      }
    }
    warp_sort(lv, lc);
  }
}

// One warp, K' > kRegK: merge a tile's scores of one query row (srow[0,
// rows), ids[0, rows)) into the row's running top-K', kept in the row's own
// output (gv, gi)[0, kp) sorted best first.  The tile's columns follow the
// list's and enter in column order, each after every entry of equal value,
// at the position a ballot of `list >= score` gives; the entries below it
// move down a chunk of 32 at a time.  The slower path, for large k_out.
__device__ __noinline__ void merge_global(const float* srow, const int32_t* ids, int rows, int kp,
                                          volatile float* gv, volatile int32_t* gi) {
  const int lane = threadIdx.x % kWarp;
  float thr = gv[kp - 1];
  for (int c = 0; c < rows; c += kWarp) {
    const float cv = c + lane < rows ? srow[c + lane] : neg_inf();
    unsigned m = __ballot_sync(kAll, cv > thr);
    while (m) {
      const int src = __ffs(m) - 1;
      const float v = __shfl_sync(kAll, cv, src);
      const int32_t id = ids[c + src];
      int p = 0;
      for (int j = 0; j < kp; j += kWarp) {
        const unsigned b = __ballot_sync(kAll, j + lane < kp && gv[j + lane] >= v);
        p += __popc(b);
        if (b != kAll) break;  // the rest lie below v
      }
      for (int j = (kp - 1) / kWarp * kWarp; j >= p / kWarp * kWarp; j -= kWarp) {  // the last chunk first
        const int e = j + lane;
        const bool move = e > p && e < kp;
        float x = 0.f;
        int32_t xi = 0;
        if (move) {
          x = gv[e - 1];
          xi = gi[e - 1];
        }
        __syncwarp();
        if (move) {
          gv[e] = x;
          gi[e] = xi;
        } else if (e == p) {
          gv[e] = v;
          gi[e] = id;
        }
        __syncwarp();
      }
      thr = gv[kp - 1];
      m &= __ballot_sync(kAll, cv > thr) & ~(1u << src);
    }
  }
}

// K3/K4 (kOut = kScores), the pair store (kPairs) and K5 (kTopkRegs,
// kTopkGlobal): one body.
template <typename T, bool kVec, int kOut>
__global__ void __launch_bounds__(kSlotThreads) slot_score_kernel(const __grid_constant__ SlotArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + kBarBytes;
  const int q_rows = min(a.cap, kQT);
  uint16_t* Bc = reinterpret_cast<uint16_t*>(stages + a.nbuf * a.stage_bytes);  // [LT, dp]
  float* sc = reinterpret_cast<float*>(Bc);  // K5: [q_rows, sp], over Bc once the tile is scored
  uint16_t* Ac = reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(Bc) + a.bc_area);  // [q_rows, dp]
  float* colS = reinterpret_cast<float*>(Ac + q_rows * a.dp);  // K5, pair store: [LT] scales
  int32_t* colI = reinterpret_cast<int32_t*>(colS + a.LT);     // K5, pair store: [LT] ids

  const int s0 = blockIdx.x * a.G;
  const int nq = (a.cap + kQT - 1) / kQT;
  const int nl = (a.L + a.LT - 1) / a.LT;
  int items = min(a.G, a.S - s0) * nq * nl;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bool issuer = threadIdx.x == 0;
  if constexpr (kOut == kPairs) {  // the items after the last query tile that holds a pair store nothing: skip them
    int* live_end = reinterpret_cast<int*>(smem + kBarBytes / 2);  // past the mbarriers
    if (issuer) *live_end = 0;
    __syncthreads();
    int last = 0;  // nondecreasing in i: one atomic a thread
    for (int i = threadIdx.x; i < min(a.G, a.S - s0) * a.cap; i += kSlotThreads) {
      const int p = a.slot_pairs[static_cast<long long>(s0) * a.cap + i];
      if (p >= 0) last = i / a.cap * nq + i % a.cap / kQT + 1;
    }
    if (last) atomicMax(live_end, last);
    __syncthreads();
    items = *live_end * nl;
  }
  float lv[kRowsPerWarp];  // kTopkRegs: entry `lane` of the top-K' of query rows warp + 8 r (value, column)
  int32_t lc[kRowsPerWarp];
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
    if constexpr (kOut != kScores) {  // the tile's ids and scales out of the stage
      const long long col = (key * a.L + row0) * 4;
      const unsigned char* ist = stage + a.blk_area + a.qry_area;
      const int32_t* ids = reinterpret_cast<const int32_t*>(ist + ((reinterpret_cast<uintptr_t>(a.block_ids) + col) & 15));
      const float* scl =
          reinterpret_cast<const float*>(ist + a.col_area + ((reinterpret_cast<uintptr_t>(a.block_scales) + col) & 15));
      for (int r = threadIdx.x; r < rows; r += kSlotThreads) {
        colI[r] = ids[r];
        colS[r] = scl[r];
      }
    }
    __syncthreads();  // the converted tiles are in place; the stage is free
    if (issuer && nxt < items) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stage's reads before its async refill
      issue_item<T>(a, mn, next_key, stage, &bars[b]);
    }
    if constexpr (kOut == kScores) {
      score_tile(Ac, nqr, Bc, rows, a.d, a.dp, a.out + (static_cast<long long>(m.s) * a.cap + c0) * a.L + row0, a.L,
                 a.L % 2 == 0 && a.LT % 2 == 0);
    } else if constexpr (kOut == kPairs) {
      const int g = lane >> 2;
      int pair[4];  // the pairs of the lane's query rows 16 mt + 8 h + g, -1 where none
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 16 * (i / 2) + 8 * (i % 2) + g;
        pair[i] = q < nqr ? a.slot_pairs[static_cast<long long>(m.s) * a.cap + c0 + q] : -1;
      }
      const bool upper = __any_sync(kAll, pair[2] >= 0 || pair[3] >= 0);  // a pair among queries 16-31
      for (int n0 = warp * kUnit; n0 < rows; n0 += kSlotWarps * kUnit) {
        float acc[2][kNT][4];
        mma_unit(Ac, nqr, Bc, n0, rows, a.d, a.dp, acc, upper);
        store_pairs_unit(acc, pair, n0, rows, a.out, a.L, row0, a.L % 2 == 0 && a.LT % 2 == 0, colS, colI);
      }
    } else {
      float acc[2][kNT][4];  // rows <= kMaxLT: a warp scores at most one unit
      const int n0 = warp * kUnit;
      if (n0 < rows) mma_unit(Ac, nqr, Bc, n0, rows, a.d, a.dp, acc);
      __syncthreads();  // Bc is read: the score tile takes its place
      if (n0 < rows) store_topk_unit(acc, nqr, n0, rows, sc, a.sp, colS, colI);
      __syncthreads();  // the tile's scaled, masked scores are in `sc`
      if constexpr (kOut == kTopkRegs) {
        merge_rows(sc, a.sp, warp, nqr, row0, rows, a.kp, m.lt == 0, lv, lc);
        if (m.lt == nl - 1) {  // the ids of every row's list first, then the stores
          int32_t id[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            id[r] = lane < a.kp && lv[r] > neg_inf() ? a.block_ids[key * a.L + lc[r]] : -1;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const int q = warp + kSlotWarps * r;
            if (q >= nqr) break;
            const long long o = (static_cast<long long>(m.s) * a.cap + c0 + q) * a.k_out;
            for (int e = lane; e < a.k_out; e += kWarp) {  // every column, (-inf, -1) past K'
              a.out_v[o + e] = e < a.kp ? lv[r] : neg_inf();
              a.out_i[o + e] = e < a.kp ? id[r] : -1;
            }
          }
        }
      } else {
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int q = warp + kSlotWarps * r;
          if (q >= nqr) break;
          const long long o = (static_cast<long long>(m.s) * a.cap + c0 + q) * a.k_out;
          if (m.lt == 0) {
            for (int e = lane; e < a.k_out; e += kWarp) {
              a.out_v[o + e] = neg_inf();
              a.out_i[o + e] = -1;
            }
            __syncwarp();
          }
          merge_global(sc + q * a.sp, colI, rows, a.kp, a.out_v + o, a.out_i + o);
        }
      }
    }
    __syncthreads();  // the converted tiles (and K5's score tile) are free again
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

// Every instance of one output kind allowed `bytes` of shared memory.
template <int kOut>
cudaError_t allow_kind(int bytes) {
  cudaError_t err = allow_smem(slot_score_kernel<uint16_t, true, kOut>, bytes);
  if (!err) err = allow_smem(slot_score_kernel<uint16_t, false, kOut>, bytes);
  if (!err) err = allow_smem(slot_score_kernel<float, true, kOut>, bytes);
  if (!err) err = allow_smem(slot_score_kernel<float, false, kOut>, bytes);
  if (!err) err = allow_smem(slot_score_kernel<int8_t, true, kOut>, bytes);
  if (!err) err = allow_smem(slot_score_kernel<int8_t, false, kOut>, bytes);
  return err;
}

// The device's limits, and every kernel instance allowed all of a block's
// shared memory (the current device must be `device`).
DeviceLimits read_limits(int device) {
  DeviceLimits l;
  cudaError_t err = cudaDeviceGetAttribute(&l.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (!err) err = cudaDeviceGetAttribute(&l.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (!err) err = allow_kind<kScores>(l.smem_block);
  if (!err) err = allow_kind<kTopkRegs>(l.smem_block);
  if (!err) err = allow_kind<kTopkGlobal>(l.smem_block);
  if (!err) err = allow_kind<kPairs>(l.smem_block);
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

// Bytes of a stage's column span (the ids or scales), floats between two
// rows of K5's score tile (8 mod 32, and room for a row's 32 candidates
// and their columns), and bytes of the converted block tile or, for K5, the
// score tile over it, at row tile LT.
long long col_area(const SlotArgs& a, int LT) { return has_cols(a) ? pad_to(LT * 4LL + kSpanSlack, 16) : 0; }
int score_pitch(const SlotArgs& a, int LT) {
  return a.kp > 0 ? static_cast<int>((LT > 2 * kWarp ? pad_to(LT, kWarp) : 2 * kWarp) + 8) : 0;
}
long long bc_area(const SlotArgs& a, int LT) {
  const long long q_rows = a.cap < kQT ? a.cap : kQT;
  const long long bc = static_cast<long long>(LT) * a.dp * 2, sc = q_rows * score_pitch(a, LT) * 4;
  return pad_to(bc > sc ? bc : sc, 16);
}

// Shared memory of a block at row tile LT: the barriers, the stages, the
// converted tiles (for K5 the score tile over the block's), and for K5 and
// the pair store the tile's scales and ids.
long long slot_smem(const SlotArgs& a, int esize, int LT, int nbuf) {
  const long long q_rows = a.cap < kQT ? a.cap : kQT;
  const long long blk = pad_to(static_cast<long long>(LT) * a.d * esize + kSpanSlack, 16);
  const long long qry = pad_to(q_rows * a.d * 2 + kSpanSlack, 16);
  return kBarBytes + nbuf * (blk + qry + 2 * col_area(a, LT)) + bc_area(a, LT) + q_rows * a.dp * 2 +
         (has_cols(a) ? LT * 8LL : 0);
}

// The row tile, stages and shared memory of a call, into `a`.  The tile is
// the largest (L, or a multiple of kUnit rows; for K5 at most kMaxLT) with
// which kBlocksPerSm blocks share an SM, else with which one block fits; it
// does not depend on G, S or k_out, so neither does any output's summation
// order.
cudaError_t plan_slots(const DeviceLimits& lim, int esize, SlotArgs* a, int* smem) {
  a->dp = static_cast<int>(pad_to(a->d, 16)) + 8;
  const long long shared = lim.smem_sm / kBlocksPerSm - 1024;  // 1 KB a block for the runtime
  const int lmax = a->kp > 0 && a->L > kMaxLT ? kMaxLT : a->L;  // K5: a warp scores at most one unit
  int LT = 0;
  for (const long long budget : {shared < lim.smem_block ? shared : static_cast<long long>(lim.smem_block),
                                 static_cast<long long>(lim.smem_block)}) {
    if (slot_smem(*a, esize, lmax, kStages) <= budget) {
      LT = lmax;
      break;
    }
    int lt = lmax / kUnit * kUnit;
    while (lt > kUnit && slot_smem(*a, esize, lt, kStages) > budget) lt -= kUnit;
    if (lt >= kUnit && slot_smem(*a, esize, lt, kStages) <= budget) {
      LT = lt;
      break;
    }
    lt = lmax < kUnit ? lmax : kUnit;  // very long rows: fewer rows a tile
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
  a->qry_area = static_cast<int>(pad_to((a->cap < kQT ? a->cap : kQT) * 2LL * a->d + kSpanSlack, 16));
  a->col_area = static_cast<int>(col_area(*a, LT));
  a->sp = score_pitch(*a, LT);
  a->bc_area = static_cast<int>(bc_area(*a, LT));
  a->stage_bytes = a->blk_area + a->qry_area + 2 * a->col_area;
  *smem = static_cast<int>(slot_smem(*a, esize, LT, a->nbuf));
  return cudaSuccess;
}

template <int kOut>
cudaError_t launch_kind(const SlotArgs& a, int dtype, bool vec, unsigned grid, int smem, cudaStream_t stream) {
  switch (dtype * 2 + (vec ? 1 : 0)) {
    case 0: slot_score_kernel<uint16_t, false, kOut><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 1: slot_score_kernel<uint16_t, true, kOut><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 2: slot_score_kernel<float, false, kOut><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 3: slot_score_kernel<float, true, kOut><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 4: slot_score_kernel<int8_t, false, kOut><<<grid, kSlotThreads, smem, stream>>>(a); break;
    case 5: slot_score_kernel<int8_t, true, kOut><<<grid, kSlotThreads, smem, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  if (a.slot_pairs) return static_cast<int>(launch_kind<kPairs>(a, dtype, vec, grid, smem, stream));
  if (a.kp == 0) return static_cast<int>(launch_kind<kScores>(a, dtype, vec, grid, smem, stream));
  if (a.kp <= kRegK) return static_cast<int>(launch_kind<kTopkRegs>(a, dtype, vec, grid, smem, stream));
  return static_cast<int>(launch_kind<kTopkGlobal>(a, dtype, vec, grid, smem, stream));
}

SlotArgs slot_args(const void* blocks, long long k_blocks, int L, int d, const void* slot_keys, int S, const void* qg,
                   int cap, int group) {
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
  return a;
}

}  // namespace

// Block dtype codes: 0 = bf16, 1 = f32, 2 = int8.  Every function launches on
// `stream` (the caller's current CUDA stream) and return cudaGetLastError()
// as an int: 0 when the launch was accepted.  `blocks`, `qg`, `block_ids`
// and `block_scales` start on 16-byte boundaries.

extern "C" int gt_ivf_score_slots(const void* blocks, int dtype, long long k_blocks, int L, int d,
                                  const void* slot_keys, int S, const void* qg, int cap, int group,
                                  void* out, int device, void* stream) {
  SlotArgs a = slot_args(blocks, k_blocks, L, d, slot_keys, S, qg, cap, group);
  a.out = static_cast<float*>(out);
  return launch_slots(a, dtype, device, static_cast<cudaStream_t>(stream));
}

// The pair store: K4's scores (K3's with group 1) times block_scales, -inf
// where block_ids < 0, of each place (s, c) with slot_pairs[s, c] >= 0 into
// row slot_pairs[s, c] of out (f32 [P, L]; every such value below P); an
// empty place (-1) writes nothing and every other row is left as it is.  A
// pair held by two places is written by both.  `out` starts on an 8-byte
// boundary.
extern "C" int gt_ivf_score_pairs(const void* blocks, int dtype, long long k_blocks, int L, int d,
                                  const void* block_ids, const void* block_scales,
                                  const void* slot_keys, int S, const void* qg, int cap, int group,
                                  const void* slot_pairs, void* out, int device, void* stream) {
  SlotArgs a = slot_args(blocks, k_blocks, L, d, slot_keys, S, qg, cap, group);
  a.block_ids = static_cast<const int32_t*>(block_ids);
  a.block_scales = static_cast<const float*>(block_scales);
  a.slot_pairs = static_cast<const int32_t*>(slot_pairs);
  a.out = static_cast<float*>(out);
  return launch_slots(a, dtype, device, static_cast<cudaStream_t>(stream));
}

// K5: writes every one of the k_out columns of out_v / out_i, so they need
// no fill; kp = min(k_out, L).
extern "C" int gt_ivf_score_topk(const void* blocks, int dtype, long long k_blocks, int L, int d,
                                 const void* block_ids, const void* block_scales,
                                 const void* slot_keys, int S, const void* qg, int cap, int group,
                                 int kp, int k_out, void* out_v, void* out_i, int device,
                                 void* stream) {
  if (kp < 1 || kp > L || k_out < kp) return static_cast<int>(cudaErrorInvalidValue);
  SlotArgs a = slot_args(blocks, k_blocks, L, d, slot_keys, S, qg, cap, group);
  a.block_ids = static_cast<const int32_t*>(block_ids);
  a.block_scales = static_cast<const float*>(block_scales);
  a.kp = kp;
  a.k_out = k_out;
  a.out_v = static_cast<float*>(out_v);
  a.out_i = static_cast<int32_t*>(out_i);
  return launch_slots(a, dtype, device, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gt_ivf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
