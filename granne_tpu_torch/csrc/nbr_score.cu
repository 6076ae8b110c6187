// The two neighbor-cache scorers of ops/nbr_cache.py: K1 over the flat
// layout, K2 over the tiled layout.  One kernel body serves both.
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
// K2: fused tiled neighbor-cache gather + candidate scoring.
//
// Replaces the Pallas TPU kernel
// granne_tpu/ops/pallas/nbr_score.py::gather_score (_kernel).
//
//   tab      bf16[n, Mp, 128]  Mp = pad8(M) vectors of 128 lanes, zero past d
//   sel_ids  int32[B, E]       clipped as in K1
//   q        bf16[B, d]        d <= 128, the plain query (the JAX wrapper pads
//                              it to 128 zero lanes: only zero products)
//   dots     f32[B, E*M]
//
// Only the first M of the Mp vectors and the first d of the 128 lanes enter
// a dot (the 8-vector pad is the TPU's DMA granule).
//
// ---------------------------------------------------------------------------
// What bounds them on the H100.  One random row per (query, node) pair:
// K1 4,080 B of data lanes at M 20, d 100, K2 M vectors of which the first
// d lanes (200 of 256 B) carry data.  About 0.5 FLOP a byte against the
// card's ridge of ~295, so bytes and the latency of a random row, never
// FLOPs: the serve shape (B 1,024, E 1) moves 4.2 MB, 1.3 us at 3.35 TB/s,
// the build beam's (E 4) 16.7 MB, 5 us.  On the card (PERF.md) the launch,
// the ids' load and the rows' copies take most of the time, and the
// scoring adds the latency of the last rows' mma chains.  K2 at E 4 takes
// no less than the previous design, which read the same rows with plain
// loads: most likely both are held by DRAM, which reads each 256-byte
// vector whole (5,120 B a row) whatever part of it is asked for.
//
// The design:
//
// * Row staging by TMA.  Each warp scores its rows one after another from
//   a ring of `stages` slots in shared memory, one mbarrier a slot.  Lane 0
//   arms the slot's barrier with the byte count and issues the copies that
//   complete on it: the row (K1: one `cp.async.bulk` of row_lanes(M, d) * 2
//   B, 4,080 B at M 20, d 100, no byte beyond the data but the id lanes'
//   16-byte round-up; K2: one `cp.async.bulk.tensor` box of M vectors x
//   pad8(d) lanes through a tensor map of the table, 4,160 B at d 100, the
//   first d lanes of each vector and the 0-7 pad lanes that round them to
//   16 bytes, 160 B beyond the data), and the query's d lanes as the
//   16-byte granules that hold them (at most 15 bytes either side of the
//   query row, inside its allocation's granule).  A copy spends no
//   registers and one instruction.
// * Rows in flight.  A block is 4 warps, 8 blocks an SM.  When the SMs
//   hold a warp for every row (the serve shape's 1,024 rows, the build
//   beam's 4,096), each warp stages one row and every row is in flight at
//   once, in one wave: ~34 KB per SM at E 1, ~135 KB at E 4.  Larger grids give each warp a ring of 2 slots
//   and rows w, w + W, ... (W warps in all), the copy of its next row in
//   flight while this one is scored.  (Fewer warps with deeper rings, so
//   that rows land spread out, lost on the card: the copies slowed and each
//   warp's scoring lay on the path.)
// * No serial chain of reductions: the scoring is a matrix product on the
//   tensor cores.  The staged vectors are A (16 a tile, two tiles a pass,
//   m16n8k16 bf16 mma.sync with f32 accumulation) and the query is B (the
//   same in all 8 columns); even and odd k steps go to two accumulators.
//   K2's vectors start on 16-byte boundaries, so a tile's A operand is one
//   ldmatrix (8 rows 208 B apart: no bank conflict at d 100); K1's start 8
//   bytes apart mod 16, so each lane takes its k slots as 4 consecutive
//   lanes, one 8-byte load a row, and reads the query in the same order.
//   Lanes past d enter as zeros (the last step is masked) and rows past M
//   read vector 0 and are dropped: K1's id lanes, bf16 NaNs, are never
//   multiplied.  The tensor cores buy no FLOPs here; they cut the scoring's
//   instructions and the length of its dependent chain, which is what the
//   last rows to land wait on.  An odd d, a K1 row whose vectors are not
//   8-byte aligned (d % 4 == 2) or a query off a 4-byte boundary is scored
//   lane by lane instead (lane m takes vector m).
// * A lean, capture-safe launch.  The device's SM count and shared-memory
//   limits are read, and every instance's dynamic shared-memory limit set,
//   once per device at its first launch; cudaSetDevice is called only when
//   the current device differs; K2's tensor map is encoded on the host
//   (through the driver's entry point) at each call and passed by value.  The launch goes to the caller's stream and allocates
//   nothing, so a launch inside a CUDA graph capture is captured.
//
// -Xptxas -v (sm_90a, CUDA 12.8, on the H100): K1 on the tensor cores 64
// registers, K1 lane by lane 48, K2 on the tensor cores 64, K2 lane by
// lane 43 (the cap of 64 lets 8 blocks, 32 warps, share an SM); no spills,
// no stack frame.  Shared memory is all dynamic: 128 B of mbarriers, then
// for each warp and slot the row rounded up to 128 B plus 256 B of query
// granules (M 20, d 100: K1 4,352 B, K2 4,480 B a slot, 17.5-18 KB a block
// of 4 warps with one slot each).

#include <cstdint>
#include <mutex>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;    // warps per block
constexpr int kBlocksPerSm = 8; // the registers are capped so that 8 blocks (32 warps) fit on an SM
constexpr int kMaxStages = 2;   // ring slots per warp
constexpr int kBarBytes = 128;  // the mbarriers, ahead of the slots (which a tensor copy wants 128-byte aligned)
static_assert(kMaxWarps * kMaxStages * 8 <= kBarBytes, "one mbarrier a slot");
constexpr int kTileLanes = 128; // one tiled-layout vector: 128 bf16 lanes
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int pad(int bytes, int to) { return (bytes + to - 1) / to * to; }

// int16 lanes of a flat row that carry data (vectors + ids), rounded up to
// whole 16-byte chunks: what K1 stages of a row.
__host__ __device__ constexpr int row_lanes(int M, int d) { return (M * d + 2 * M + 7) / 8 * 8; }

// Shared-memory bytes that hold a staged query: the 16-byte granules of
// d bf16 lanes that start anywhere on a 2-byte boundary.
__host__ __device__ constexpr int query_granule_bytes(int d) { return pad(2 * d, 16) + 16; }

struct alignas(64) Params {
  CUtensorMap map;       // K2: the table as bf16[n * Mp, 128], a box of M x pad8(d) lanes
  const unsigned char* tab;
  long long n_rows;
  long long row_pitch;   // bytes between table rows
  int tiles;             // K2: vectors a table row (row id starts at tile id * tiles of `map`); K1: 0
  const int32_t* sel_ids;
  int pairs;             // B * E rows to score
  int expand;            // E
  const unsigned char* q;
  int M, d;
  int row_bytes;         // bytes a staged row arrives as
  int vec_stride;        // shared bytes between two staged vectors
  int row_area;          // shared bytes of a staged row (a multiple of 128)
  int slot_bytes;        // row_area + the query's granules (a multiple of 128)
  int stages;            // slots per warp
  float* dots;
  int32_t* nbrs;         // K1 only
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

// global -> shared copy of the box of `map` at (x, y) (destination 128-byte
// aligned), completing on `bar`.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// The query row of scored row `row`, as a byte address in global memory.
__device__ __forceinline__ uintptr_t query_addr(const Params& p, int row) {
  return reinterpret_cast<uintptr_t>(p.q) + static_cast<uintptr_t>(row / p.expand) * 2 * p.d;
}

// Lane 0 arms `bar` with the byte count and starts the copies of row `row`
// (table row `id`, clipped) and of its query into `slot`.
__device__ __forceinline__ void stage_row(const Params& p, unsigned char* slot, uint64_t* bar, int row,
                                          long long id, int lane) {
  id = id < 0 ? 0 : (id >= p.n_rows ? p.n_rows - 1 : id);
  const uintptr_t q0 = query_addr(p, row);
  const uintptr_t qa = q0 & ~uintptr_t{15};
  const uint32_t q_bytes = static_cast<uint32_t>(((q0 + 2 * p.d + 15) & ~uintptr_t{15}) - qa);
  if (lane == 0) {
    mbar_arrive_expect_tx(bar, p.row_bytes + q_bytes);
    if (p.tiles) {
      tensor_copy(slot, &p.map, 0, static_cast<int>(id * p.tiles), bar);
    } else {
      bulk_copy(slot, p.tab + id * p.row_pitch, p.row_bytes, bar);
    }
    bulk_copy(slot + p.row_area, reinterpret_cast<const void*>(qa), q_bytes, bar);
  }
}

// D += A x B on the tensor cores: A a 16 x 16 bf16 tile (rows g and g + 8,
// columns 2c, 2c + 1 and 2c + 8, 2c + 9 of lane 4g + c), B 16 x 8 bf16,
// D 16 x 8 f32 (rows g and g + 8, columns 2c and 2c + 1).
__device__ __forceinline__ void mma_bf16(float (&acc)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four 8 x 8 bf16 matrices whose rows lanes 8i..8i+7 address, one a
// register: with matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) of a tile they are its mma A operand.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(addr)));
}

// One k step of 16 lanes for both tiles of dot_tiles.  A sum over k takes
// its terms in any order, so A and B need only agree on which k each of the
// mma's k slots holds.  kLdmatrix: A is one ldmatrix a tile (at lm[t] + 2k),
// in the mma's own order (slots 2c, 2c + 1 and 2c + 8, 2c + 9 hold those k).
// Otherwise lane c's slots hold k + 4c .. k + 4c + 3, so each of its rows
// is one 8-byte load (at word rw[i]), and B is read in the same order.
// kMask zeroes A and B past d: K1's lanes there are the next vector's or
// its id lanes (bf16 NaNs), which must not enter a product.
template <bool kLdmatrix, bool kMask>
__device__ __forceinline__ void k_step(const uint32_t* v32, const uint32_t* q32, const unsigned char* const (&lm)[2],
                                       const int (&rw)[4], int k, int c, int d, float (&acc)[2][4]) {
  const int w0 = kLdmatrix ? k / 2 + c : k / 2 + 2 * c;  // query words of this lane's two k slot pairs
  const int w1 = kLdmatrix ? w0 + 4 : w0 + 1;
  const bool in0 = !kMask || 2 * w0 < d, in1 = !kMask || 2 * w1 < d;
  const uint32_t b0 = in0 ? q32[w0] : 0u, b1 = in1 ? q32[w1] : 0u;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    uint32_t a[4];
    if constexpr (kLdmatrix) {
      ldmatrix_x4(a, lm[t] + 2 * k);
    } else {
      const uint2 r0 = *reinterpret_cast<const uint2*>(v32 + rw[2 * t] + w0);
      const uint2 r1 = *reinterpret_cast<const uint2*>(v32 + rw[2 * t + 1] + w0);
      a[0] = r0.x, a[1] = r1.x, a[2] = r0.y, a[3] = r1.y;
    }
    if constexpr (kMask) {
      a[0] = in0 ? a[0] : 0u;
      a[1] = in0 ? a[1] : 0u;
      a[2] = in1 ? a[2] : 0u;
      a[3] = in1 ? a[3] : 0u;
    }
    mma_bf16(acc[t], a[0], a[1], a[2], a[3], b0, b1);
  }
}

// Dots of the staged vectors [m0, m0 + 32) with the staged query, 16 of
// them a tensor-core tile, both tiles in one pass over k (even d, every
// vector and the query on a 4-byte boundary; with kLdmatrix every vector on
// a 16-byte boundary, and each tile's A operand is one ldmatrix).  A lane's
// rows past M read vector 0 instead (finite, and their dots are dropped);
// lanes past d enter as zeros.
template <bool kLdmatrix>
__device__ __forceinline__ void dot_tiles(const Params& p, const unsigned char* slot, const unsigned char* qs, int m0,
                                          int lane, float (&acc)[2][4]) {
  const uint32_t* v32 = reinterpret_cast<const uint32_t*>(slot);
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs);
  const int words = p.vec_stride / 4;  // 32-bit words between two vectors
  const int g = lane >> 2, c = lane & 3;
  int rw[4];  // first word of each of this lane's rows of A (and D)
  const int rows[4] = {m0 + g, m0 + g + 8, m0 + 16 + g, m0 + 24 + g};
#pragma unroll
  for (int i = 0; i < 4; ++i) rw[i] = (rows[i] < p.M ? rows[i] : 0) * words;
  // the vector and k offset this lane addresses for ldmatrix, each tile
  const int lrow = ((lane >> 3) & 1) * 8 + (lane & 7), lcol = (lane >> 4) * 8;
  const unsigned char* lm[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int m = m0 + 16 * t + lrow;
    lm[t] = slot + (m < p.M ? m : 0) * p.vec_stride + 2 * lcol;
  }
  float odd[2][4] = {};  // odd k steps: two chains of dependent mma a tile, each half as long
  const int whole = p.d / 16 * 16;  // k steps with every lane inside d
  int k = 0;
#pragma unroll 4
  for (; k + 32 <= whole; k += 32) {  // the same steps in every lane: mma.sync is warp-wide
    k_step<kLdmatrix, false>(v32, q32, lm, rw, k, c, p.d, acc);
    k_step<kLdmatrix, false>(v32, q32, lm, rw, k + 16, c, p.d, odd);
  }
  if (k < whole) {
    k_step<kLdmatrix, false>(v32, q32, lm, rw, k, c, p.d, acc);
    k += 16;
  }
  if (k < p.d) k_step<kLdmatrix, true>(v32, q32, lm, rw, k, c, p.d, odd);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] += odd[t][i];
  }
}

// The dot of d bf16 lanes at v and q one lane at a time (any d, 2-byte
// alignment).
__device__ __forceinline__ float dot_lanes(const unsigned char* v, const unsigned char* q, int d) {
  const uint16_t* v16 = reinterpret_cast<const uint16_t*>(v);
  const uint16_t* q16 = reinterpret_cast<const uint16_t*>(q);
  float a0 = 0.f, a1 = 0.f;
  int j = 0;
  for (; j + 1 < d; j += 2) {
    a0 = fmaf(bf16_bits_to_float(v16[j]), bf16_bits_to_float(q16[j]), a0);
    a1 = fmaf(bf16_bits_to_float(v16[j + 1]), bf16_bits_to_float(q16[j + 1]), a1);
  }
  if (j < d) a0 = fmaf(bf16_bits_to_float(v16[j]), bf16_bits_to_float(q16[j]), a0);
  return a0 + a1;
}

// Score staged row `row` (and, for K1, unpack its ids).
template <bool kFlat, bool kMma>
__device__ __forceinline__ void score_row(const Params& p, const unsigned char* slot, int row, int lane) {
  const unsigned char* qs = slot + p.row_area + (query_addr(p, row) & 15);
  float* out = p.dots + static_cast<long long>(row) * p.M;
  if constexpr (kMma) {
    for (int m0 = 0; m0 < p.M; m0 += 32) {
      float acc[2][4] = {};
      dot_tiles<!kFlat>(p, slot, qs, m0, lane, acc);
      if ((lane & 3) == 0) {  // column 0 of D (every column holds the same dots)
        const int g = lane >> 2;
        const int rows[4] = {m0 + g, m0 + g + 8, m0 + 16 + g, m0 + 24 + g};
        const float vals[4] = {acc[0][0], acc[0][2], acc[1][0], acc[1][2]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (rows[i] < p.M) out[rows[i]] = vals[i];
        }
      }
    }
  } else {
    for (int m = lane; m < p.M; m += kWarp) out[m] = dot_lanes(slot + m * p.vec_stride, qs, p.d);
  }
  if constexpr (kFlat) {
    const uint16_t* idl = reinterpret_cast<const uint16_t*>(slot) + p.M * p.d;  // low half, then high half
    for (int m = lane; m < p.M; m += kWarp) {
      p.nbrs[static_cast<long long>(row) * p.M + m] = static_cast<int32_t>(idl[2 * m] | (static_cast<uint32_t>(idl[2 * m + 1]) << 16));
    }
  }
}

template <bool kFlat, bool kMma>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kBlocksPerSm) nbr_score_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  const int first = blockIdx.x * warps + warp;  // this warp's rows: first, first + step, ...
  const int step = gridDim.x * warps;
  if (first >= p.pairs) return;  // whole warp leaves together
  const int rows = (p.pairs - first + step - 1) / step;
  const int S = p.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * kMaxStages;
  unsigned char* slots = smem + kBarBytes + static_cast<size_t>(warp) * S * p.slot_bytes;

  if (lane < S) mbar_init(&bars[lane]);
  __syncwarp();
  // the ids of the first S rows, one lane each, then their copies
  const int32_t first_ids = lane < S && lane < rows ? p.sel_ids[first + lane * step] : 0;
  for (int k = 0; k < S && k < rows; ++k) {
    stage_row(p, slots + k * p.slot_bytes, &bars[k], first + k * step, __shfl_sync(kFull, first_ids, k), lane);
  }
  for (int k = 0; k < rows; ++k) {
    const int s = k % S;
    const int next = k + S;
    const int row = first + k * step;
    const int32_t next_id = next < rows ? p.sel_ids[first + next * step] : 0;  // in flight while this row scores
    unsigned char* slot = slots + s * p.slot_bytes;
    mbar_wait(&bars[s], (k / S) & 1);
    score_row<kFlat, kMma>(p, slot, row, lane);
    __syncwarp();  // every lane is done with the slot
    if (next < rows) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // reads before the async refill
      stage_row(p, slot, &bars[s], first + next * step, next_id, lane);
    }
  }
}

struct DeviceLimits {
  int sms = 0;
  int smem_block = 0;  // opt-in dynamic shared memory a block may use
  int smem_sm = 0;     // shared memory of one SM
  cudaError_t err = cudaSuccess;
};

DeviceLimits g_limits[kMaxDevices];
std::once_flag g_once[kMaxDevices];

template <bool kFlat, bool kMma>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(nbr_score_kernel<kFlat, kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The device's limits, and every kernel instance allowed all of a block's
// shared memory (the current device must be `device`).
DeviceLimits read_limits(int device) {
  DeviceLimits l;
  cudaError_t err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, device);
  if (!err) err = cudaDeviceGetAttribute(&l.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (!err) err = cudaDeviceGetAttribute(&l.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (!err) err = allow_smem<true, true>(l.smem_block);
  if (!err) err = allow_smem<true, false>(l.smem_block);
  if (!err) err = allow_smem<false, true>(l.smem_block);
  if (!err) err = allow_smem<false, false>(l.smem_block);
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

// Size the grid, the warps and the ring for `p` (whose row_bytes,
// vec_stride and row staging are set), then launch.
int launch(Params& p, bool flat, int device, cudaStream_t stream) {
  const DeviceLimits* lim = nullptr;
  cudaError_t err = use_device(device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.pairs <= 0) return 0;
  p.row_area = pad(p.row_bytes, 128);
  p.slot_bytes = p.row_area + pad(query_granule_bytes(p.d), 128);
  const int room = lim->smem_block - kBarBytes;
  const int warps = room / p.slot_bytes < kMaxWarps ? room / p.slot_bytes : kMaxWarps;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);  // one row does not fit in shared memory
  auto most_blocks = [&](int stages) {  // blocks of `stages` slots a warp that the SMs hold at once
    int per_sm = lim->smem_sm / (kBarBytes + warps * stages * p.slot_bytes + 1024);  // 1 KB a block for the runtime
    per_sm = per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm;  // (and the threads: 8 x 128 <= 2048)
    return static_cast<long long>(lim->sms) * (per_sm > 1 ? per_sm : 1);
  };
  const long long wanted = (p.pairs + warps - 1) / warps;  // blocks that give every row a warp of its own
  long long grid = wanted;
  p.stages = 1;
  if (wanted > most_blocks(1)) {  // more rows than resident warps: a ring per warp
    const int fit = room / (warps * p.slot_bytes);
    const int stages = fit < kMaxStages ? fit : kMaxStages;
    grid = most_blocks(stages);
    const long long rows_per_warp = (p.pairs + grid * warps - 1) / (grid * warps);
    p.stages = static_cast<int>(rows_per_warp < stages ? rows_per_warp : stages);
  }
  const int smem = kBarBytes + warps * p.stages * p.slot_bytes;
  // the tensor cores take bf16 pairs: even d, a query on a 4-byte and vectors on an 8-byte boundary
  const bool mma = p.d % 2 == 0 && p.vec_stride % 8 == 0 && reinterpret_cast<uintptr_t>(p.q) % 4 == 0;
  const dim3 blocks(static_cast<unsigned>(grid)), threads(warps * kWarp);
  if (flat && mma) {
    nbr_score_kernel<true, true><<<blocks, threads, smem, stream>>>(p);
  } else if (flat) {
    nbr_score_kernel<true, false><<<blocks, threads, smem, stream>>>(p);
  } else if (mma) {
    nbr_score_kernel<false, true><<<blocks, threads, smem, stream>>>(p);
  } else {
    nbr_score_kernel<false, false><<<blocks, threads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor map of a tiled table: bf16[n * Mp, 128] rows of 256 bytes, a
// box of M rows x pad8(d) lanes.  Encoded on the host through the driver's
// entry point (no link against libcuda), looked up once per process.
PFN_cuTensorMapEncodeTiled_v12000 g_encode = nullptr;
cudaError_t g_encode_err = cudaSuccess;
std::once_flag g_encode_once;

cudaError_t tiled_map(const void* tab, long long n_rows, int Mp, int M, int d, CUtensorMap* out) {
  std::call_once(g_encode_once, [] {
    cudaDriverEntryPointQueryResult found;
    g_encode_err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&g_encode),
                                           cudaEnableDefault, &found);
    if (g_encode_err == cudaSuccess && (found != cudaDriverEntryPointSuccess || g_encode == nullptr)) {
      g_encode_err = cudaErrorNotSupported;
    }
  });
  if (g_encode_err != cudaSuccess) return g_encode_err;
  const cuuint64_t dims[2] = {kTileLanes, static_cast<cuuint64_t>(n_rows) * Mp};
  const cuuint64_t strides[1] = {kTileLanes * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(pad(d, 8)), static_cast<cuuint32_t>(M)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = g_encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(tab), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// K1.  Launches on `stream` (the caller's current CUDA stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int gt_gather_score_flat(const void* tab, long long n_rows, int row_w,
                                    const void* sel_ids, long long pairs, int expand,
                                    const void* q, int M, int d, void* dots, void* nbrs,
                                    int device, void* stream) {
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);  // rows are counted in int
  Params p{};
  p.tab = static_cast<const unsigned char*>(tab);
  p.n_rows = n_rows;
  p.row_pitch = 2LL * row_w;
  p.sel_ids = static_cast<const int32_t*>(sel_ids);
  p.pairs = static_cast<int>(pairs);
  p.expand = expand;
  p.q = static_cast<const unsigned char*>(q);
  p.M = M;
  p.d = d;
  p.row_bytes = 2 * row_lanes(M, d);
  p.vec_stride = 2 * d;
  p.dots = static_cast<float*>(dots);
  p.nbrs = static_cast<int32_t*>(nbrs);
  return launch(p, true, device, static_cast<cudaStream_t>(stream));
}

// K2.  Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int gt_gather_score(const void* tab, long long n_rows, int Mp,
                               const void* sel_ids, long long pairs, int expand,
                               const void* q, int M, int d, void* dots,
                               int device, void* stream) {
  if (M > 256 || n_rows * Mp > 0x7fffffffLL || pairs > 0x7fffffffLL) {  // TMA box, coordinate, int row counts
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  const cudaError_t err = tiled_map(tab, n_rows, Mp, M, d, &p.map);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.tab = static_cast<const unsigned char*>(tab);
  p.n_rows = n_rows;
  p.row_pitch = static_cast<long long>(Mp) * kTileLanes * 2;
  p.tiles = Mp;
  p.sel_ids = static_cast<const int32_t*>(sel_ids);
  p.pairs = static_cast<int>(pairs);
  p.expand = expand;
  p.q = static_cast<const unsigned char*>(q);
  p.M = M;
  p.d = d;
  p.vec_stride = 2 * pad(d, 8);
  p.row_bytes = M * p.vec_stride;
  p.dots = static_cast<float*>(dots);
  p.nbrs = nullptr;
  return launch(p, false, device, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
