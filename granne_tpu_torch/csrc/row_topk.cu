// Row top-k: the k largest of each row of a float32 matrix, best first.
//
// Replaces no Pallas kernel: the JAX package leaves lax.top_k (the IVF
// probe's and merge's, granne_tpu/index/ivf.py) to XLA.  The port's plain
// version is ops/topk.py::top_k, a stable torch.sort of each whole row;
// this kernel returns what it returns, bit for bit:
//   * values f32 [R, k] and columns int64 [R, k], best first;
//   * equal values go to the lower column (lax.top_k's order and the stable
//     sort's); the comparison is numeric, so -0.0 equals +0.0;
//   * -inf ranks below every finite value and NaN below -inf (where the
//     stable ascending sort of the negated scores puts it);
//   * each value is the input's own bits, read back at its column.
// 1 <= k <= min(C, 32).
//
// What bounds it on the H100.  It reads each score once and writes k
// values and columns a row: at the IVF probe's shape (10,000 queries x
// 6,467 centroid scores, k 8) 259 MB, 0.077 ms at 3.35 TB/s; at the merge's
// (10,000 x 2,048, k 10) 82 MB, 0.024 ms.  A sort of the whole row moves
// each score several times and orders thousands of columns to keep 8.  So
// the design reads each row once, coalesced, and spends as few instructions
// per score as it can, so that the reads and not the issue slots set the
// time:
//
// * One warp per row, eight rows a thread block; a lane reads columns
//   lane, lane + 32, ... kV loads at a time before it looks at any of them,
//   so each warp keeps kV x 128 bytes in flight.  Scalar loads: a row of
//   6,467 floats does not start on a 16-byte boundary.
// * The warp keeps the row's running top-32 in registers, entry t in lane
//   t, sorted best first.  An entry is a 64-bit key: an order-preserving
//   map of the float (-0.0 as +0.0, NaN below -inf) above the complement of
//   the column, so every column has its own key, a larger key is a better
//   (value, lower column), and empty entries (key 0) lie below all of them.
//   The running k-th entry is the threshold.
// * Each score is first held against the threshold as a float and a
//   column (value above it, or equal and at a lower column): one compare
//   or two, no conversion.  A warp's candidates (a ballot) go through one
//   at a time, warp-uniform: its key is checked exactly against the
//   threshold, and if better, each lane counts the entries above it
//   (ballot, popc), lanes below its place shift down one (shfl_up), and the
//   threshold is read again from lane k - 1.  No lane waits on another
//   lane's private insertion, and in a row of scores in no order only some
//   k (1 + ln(C / k)) candidates pass (~60 of 6,467 at k 8), most of them early.
// * The keys form a strict total order, so the result does not depend on
//   the order in which candidates arrive: the k largest keys are the
//   answer, and lane t < k writes the t-th with the value read back at its
//   column.
//
// The launch sets the device only when it differs from the current one,
// allocates nothing and does not synchronise, so it can be captured in a
// CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // a warp a row
constexpr int kV = 8;             // loads a lane issues before it compares
constexpr int kMaxK = kWarp;      // an entry a lane

// The order-preserving 64-bit key of (v, col): larger is better.
__device__ __forceinline__ unsigned long long entry_key(float v, unsigned col) {
  unsigned u = v == 0.0f ? 0u : __float_as_uint(v);            // -0.0 as +0.0
  unsigned key = u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
  if (v != v) key = 0u;                                        // NaN below -inf
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~col);
}

// The float whose key is `key` (key != 0).
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float(key & 0x80000000u ? key ^ 0x80000000u : ~key);
}

__global__ void __launch_bounds__(kRowsPerBlock* kWarp)
    row_topk_kernel(const float* __restrict__ scores, long long rows, int cols, int k,
                    float* __restrict__ out_v, long long* __restrict__ out_i) {
  const int lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // the whole warp
  const float* p = scores + row * cols;

  unsigned long long entry = 0;  // the row's running top-32, entry `lane`
  unsigned long long thr = 0;    // entry k - 1
  bool open = true;              // thr is empty or NaN: every score goes to the exact check
  float thr_v = 0.0f;
  unsigned thr_col = 0;

  for (int base = 0; base < cols; base += kV * kWarp) {
    float v[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int col = base + j * kWarp + lane;
      v[j] = col < cols ? p[col] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const unsigned col = static_cast<unsigned>(base + j * kWarp + lane);
      const bool pass = col < static_cast<unsigned>(cols) &&
                        (open || v[j] > thr_v || (v[j] == thr_v && col < thr_col));
      unsigned m = __ballot_sync(kAll, pass);
      while (m) {  // warp-uniform
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const unsigned long long cand =
            entry_key(__shfl_sync(kAll, v[j], src), static_cast<unsigned>(base + j * kWarp + src));
        if (cand > thr) {
          const int at = __popc(__ballot_sync(kAll, entry > cand));  // < k
          const unsigned long long up = __shfl_up_sync(kAll, entry, 1);
          entry = lane > at ? up : (lane == at ? cand : entry);
          thr = __shfl_sync(kAll, entry, k - 1);
          const unsigned key = static_cast<unsigned>(thr >> 32);
          open = key == 0u;
          thr_v = key_value(key);
          thr_col = ~static_cast<unsigned>(thr);
        }
      }
    }
  }
  if (lane < k) {
    const unsigned col = ~static_cast<unsigned>(entry);
    out_v[row * k + lane] = p[col];
    out_i[row * k + lane] = static_cast<long long>(col);
  }
}

}  // namespace

// Launches on `stream` (the caller's current CUDA stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.  `scores`
// is a contiguous f32 [rows, cols]; `out_v` f32 and `out_i` int64 [rows, k].
extern "C" int gt_row_topk(const void* scores, long long rows, int cols, int k, void* out_v, void* out_i,
                           int device, void* stream) {
  if (rows < 0 || cols < 1 || k < 1 || k > kMaxK || k > cols) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_topk_kernel<<<static_cast<unsigned>(grid), kRowsPerBlock * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), rows, cols, k, static_cast<float*>(out_v), static_cast<long long*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_row_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
