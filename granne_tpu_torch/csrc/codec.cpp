// Native (C++) components of granne-tpu: the host-side runtime.
//
// granne_tpu_torch's own copy of granne_tpu/native/codec.cpp.  The two
// copies define one on-disk format: the code below is that file's, line
// for line (tests/test_torch_native.py compares them with comments
// stripped), and only comments may differ.
//
// Reference parity (re-designed, not translated — the reference is Rust):
//  * compressed adjacency rows: sort -> delta -> StreamVByte with a raw
//    fallback and a leading count byte, mirroring the design of
//    granne's src/slice_vector/set_vector.rs (MultiSetVector).
//  * compressed monotone offset table: chunks of {u64 initial, u16 deltas},
//    mirroring granne's src/slice_vector/offsets.rs (~2.1B/offset).
//    The adjacency block's row-offset table uses this format (the
//    CompressedVariableWidthSliceVector analogue, offsets.rs:10-13).
//  * scalar HNSW beam search over f32 or int8 elements: the CPU serving
//    path and the single-core baseline denominator, mirroring the hot loop
//    at granne's src/index/mod.rs:999-1037 and the int8 distance at
//    granne's src/elements/angular_int.rs:47-60.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (granne_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <unordered_set>
#include <vector>

// ---------------------------------------------------------------------------
// StreamVByte (public format: per group of 4 values, 1 control byte with two
// bits per value giving the byte length 1..4, followed by the value bytes).
// ---------------------------------------------------------------------------

static inline uint32_t svb_len(uint32_t v) {
  if (v < (1u << 8)) return 1;
  if (v < (1u << 16)) return 2;
  if (v < (1u << 24)) return 3;
  return 4;
}

static size_t svb_encode(const uint32_t* in, uint32_t count, uint8_t* out) {
  uint8_t* ctrl = out;
  uint32_t n_ctrl = (count + 3) / 4;
  uint8_t* data = out + n_ctrl;
  std::memset(ctrl, 0, n_ctrl);
  for (uint32_t i = 0; i < count; i++) {
    uint32_t v = in[i];
    uint32_t len = svb_len(v);
    ctrl[i / 4] |= (uint8_t)((len - 1) << ((i % 4) * 2));
    for (uint32_t b = 0; b < len; b++) {
      *data++ = (uint8_t)(v & 0xff);
      v >>= 8;
    }
  }
  return (size_t)(data - out);
}

static size_t svb_decode(const uint8_t* in, uint32_t count, uint32_t* out) {
  const uint8_t* ctrl = in;
  uint32_t n_ctrl = (count + 3) / 4;
  const uint8_t* data = in + n_ctrl;
  for (uint32_t i = 0; i < count; i++) {
    uint32_t len = ((ctrl[i / 4] >> ((i % 4) * 2)) & 3) + 1;
    uint32_t v = 0;
    for (uint32_t b = 0; b < len; b++) v |= ((uint32_t)(*data++)) << (8 * b);
    out[i] = v;
  }
  return (size_t)(data - in);
}

// ---------------------------------------------------------------------------
// Adjacency row codec (set_vector.rs design: count byte, delta+svb payload,
// raw fallback when compression does not shrink).
// ---------------------------------------------------------------------------

static const uint8_t kRowRaw = 1;
static const uint32_t kMinToEncode = 4;  // set_vector.rs:12

// Encode one row of `width` int32 neighbor ids (-1 = unused). Returns bytes
// written. Worst case: 2 + width*4 + (width+3)/4 + 4.
static size_t encode_row(const int32_t* row, uint32_t width, uint8_t* out) {
  uint32_t ids[256];
  uint32_t count = 0;
  for (uint32_t i = 0; i < width && count < 255; i++)
    if (row[i] >= 0) ids[count++] = (uint32_t)row[i];
  std::sort(ids, ids + count);
  out[0] = (uint8_t)count;
  if (count < kMinToEncode) {
    out[1] = kRowRaw;
    std::memcpy(out + 2, ids, count * 4);
    return 2 + count * 4;
  }
  // delta encode (first absolute, then differences)
  uint32_t deltas[256];
  deltas[0] = ids[0];
  for (uint32_t i = 1; i < count; i++) deltas[i] = ids[i] - ids[i - 1];
  uint8_t tmp[5 * 256];
  size_t enc = svb_encode(deltas, count, tmp);
  if (enc >= (size_t)count * 4) {  // fallback (set_vector.rs:137-143)
    out[1] = kRowRaw;
    std::memcpy(out + 2, ids, count * 4);
    return 2 + count * 4;
  }
  out[1] = 0;
  std::memcpy(out + 2, tmp, enc);
  return 2 + enc;
}

// Decode one row into `out` (padded with -1 to width). Returns bytes read.
static size_t decode_row(const uint8_t* in, uint32_t width, int32_t* out) {
  uint32_t count = in[0];
  uint8_t flags = in[1];
  uint32_t vals[256];
  size_t used = 2;
  if (flags & kRowRaw) {
    std::memcpy(vals, in + 2, count * 4);
    used += count * 4;
  } else {
    used += svb_decode(in + 2, count, vals);
    for (uint32_t i = 1; i < count; i++) vals[i] += vals[i - 1];
  }
  uint32_t n = count < width ? count : width;
  for (uint32_t i = 0; i < n; i++) out[i] = (int32_t)vals[i];
  for (uint32_t i = n; i < width; i++) out[i] = -1;
  return used;
}

// ---------------------------------------------------------------------------
// Compressed monotone offsets (offsets.rs design): chunks of
// {u64 initial, u16 deltas[60]} — ~2.1 bytes/offset instead of 4/8.
// Random access: offset(i) = chunk[i/60].initial + sum(deltas[0 .. i%60]).
// ---------------------------------------------------------------------------

static const uint32_t kOffsetsPerChunk = 60;  // offsets.rs:7-8

struct OffsetChunk {
  uint64_t initial;
  uint16_t deltas[kOffsetsPerChunk];
};

extern "C" size_t gt_offsets_encoded_size(uint32_t count) {
  uint32_t chunks = (count + kOffsetsPerChunk - 1) / kOffsetsPerChunk;
  return 8 + (size_t)chunks * sizeof(OffsetChunk);
}

// offsets: u64[count] monotone, deltas must fit u16. Returns bytes or 0 on
// overflow (caller falls back to raw).
extern "C" size_t gt_offsets_encode(const uint64_t* offsets, uint32_t count,
                                    uint8_t* out) {
  uint64_t cnt64 = count;
  std::memcpy(out, &cnt64, 8);
  OffsetChunk* chunks = reinterpret_cast<OffsetChunk*>(out + 8);
  uint32_t n_chunks = (count + kOffsetsPerChunk - 1) / kOffsetsPerChunk;
  for (uint32_t c = 0; c < n_chunks; c++) {
    OffsetChunk& ch = chunks[c];
    uint32_t base = c * kOffsetsPerChunk;
    ch.initial = offsets[base];
    for (uint32_t j = 0; j < kOffsetsPerChunk; j++) {
      uint32_t idx = base + j;
      uint64_t d = 0;
      if (idx + 1 < count) {
        d = offsets[idx + 1] - offsets[idx];
        if (d > 0xffff) return 0;  // caller must use raw table
      }
      ch.deltas[j] = (uint16_t)d;
    }
  }
  return gt_offsets_encoded_size(count);
}

extern "C" uint64_t gt_offsets_get(const uint8_t* buf, uint32_t idx) {
  const OffsetChunk* chunks = reinterpret_cast<const OffsetChunk*>(buf + 8);
  const OffsetChunk& ch = chunks[idx / kOffsetsPerChunk];
  uint64_t v = ch.initial;
  for (uint32_t j = 0; j < idx % kOffsetsPerChunk; j++) v += ch.deltas[j];
  return v;
}

extern "C" int gt_offsets_decode(const uint8_t* buf, uint64_t* out,
                                 uint32_t count) {
  for (uint32_t i = 0; i < count; i++) out[i] = gt_offsets_get(buf, i);
  return 0;
}

// ---------------------------------------------------------------------------
// Compressed adjacency block (v2).  Layout:
//   u32 rows, u32 width, u32 flags, u32 reserved, u64 payload_len
//   payload: per-row codec payloads back to back
//   offset table: row payload start offsets —
//     flags & kAdjChunkedOffsets: chunk-compressed (gt_offsets format)
//     else:                       raw u32[rows]
// The chunked table is the CompressedVariableWidthSliceVector analogue
// (granne's src/slice_vector/offsets.rs:10-13): ~2.1 B/row instead
// of 4, while rows stay randomly accessible for the mmap serving path.
// ---------------------------------------------------------------------------

static const uint32_t kAdjChunkedOffsets = 1;
static const size_t kAdjHeader = 24;

extern "C" size_t gt_encode_bound(uint32_t rows, uint32_t width) {
  return kAdjHeader + (size_t)rows * (2 + (size_t)width * 4 + (width + 3) / 4 + 4) +
         (size_t)rows * 4 + gt_offsets_encoded_size(rows) + 16;
}

extern "C" size_t gt_encode_adjacency(const int32_t* adj, uint32_t rows,
                                      uint32_t width, uint8_t* out) {
  uint8_t* p = out + kAdjHeader;
  std::vector<uint64_t> offsets(rows);
  uint8_t* base = p;
  for (uint32_t r = 0; r < rows; r++) {
    offsets[r] = (uint64_t)(p - base);
    p += encode_row(adj + (size_t)r * width, width, p);
  }
  uint64_t payload_len = (uint64_t)(p - base);
  uint32_t flags = 0;
  if (rows > 0) {
    size_t enc = gt_offsets_encode(offsets.data(), rows, p);
    if (enc > 0) {
      flags |= kAdjChunkedOffsets;
      p += enc;
    } else {
      // raw u32 fallback (per-row payloads are < 64KiB so this is
      // unreachable in practice; kept for format robustness)
      std::vector<uint32_t> raw(rows);
      for (uint32_t r = 0; r < rows; r++) raw[r] = (uint32_t)offsets[r];
      std::memcpy(p, raw.data(), (size_t)rows * 4);
      p += (size_t)rows * 4;
    }
  }
  std::memcpy(out, &rows, 4);
  std::memcpy(out + 4, &width, 4);
  std::memcpy(out + 8, &flags, 4);
  uint32_t reserved = 0;
  std::memcpy(out + 12, &reserved, 4);
  std::memcpy(out + 16, &payload_len, 8);
  return (size_t)(p - out);
}

struct CompressedLayer {
  const uint8_t* payload;  // row payloads base
  const uint8_t* table;    // offset table (chunked or raw)
  uint32_t rows;
  uint32_t width;
  bool chunked;

  inline uint64_t row_start(uint32_t r) const {
    if (chunked) return gt_offsets_get(table, r);
    uint32_t v;
    std::memcpy(&v, table + (size_t)r * 4, 4);
    return v;
  }
};

static CompressedLayer parse_compressed(const uint8_t* buf, size_t len) {
  (void)len;
  CompressedLayer l;
  uint32_t flags;
  uint64_t payload_len;
  std::memcpy(&l.rows, buf, 4);
  std::memcpy(&l.width, buf + 4, 4);
  std::memcpy(&flags, buf + 8, 4);
  std::memcpy(&payload_len, buf + 16, 8);
  l.payload = buf + kAdjHeader;
  l.table = l.payload + payload_len;
  l.chunked = (flags & kAdjChunkedOffsets) != 0;
  return l;
}

extern "C" int gt_decode_adjacency(const uint8_t* buf, size_t len,
                                   int32_t* out) {
  CompressedLayer l = parse_compressed(buf, len);
  const uint8_t* p = l.payload;
  for (uint32_t r = 0; r < l.rows; r++)
    p += decode_row(p, l.width, out + (size_t)r * l.width);
  return 0;
}

extern "C" int gt_adjacency_shape(const uint8_t* buf, uint32_t* rows,
                                  uint32_t* width) {
  std::memcpy(rows, buf, 4);
  std::memcpy(width, buf + 4, 4);
  return 0;
}

// ---------------------------------------------------------------------------
// Scalar HNSW search (reference hot loop, mod.rs:999-1037), templated over
// the element space: f32 angular (angular.rs:63-74, unit-norm rows) or int8
// quantized cosine (angular_int.rs:47-60, i32-accumulated dot scaled by
// reciprocal norms).  Serves dense or compressed (mmap) adjacency.
// ---------------------------------------------------------------------------

struct F32Elements {
  const float* vectors;
  uint32_t d;
  inline float dist(uint32_t id, const float* q, float /*q_inv*/) const {
    const float* a = vectors + (size_t)id * d;
    float dot = 0.f;
    for (uint32_t i = 0; i < d; i++) dot += a[i] * q[i];
    float dist = 1.0f - dot;
    return dist > 0.f ? dist : 0.f;
  }
  typedef float QueryScalar;
};

struct I8Elements {
  const int8_t* vectors;
  const float* inv_norms;  // per element, 0.0 for zero rows
  uint32_t d;
  inline float dist(uint32_t id, const int8_t* q, float q_inv) const {
    const int8_t* a = vectors + (size_t)id * d;
    int32_t r = 0;
    for (uint32_t i = 0; i < d; i++) r += (int32_t)a[i] * (int32_t)q[i];
    float cos = (float)r * inv_norms[id] * q_inv;
    float dist = 1.0f - cos;
    return dist > 0.f ? dist : 0.f;
  }
  typedef int8_t QueryScalar;
};

struct HeapEntry {
  float d;
  uint32_t id;
};
struct CandCmp {  // min-heap on distance
  bool operator()(const HeapEntry& a, const HeapEntry& b) const { return a.d > b.d; }
};
struct ResCmp {  // max-heap on distance
  bool operator()(const HeapEntry& a, const HeapEntry& b) const { return a.d < b.d; }
};

// Dense adjacency accessor: rows are width int32s, -1 padded.
struct DenseGraph {
  const int32_t* adj;
  uint32_t width;
  inline const int32_t* row(uint32_t id, int32_t* /*buf*/) const {
    return adj + (size_t)id * width;
  }
  static const bool kFrontPacked = false;
};

// Compressed adjacency accessor: decode the visited row into buf (exactly
// the reference's per-visit StreamVByte decode, set_vector.rs:91-115).
struct CompressedGraph {
  CompressedLayer layer;
  inline const int32_t* row(uint32_t id, int32_t* buf) const {
    decode_row(layer.payload + layer.row_start(id), layer.width, buf);
    return buf;
  }
  static const bool kFrontPacked = true;
};

template <typename Elements, typename Graph>
static void search_layer_t(const Elements& el, const Graph& g, uint32_t width,
                           const typename Elements::QueryScalar* q, float q_inv,
                           uint32_t entry, uint32_t ef,
                           std::vector<HeapEntry>& out) {
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, CandCmp> pq;
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, ResCmp> res;
  std::unordered_set<uint32_t> visited;
  visited.reserve(ef * 20);
  int32_t row_buf[256];
  float d0 = el.dist(entry, q, q_inv);
  pq.push({d0, entry});
  visited.insert(entry);
  while (!pq.empty()) {
    HeapEntry top = pq.top();
    pq.pop();
    if (res.size() >= ef && top.d > res.top().d) break;
    if (res.size() >= ef) res.pop();
    res.push(top);
    const int32_t* row = g.row(top.id, row_buf);
    for (uint32_t i = 0; i < width; i++) {
      int32_t nbr = row[i];
      if (nbr < 0) {
        if (Graph::kFrontPacked) break;  // decoded rows are front-packed
        continue;
      }
      if (visited.insert((uint32_t)nbr).second) {
        float nd = el.dist((uint32_t)nbr, q, q_inv);
        if (res.size() < ef || nd < res.top().d) pq.push({nd, (uint32_t)nbr});
      }
    }
  }
  out.clear();
  while (!res.empty()) {
    out.push_back(res.top());
    res.pop();
  }
  std::reverse(out.begin(), out.end());
}

template <typename Elements, typename MakeGraph>
static void search_all_t(const Elements& el, MakeGraph make_graph,
                         uint32_t num_layers, uint32_t width,
                         const typename Elements::QueryScalar* queries,
                         const float* q_invs, uint32_t d, uint32_t nq,
                         uint32_t ef, uint32_t k, uint32_t num_threads,
                         int32_t* out_ids, float* out_dists) {
  auto run = [&](uint32_t q0, uint32_t q1) {
    std::vector<HeapEntry> buf;
    for (uint32_t qi = q0; qi < q1; qi++) {
      const typename Elements::QueryScalar* q = queries + (size_t)qi * d;
      float q_inv = q_invs ? q_invs[qi] : 0.f;
      uint32_t entry = 0;
      for (uint32_t l = 0; l + 1 < num_layers; l++) {
        search_layer_t(el, make_graph(l), width, q, q_inv, entry, 1, buf);
        if (!buf.empty()) entry = buf[0].id;
      }
      search_layer_t(el, make_graph(num_layers - 1), width, q, q_inv, entry,
                     ef, buf);
      for (uint32_t j = 0; j < k; j++) {
        if (j < buf.size()) {
          out_ids[(size_t)qi * k + j] = (int32_t)buf[j].id;
          out_dists[(size_t)qi * k + j] = buf[j].d;
        } else {
          out_ids[(size_t)qi * k + j] = -1;
          out_dists[(size_t)qi * k + j] = 1e30f;
        }
      }
    }
  };
  if (num_threads <= 1) {
    run(0, nq);
  } else {
    std::vector<std::thread> ts;
    uint32_t chunk = (nq + num_threads - 1) / num_threads;
    for (uint32_t t = 0; t < num_threads; t++) {
      uint32_t a = t * chunk, b = std::min(nq, a + chunk);
      if (a >= b) break;
      ts.emplace_back(run, a, b);
    }
    for (auto& t : ts) t.join();
  }
}

extern "C" void gt_search_f32(const float* vectors, uint32_t n, uint32_t d,
                              const int32_t* const* layers, uint32_t num_layers,
                              uint32_t width, const float* queries, uint32_t nq,
                              uint32_t ef, uint32_t k, uint32_t num_threads,
                              int32_t* out_ids, float* out_dists) {
  (void)n;
  F32Elements el{vectors, d};
  auto make_graph = [&](uint32_t l) { return DenseGraph{layers[l], width}; };
  search_all_t(el, make_graph, num_layers, width, queries, nullptr, d, nq, ef,
               k, num_threads, out_ids, out_dists);
}

extern "C" void gt_search_i8(const int8_t* vectors, const float* inv_norms,
                             uint32_t n, uint32_t d,
                             const int32_t* const* layers, uint32_t num_layers,
                             uint32_t width, const int8_t* queries,
                             const float* q_inv_norms, uint32_t nq, uint32_t ef,
                             uint32_t k, uint32_t num_threads, int32_t* out_ids,
                             float* out_dists) {
  (void)n;
  I8Elements el{vectors, inv_norms, d};
  auto make_graph = [&](uint32_t l) { return DenseGraph{layers[l], width}; };
  search_all_t(el, make_graph, num_layers, width, queries, q_inv_norms, d, nq,
               ef, k, num_threads, out_ids, out_dists);
}

extern "C" void gt_search_compressed(const float* vectors, uint32_t n,
                                     uint32_t d,
                                     const uint8_t* const* layer_bufs,
                                     const uint64_t* layer_lens,
                                     uint32_t num_layers, const float* queries,
                                     uint32_t nq, uint32_t ef, uint32_t k,
                                     uint32_t num_threads, int32_t* out_ids,
                                     float* out_dists) {
  (void)n;
  std::vector<CompressedLayer> layers(num_layers);
  for (uint32_t l = 0; l < num_layers; l++)
    layers[l] = parse_compressed(layer_bufs[l], layer_lens[l]);
  uint32_t width = layers.empty() ? 0 : layers[0].width;
  F32Elements el{vectors, d};
  auto make_graph = [&](uint32_t l) { return CompressedGraph{layers[l]}; };
  search_all_t(el, make_graph, num_layers, width, queries, nullptr, d, nq, ef,
               k, num_threads, out_ids, out_dists);
}

extern "C" void gt_search_compressed_i8(
    const int8_t* vectors, const float* inv_norms, uint32_t n, uint32_t d,
    const uint8_t* const* layer_bufs, const uint64_t* layer_lens,
    uint32_t num_layers, const int8_t* queries, const float* q_inv_norms,
    uint32_t nq, uint32_t ef, uint32_t k, uint32_t num_threads,
    int32_t* out_ids, float* out_dists) {
  (void)n;
  std::vector<CompressedLayer> layers(num_layers);
  for (uint32_t l = 0; l < num_layers; l++)
    layers[l] = parse_compressed(layer_bufs[l], layer_lens[l]);
  uint32_t width = layers.empty() ? 0 : layers[0].width;
  I8Elements el{vectors, inv_norms, d};
  auto make_graph = [&](uint32_t l) { return CompressedGraph{layers[l]}; };
  search_all_t(el, make_graph, num_layers, width, queries, q_inv_norms, d, nq,
               ef, k, num_threads, out_ids, out_dists);
}
