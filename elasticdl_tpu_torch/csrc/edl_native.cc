// Native runtime pieces (C ABI, loaded via ctypes).
//
// Reference parity (SURVEY.md §2 #10-#11 [U/D]): the reference's native
// components are a Go parameter server — an embedding-table KV store with
// server-side sparse optimizers (SGD/Adagrad/Adam) and checkpoint dump/load —
// plus vectorized apply-gradient kernels.  TPU-first re-design: the *sharded*
// embedding path lives in HBM on the mesh (ops/embedding.py); THIS store is
// the host tier for tables that exceed HBM — the worker pulls the batch's
// unique rows to the device, computes dense grads for them, and pushes the
// sparse update back here, where the optimizer applies it in place.  Also
// includes the recordio range-scanner used on the ingest hot path.
//
// Build: see Makefile (g++ -O3 -shared).  No external deps beyond libc++.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- utilities

// splitmix64: deterministic per-id seed for default row init.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// crc32 (IEEE, reflected), slice-by-8 — the record reader CRC-checks every
// payload on the ingest hot path, so the bytewise table walk (~300 MB/s on
// this host) was the read bottleneck; slice-by-8 processes 8 bytes per
// iteration (~2 GB/s).  Tables generated on first use.
static uint32_t crc_table[8][256];
static bool crc_ready = false;
static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = crc_table[0][i];
    for (int t = 1; t < 8; t++) {
      c = crc_table[0][c & 0xff] ^ (c >> 8);
      crc_table[t][i] = c;
    }
  }
  crc_ready = true;
}
static uint32_t crc32_buf(const uint8_t* p, size_t n) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xffffffffu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = crc_table[7][lo & 0xff] ^ crc_table[6][(lo >> 8) & 0xff] ^
        crc_table[5][(lo >> 16) & 0xff] ^ crc_table[4][lo >> 24] ^
        crc_table[3][hi & 0xff] ^ crc_table[2][(hi >> 8) & 0xff] ^
        crc_table[1][(hi >> 16) & 0xff] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = crc_table[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// ------------------------------------------------------- embedding KV store

enum Optimizer { OPT_SGD = 0, OPT_MOMENTUM = 1, OPT_ADAGRAD = 2, OPT_ADAM = 3 };

struct EdlStore {
  int64_t dim;
  int opt;
  float lr, momentum, beta1, beta2, eps;
  float init_scale;
  // stride = weights + optimizer slots, all contiguous per row.
  int64_t stride;
  std::unordered_map<int64_t, int64_t> index;  // id -> row offset (in floats)
  std::vector<float> arena;
  std::vector<int64_t> ids_in_order;  // for checkpoint iteration stability
  std::vector<int32_t> adam_t;        // per-row step count (Adam only)

  int64_t slots() const {
    switch (opt) {
      case OPT_SGD: return 0;
      case OPT_MOMENTUM: return 1;
      case OPT_ADAGRAD: return 1;
      case OPT_ADAM: return 2;
    }
    return 0;
  }

  float* row(int64_t id, bool create) {
    auto it = index.find(id);
    if (it != index.end()) return arena.data() + it->second;
    if (!create) return nullptr;
    int64_t off = (int64_t)arena.size();
    arena.resize(arena.size() + stride, 0.0f);
    float* r = arena.data() + off;
    uint64_t s = splitmix64((uint64_t)id);
    for (int64_t d = 0; d < dim; d++) {
      s = splitmix64(s);
      // uniform in [-init_scale, init_scale)
      r[d] = init_scale * (2.0f * (float)((s >> 11) * (1.0 / 9007199254740992.0)) - 1.0f);
    }
    index.emplace(id, off);
    ids_in_order.push_back(id);
    if (opt == OPT_ADAM) adam_t.push_back(0);
    return r;
  }
};

EdlStore* edl_store_create(int64_t dim, int optimizer, float lr, float momentum,
                           float beta1, float beta2, float eps,
                           float init_scale) {
  EdlStore* s = new EdlStore();
  s->dim = dim;
  s->opt = optimizer;
  s->lr = lr;
  s->momentum = momentum;
  s->beta1 = beta1;
  s->beta2 = beta2;
  s->eps = eps;
  s->init_scale = init_scale;
  s->stride = dim * (1 + s->slots());
  return s;
}

void edl_store_destroy(EdlStore* s) { delete s; }

int64_t edl_store_size(EdlStore* s) { return (int64_t)s->index.size(); }

// Gather rows for n ids into out[n*dim]; rows for unseen ids are initialized.
void edl_store_pull(EdlStore* s, const int64_t* ids, int64_t n, float* out) {
  for (int64_t i = 0; i < n; i++) {
    const float* r = s->row(ids[i], /*create=*/true);
    std::memcpy(out + i * s->dim, r, sizeof(float) * s->dim);
  }
}

// Read-only gather: fills out[n*dim] for ids that EXIST; returns the number
// of missing ids (their rows are left untouched).  Never mutates the store,
// so any number of threads may call it concurrently as long as no writer
// (push/pull-create/load) runs — the PS service's reader-writer fast path
// (ps/service.py): steady-state training pulls hit only existing rows and
// scale across the gRPC thread pool instead of serializing on one mutex.
int64_t edl_store_try_pull(EdlStore* s, const int64_t* ids, int64_t n,
                           float* out) {
  int64_t missing = 0;
  for (int64_t i = 0; i < n; i++) {
    auto it = s->index.find(ids[i]);
    if (it == s->index.end()) {
      missing++;
      continue;
    }
    std::memcpy(out + i * s->dim, s->arena.data() + it->second,
                sizeof(float) * s->dim);
  }
  return missing;
}

// Sparse apply: ids may contain duplicates — contributions are accumulated
// before one optimizer step per distinct row (IndexedSlices semantics).
void edl_store_push_grad(EdlStore* s, const int64_t* ids, int64_t n,
                         const float* grads) {
  const int64_t dim = s->dim;
  std::unordered_map<int64_t, std::vector<float>> acc;
  acc.reserve(n * 2);
  for (int64_t i = 0; i < n; i++) {
    auto& g = acc[ids[i]];
    if (g.empty()) g.assign(dim, 0.0f);
    const float* gi = grads + i * dim;
    for (int64_t d = 0; d < dim; d++) g[d] += gi[d];
  }
  for (auto& kv : acc) {
    float* w = s->row(kv.first, /*create=*/true);
    float* g = kv.second.data();
    switch (s->opt) {
      case OPT_SGD: {
        for (int64_t d = 0; d < dim; d++) w[d] -= s->lr * g[d];
        break;
      }
      case OPT_MOMENTUM: {
        float* m = w + dim;
        for (int64_t d = 0; d < dim; d++) {
          m[d] = s->momentum * m[d] + g[d];
          w[d] -= s->lr * m[d];
        }
        break;
      }
      case OPT_ADAGRAD: {
        float* a = w + dim;
        for (int64_t d = 0; d < dim; d++) {
          a[d] += g[d] * g[d];
          w[d] -= s->lr * g[d] / (std::sqrt(a[d]) + s->eps);
        }
        break;
      }
      case OPT_ADAM: {
        float* m = w + dim;
        float* v = w + 2 * dim;
        int64_t row_i = (int64_t)(s->index[kv.first] / s->stride);
        int32_t t = ++s->adam_t[row_i];
        const float bc1 = 1.0f - std::pow(s->beta1, (float)t);
        const float bc2 = 1.0f - std::pow(s->beta2, (float)t);
        for (int64_t d = 0; d < dim; d++) {
          m[d] = s->beta1 * m[d] + (1.0f - s->beta1) * g[d];
          v[d] = s->beta2 * v[d] + (1.0f - s->beta2) * g[d] * g[d];
          const float mh = m[d] / bc1, vh = v[d] / bc2;
          w[d] -= s->lr * mh / (std::sqrt(vh) + s->eps);
        }
        break;
      }
    }
  }
}

// Checkpoint: [int64 n][int64 dim][int64 stride][int32 opt]
//             then per row: [int64 id][int32 adam_t][stride floats]
// Every write is checked: a short write (full disk, I/O error) must fail the
// save, not surface later as an unreadable checkpoint.
int64_t edl_store_save(EdlStore* s, const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  bool ok = true;
  int64_t n = (int64_t)s->index.size();
  ok &= std::fwrite(&n, 8, 1, f) == 1;
  ok &= std::fwrite(&s->dim, 8, 1, f) == 1;
  ok &= std::fwrite(&s->stride, 8, 1, f) == 1;
  int32_t opt = s->opt;
  ok &= std::fwrite(&opt, 4, 1, f) == 1;
  for (int64_t i = 0; ok && i < n; i++) {
    int64_t id = s->ids_in_order[i];
    int64_t off = s->index[id];
    int32_t t = (s->opt == OPT_ADAM) ? s->adam_t[off / s->stride] : 0;
    ok &= std::fwrite(&id, 8, 1, f) == 1;
    ok &= std::fwrite(&t, 4, 1, f) == 1;
    ok &= std::fwrite(s->arena.data() + off, sizeof(float), s->stride, f) ==
          (size_t)s->stride;
  }
  ok &= std::fclose(f) == 0;
  return ok ? n : -1;
}

int64_t edl_store_load(EdlStore* s, const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t n, dim, stride;
  int32_t opt;
  if (std::fread(&n, 8, 1, f) != 1 || std::fread(&dim, 8, 1, f) != 1 ||
      std::fread(&stride, 8, 1, f) != 1 || std::fread(&opt, 4, 1, f) != 1) {
    std::fclose(f);
    return -1;
  }
  if (dim != s->dim || stride != s->stride || opt != s->opt) {
    std::fclose(f);
    return -2;  // store configuration mismatch
  }
  s->index.clear();
  s->arena.clear();
  s->ids_in_order.clear();
  s->adam_t.clear();
  s->arena.reserve((size_t)n * stride);
  for (int64_t i = 0; i < n; i++) {
    int64_t id;
    int32_t t;
    if (std::fread(&id, 8, 1, f) != 1 || std::fread(&t, 4, 1, f) != 1) {
      std::fclose(f);
      return -1;
    }
    int64_t off = (int64_t)s->arena.size();
    s->arena.resize(s->arena.size() + stride);
    if (std::fread(s->arena.data() + off, sizeof(float), stride, f) !=
        (size_t)stride) {
      std::fclose(f);
      return -1;
    }
    s->index.emplace(id, off);
    s->ids_in_order.push_back(id);
    if (s->opt == OPT_ADAM) s->adam_t.push_back(t);
  }
  std::fclose(f);
  return n;
}

// --------------------------------------------------------- recordio scanner

// Scan an EDLRIO file, filling offsets[] (record byte offsets) up to
// max_records.  Returns the number of records found, -1 on malformed input,
// or -2 if the file holds more than max_records records (truncation is an
// error, never silent).  Mirrors data/recordio.py (the format's source of
// truth).
int64_t edl_recordio_index(const char* path, int64_t* offsets,
                           int64_t max_records) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "EDLRIO\x00\x01", 8) != 0) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_END);
  const int64_t size = std::ftell(f);
  int64_t pos = 8, n = 0;
  while (pos < size && n < max_records) {
    uint32_t hdr[2];
    std::fseek(f, pos, SEEK_SET);
    if (std::fread(hdr, 4, 2, f) != 2) { std::fclose(f); return -1; }
    offsets[n++] = pos;
    pos += 8 + (int64_t)hdr[0];
  }
  std::fclose(f);
  if (pos > size) return -1;
  if (pos < size) return -2;  // records remain beyond max_records
  return n;
}

// Bulk-read records [start, end) given their byte offsets: ONE disk read of
// the contiguous span, then in-memory header walk + CRC check, concatenating
// payloads into out[] and writing each payload's length to lens[].
// ``span_bytes`` is offsets[end]-offsets[start] (or file_size-offsets[start]
// for the final record) — the caller knows both.  Returns total payload
// bytes; -1 on I/O error / malformed framing, -2 on CRC mismatch, -3 if
// out_cap is too small.  This is the ingest hot path: the Python reader's
// per-record fread loop costs ~2 us/record in interpreter overhead alone,
// which at recommendation-model batch sizes (8k records) rivals the whole
// device step (SURVEY.md §2 #14 — the reference feeds workers through
// tf.data's C++ pipeline; this is that role).
int64_t edl_recordio_read(const char* path, const int64_t* offsets,
                          int64_t start, int64_t end, int64_t span_bytes,
                          uint8_t* out, int64_t out_cap, int64_t* lens) {
  if (end <= start) return 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> span((size_t)span_bytes);
  std::fseek(f, (long)offsets[start], SEEK_SET);
  const bool read_ok =
      std::fread(span.data(), 1, (size_t)span_bytes, f) == (size_t)span_bytes;
  std::fclose(f);
  if (!read_ok) return -1;
  int64_t pos = 0, written = 0;
  for (int64_t i = start; i < end; i++) {
    if (pos + 8 > span_bytes) return -1;
    uint32_t len, crc;
    std::memcpy(&len, span.data() + pos, 4);
    std::memcpy(&crc, span.data() + pos + 4, 4);
    pos += 8;
    if (pos + (int64_t)len > span_bytes) return -1;
    if (crc32_buf(span.data() + pos, len) != crc) return -2;
    if (written + (int64_t)len > out_cap) return -3;
    std::memcpy(out + written, span.data() + pos, len);
    lens[i - start] = (int64_t)len;
    written += len;
    pos += len;
  }
  return written;
}

// --------------------------------------------------------- criteo decoder
//
// Decode n Kaggle-TSV criteo records (label \t 13 ints \t 26 hex ids, blanks
// allowed) from one contiguous buffer delimited by cumulative offsets[n+1]
// into labels[n] / dense[n*13] / cat[n*26].  Missing trailing fields and
// blank fields decode to 0, matching the Python feed (data/codecs.py — the
// format's source of truth).  Returns 0, or -(i+1) on a malformed record i.
// Replaces a ~85 us/record Python str.split loop (measured: 692 ms per 8192
// records — 80x the device step) with ~0.3 us/record.

static int8_t hex_lut[256];
static bool hex_ready = false;
static void hex_init() {
  for (int i = 0; i < 256; i++) hex_lut[i] = -1;
  for (int i = 0; i < 10; i++) hex_lut['0' + i] = (int8_t)i;
  for (int i = 0; i < 6; i++) {
    hex_lut['a' + i] = (int8_t)(10 + i);
    hex_lut['A' + i] = (int8_t)(10 + i);
  }
  hex_ready = true;
}

static inline const uint8_t* criteo_float(const uint8_t* p, const uint8_t* end,
                                          float* out, bool* ok) {
  // Minimal decimal float: sign, digits, optional .digits, optional e[+-]exp.
  // Criteo dense features are small integers; the general path exists so
  // hand-written data with decimals parses like Python's float().
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = *p++ == '-';
  double v = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10.0 + (*p++ - '0'); any = true; }
  if (p < end && *p == '.') {
    p++;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') { v += (*p++ - '0') * scale; scale *= 0.1; any = true; }
  }
  if (any && p < end && (*p == 'e' || *p == 'E')) {
    p++;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) eneg = *p++ == '-';
    int64_t e = 0;
    while (p < end && *p >= '0' && *p <= '9') e = e * 10 + (*p++ - '0');
    v *= std::pow(10.0, eneg ? (double)-e : (double)e);
  }
  *ok = any && p == end;
  *out = (float)(neg ? -v : v);
  return p;
}

// float32 -> float16 bits, round-to-nearest-even (matches numpy's cast).
static inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  const uint32_t sign = (x >> 16) & 0x8000u;
  const int32_t exp = (int32_t)((x >> 23) & 0xffu) - 127 + 15;
  const uint32_t mant = x & 0x7fffffu;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflow to signed zero
    // subnormal half
    uint32_t m = (mant | 0x800000u) >> (1 - exp);
    uint32_t half = sign | (m >> 13);
    uint32_t rem = m & 0x1fffu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
    return (uint16_t)half;
  }
  if (exp >= 31) {
    // NaN must stay NaN (qNaN), not collapse to inf (ADVICE r4 #2): the
    // current PRE transform (log1p(max(x,0))) can't produce one, but the
    // cast must match numpy if that ever changes.
    if (((x >> 23) & 0xffu) == 0xffu && mant != 0)
      return (uint16_t)(sign | 0x7e00u);
    return (uint16_t)(sign | 0x7c00u);  // overflow -> inf
  }
  uint32_t half = sign | ((uint32_t)exp << 10) | (mant >> 13);
  const uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)half;
}

// Test-surface export: the cast's numerics (round-to-nearest-even,
// subnormals, inf, and the NaN branch no current PRE transform can reach)
// are verified against numpy's cast in tests/test_host_store.py.
uint16_t edl_f32_to_f16(float f) { return f32_to_f16(f); }

}  // extern "C" — paused: templates need C++ linkage; resumed below.

// Shared criteo parse core.  PRE=false fills raw arrays (labels int32,
// dense float32, cat int32 = the hex id bit-cast).  PRE=true applies the
// model's host-side preprocessing during the parse — the reference runs its
// preprocessing layers inside the input pipeline the same way (SURVEY.md
// §2 #15) — emitting labels uint8, dense float16 log1p, cat uint16 hashed
// into [0, buckets) with the models/tabular.py multiplicative hash.  The
// compact forms exist to cut PCIe/link bytes per example (160 B -> 79 B).
template <bool PRE, typename LabelT, typename DenseT, typename CatT>
static int64_t criteo_parse(const uint8_t* buf, const int64_t* offsets,
                            int64_t n, LabelT* labels, DenseT* dense,
                            CatT* cat, uint32_t buckets) {
  if (!hex_ready) hex_init();
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = buf + offsets[i];
    const uint8_t* rec_end = buf + offsets[i + 1];
    // label: small non-negative int
    int64_t lab = 0;
    bool any = false;
    while (p < rec_end && *p >= '0' && *p <= '9') { lab = lab * 10 + (*p++ - '0'); any = true; }
    if (!any || (p < rec_end && *p != '\t')) return -(i + 1);
    labels[i] = (LabelT)lab;
    // 13 dense fields (blank -> 0.0); output rows pre-zeroed by the caller
    // (for PRE, transform(0) == 0 so missing fields stay correct).
    // Fast path: plain (possibly signed) integers — what the Kaggle dump
    // holds — parsed in one pass; anything else re-parses as a float.
    DenseT* drow = dense + i * 13;
    for (int j = 0; j < 13 && p < rec_end; j++) {
      p++;  // consume the '\t' that ended the previous field
      const uint8_t* fstart = p;
      bool neg = false;
      if (p < rec_end && *p == '-') { neg = true; p++; }
      int64_t v = 0;
      while (p < rec_end && (uint8_t)(*p - '0') < 10) v = v * 10 + (*p++ - '0');
      float val;
      bool got = false;
      if (p == rec_end || *p == '\t') {
        if (p > fstart + (neg ? 1 : 0)) {
          val = (float)(neg ? -v : v);
          got = true;
        } else if (neg) {
          return -(i + 1);  // a bare "-" is not a number (match float('-'))
        }
      } else {
        const uint8_t* fend = p;
        while (fend < rec_end && *fend != '\t') fend++;
        bool ok;
        criteo_float(fstart, fend, &val, &ok);
        if (!ok) return -(i + 1);
        p = fend;
        got = true;
      }
      if (got) {
        if (PRE) {
          // models/tabular.py log_normalize: log1p(max(x, 0)), then the
          // numpy-identical round-to-nearest f16 cast.
          drow[j] = (DenseT)f32_to_f16(std::log1p(val > 0.0f ? val : 0.0f));
        } else {
          drow[j] = (DenseT)val;
        }
      }
    }
    // 26 categorical hex ids (blank -> 0), via a 256-entry nibble LUT.
    CatT* crow = cat + i * 26;
    for (int j = 0; j < 26 && p < rec_end; j++) {
      p++;
      uint32_t v = 0;
      bool got = false;
      while (p < rec_end && *p != '\t') {
        const int8_t d = hex_lut[*p];
        if (d < 0) return -(i + 1);
        v = (v << 4) | (uint32_t)d;
        got = true;
        p++;
      }
      if (got) {
        if (PRE) {
          // models/tabular.py hash_buckets: h = id * 2654435761 (uint32
          // wraparound); h ^= h >> 16; h % buckets.
          uint32_t h = v * 2654435761u;
          h ^= h >> 16;
          crow[j] = (CatT)(h % buckets);
        } else {
          crow[j] = (CatT)(int32_t)v;
        }
      }
    }
    if (p != rec_end) return -(i + 1);  // surplus fields: malformed
  }
  return 0;
}

extern "C" {

int64_t edl_criteo_decode(const uint8_t* buf, const int64_t* offsets,
                          int64_t n, int32_t* labels, float* dense,
                          int32_t* cat) {
  return criteo_parse<false>(buf, offsets, n, labels, dense, cat, 0u);
}

// Census CSV decode (Wide&Deep, BASELINE config #3): ``label,5 numerics,
// 9 categorical strings`` per record.  Numerics follow the ToNumber layer
// (strip; empty/invalid -> 0.0); strings follow the Hashing layer
// (crc32(stripped bytes) % hash_bins — preprocessing/layers.py is the
// source of truth, equality pinned by tests).  Returns 0 or -(i+1) on a
// record whose label fails to parse (the only hard-error field).
int64_t edl_census_decode(const uint8_t* buf, const int64_t* offsets,
                          int64_t n, int32_t* labels, float* dense,
                          int32_t* cat, int64_t hash_bins) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = buf + offsets[i];
    const uint8_t* rec_end = buf + offsets[i + 1];
    int64_t lab = 0;
    bool neg = false, any = false;
    if (p < rec_end && *p == '-') { neg = true; p++; }
    while (p < rec_end && *p >= '0' && *p <= '9') { lab = lab * 10 + (*p++ - '0'); any = true; }
    if (!any || (p < rec_end && *p != ',')) return -(i + 1);
    labels[i] = (int32_t)(neg ? -lab : lab);
    float* drow = dense + i * 5;
    for (int j = 0; j < 5 && p < rec_end; j++) {
      p++;  // consume ','
      const uint8_t* fend = p;
      while (fend < rec_end && *fend != ',') fend++;
      const uint8_t* s = p;
      const uint8_t* e = fend;
      while (s < e && (*s == ' ' || *s == '\t' || *s == '\r' || *s == '\n')) s++;
      while (e > s && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r' || e[-1] == '\n')) e--;
      if (e > s) {
        bool ok;
        float v;
        criteo_float(s, e, &v, &ok);
        if (ok) drow[j] = v;  // invalid -> stays 0.0 (ToNumber default)
      }
      p = fend;
    }
    int32_t* crow = cat + i * 9;
    for (int j = 0; j < 9 && p < rec_end; j++) {
      p++;
      const uint8_t* fend = p;
      while (fend < rec_end && *fend != ',') fend++;
      const uint8_t* s = p;
      const uint8_t* e = fend;
      while (s < e && (*s == ' ' || *s == '\t' || *s == '\r' || *s == '\n')) s++;
      while (e > s && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r' || e[-1] == '\n')) e--;
      crow[j] = (int32_t)(crc32_buf(s, (size_t)(e - s)) %
                          (uint64_t)hash_bins);
      p = fend;
    }
    if (p != rec_end) return -(i + 1);
  }
  return 0;
}

// Preprocessed decode: labels uint8, dense float16 (log1p-normalized), cat
// uint16 (hashed into [0, buckets); requires buckets <= 65536).  Halves the
// host->device bytes per example — see criteo_parse.
int64_t edl_criteo_decode_pre(const uint8_t* buf, const int64_t* offsets,
                              int64_t n, uint8_t* labels, uint16_t* dense,
                              uint16_t* cat, int64_t buckets) {
  if (buckets < 1 || buckets > 65536) return -(n + 1);
  return criteo_parse<true>(buf, offsets, n, labels, dense, cat,
                            (uint32_t)buckets);
}

// CRC-verify records [start, end) given their offsets; returns the index of
// the first corrupt record, or -1 if all pass.
int64_t edl_recordio_verify(const char* path, const int64_t* offsets,
                            int64_t start, int64_t end) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return start;
  std::vector<uint8_t> buf;
  for (int64_t i = start; i < end; i++) {
    uint32_t hdr[2];
    std::fseek(f, offsets[i], SEEK_SET);
    if (std::fread(hdr, 4, 2, f) != 2) { std::fclose(f); return i; }
    buf.resize(hdr[0]);
    if (hdr[0] && std::fread(buf.data(), 1, hdr[0], f) != hdr[0]) {
      std::fclose(f);
      return i;
    }
    if (crc32_buf(buf.data(), buf.size()) != hdr[1]) {
      std::fclose(f);
      return i;
    }
  }
  std::fclose(f);
  return -1;
}

}  // extern "C"
