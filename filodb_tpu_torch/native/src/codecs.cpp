// Native codec fast paths for filodb_tpu.
//
// Implements the same storage formats as the Python codecs in
// filodb_tpu/codecs/ (NibblePack groups, DELTA2 sloped-line residuals,
// XOR-double residual chains) — the TPU-native equivalent of the
// reference's Unsafe-level hot codecs (reference:
// memory/src/main/scala/filodb.memory/format/NibblePack.scala:12,
// format/vectors/DeltaDeltaVector.scala:28, DoubleVector.scala:14).
// Bound from Python via ctypes (filodb_tpu/native/__init__.py); every
// function is extern "C" and operates on caller-owned buffers.
//
// All decode paths are bounds-checked against buflen and return -1 on
// overrun so a corrupt chunk can never read out of bounds.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

#if defined(_MSC_VER)
#include <intrin.h>
#endif

namespace {

inline int ctz64(uint64_t x) {
#if defined(_MSC_VER)
  unsigned long idx;
  _BitScanForward64(&idx, x);
  return static_cast<int>(idx);
#else
  return __builtin_ctzll(x);
#endif
}

inline int clz64(uint64_t x) {
#if defined(_MSC_VER)
  unsigned long idx;
  _BitScanReverse64(&idx, x);
  return 63 - static_cast<int>(idx);
#else
  return __builtin_clzll(x);
#endif
}

inline int popcount8(uint8_t x) {
#if defined(_MSC_VER)
  return static_cast<int>(__popcnt16(x));
#else
  return __builtin_popcount(x);
#endif
}

inline uint64_t zigzag_enc(int64_t v) {
  return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

inline int64_t zigzag_dec(uint64_t u) {
  return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

// Nibble-stream writer: accumulates nibbles into bytes, low nibble first.
struct NibbleWriter {
  uint8_t* out;
  size_t pos;
  bool half;     // true => low nibble of out[pos] already written
  void put(uint8_t nib) {
    if (!half) {
      out[pos] = nib;
      half = true;
    } else {
      out[pos] |= static_cast<uint8_t>(nib << 4);
      ++pos;
      half = false;
    }
  }
  void flush() {
    if (half) {
      ++pos;
      half = false;
    }
  }
};

}  // namespace

extern "C" {

// Upper bound on packed size for n values (2 header bytes + 16 nibbles
// per value, per group of 8).
size_t np_max_packed(size_t n) {
  size_t ngroups = (n + 7) / 8;
  return ngroups * (2 + 8 * 8);
}

// NibblePack n u64 values into out (which must hold np_max_packed(n)).
// Returns bytes written.
long long np_pack(const uint64_t* v, size_t n, uint8_t* out) {
  size_t ngroups = (n + 7) / 8;
  size_t opos = 0;
  for (size_t g = 0; g < ngroups; ++g) {
    uint64_t group[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    size_t base = g * 8;
    size_t lim = (base + 8 <= n) ? 8 : n - base;
    for (size_t i = 0; i < lim; ++i) group[i] = v[base + i];

    uint8_t bitmask = 0;
    int tz = 64, lz = 64;
    for (int i = 0; i < 8; ++i) {
      if (group[i] != 0) {
        bitmask |= static_cast<uint8_t>(1u << i);
        int t = ctz64(group[i]);
        int l = clz64(group[i]);
        if (t < tz) tz = t;
        if (l < lz) lz = l;
      }
    }
    out[opos++] = bitmask;
    if (bitmask == 0) continue;

    int trailing = tz / 4;
    int leading = lz / 4;
    int num_nibbles = 16 - leading - trailing;
    if (num_nibbles < 1) num_nibbles = 1;
    out[opos++] = static_cast<uint8_t>((trailing & 0xF) |
                                       ((num_nibbles - 1) << 4));
    NibbleWriter w{out, opos, false};
    for (int i = 0; i < 8; ++i) {
      if (group[i] == 0) continue;
      uint64_t shifted = group[i] >> (trailing * 4);
      for (int k = 0; k < num_nibbles; ++k) {
        w.put(static_cast<uint8_t>((shifted >> (4 * k)) & 0xF));
      }
    }
    w.flush();
    opos = w.pos;
  }
  return static_cast<long long>(opos);
}

// Decode count u64 values from buf starting at offset into out.
// Returns the next offset, or -1 on buffer overrun.
long long np_unpack(const uint8_t* buf, size_t buflen, size_t offset,
                    size_t count, uint64_t* out) {
  size_t pos = offset;
  size_t ngroups = (count + 7) / 8;
  size_t emitted = 0;
  for (size_t g = 0; g < ngroups; ++g) {
    if (pos >= buflen) return -1;
    uint8_t bitmask = buf[pos++];
    if (bitmask == 0) {
      for (int i = 0; i < 8 && emitted < count; ++i) out[emitted++] = 0;
      continue;
    }
    if (pos >= buflen) return -1;
    uint8_t hdr = buf[pos++];
    int trailing = hdr & 0xF;
    int num_nibbles = (hdr >> 4) + 1;
    int nnz = popcount8(bitmask);
    size_t total_nibbles = static_cast<size_t>(num_nibbles) * nnz;
    size_t nbytes = (total_nibbles + 1) / 2;
    if (pos + nbytes > buflen) return -1;

    size_t nib_idx = 0;  // index into the nibble stream for this group
    // fast path: one unaligned u64 load covers a whole value's nibbles
    // (num_nibbles < 16 -> <= 60 bits + a 4-bit phase shift); the slow
    // per-nibble walk remains for 16-nibble values and the buffer tail
    if (num_nibbles < 16 && pos + nbytes + 8 <= buflen) {
      uint64_t vmask = (1ull << (4 * num_nibbles)) - 1;
      int tshift = trailing * 4;
      for (int i = 0; i < 8; ++i) {
        uint64_t val = 0;
        if (bitmask & (1u << i)) {
          uint64_t w;
          std::memcpy(&w, buf + pos + (nib_idx >> 1), 8);
          val = ((w >> (4 * (nib_idx & 1))) & vmask) << tshift;
          nib_idx += static_cast<size_t>(num_nibbles);
        }
        if (emitted < count) out[emitted++] = val;
      }
      pos += nbytes;
      continue;
    }
    for (int i = 0; i < 8; ++i) {
      uint64_t val = 0;
      if (bitmask & (1u << i)) {
        for (int k = 0; k < num_nibbles; ++k, ++nib_idx) {
          uint8_t byte = buf[pos + nib_idx / 2];
          uint8_t nib = (nib_idx & 1) ? (byte >> 4) : (byte & 0xF);
          val |= static_cast<uint64_t>(nib) << (4 * k);
        }
        val <<= (trailing * 4);
      }
      if (emitted < count) out[emitted++] = val;
    }
    pos += nbytes;
  }
  return static_cast<long long>(pos);
}

// Walk a packed run without materializing values; returns end offset or -1.
long long np_packed_end(const uint8_t* buf, size_t buflen, size_t offset,
                        size_t count) {
  size_t pos = offset;
  size_t ngroups = (count + 7) / 8;
  for (size_t g = 0; g < ngroups; ++g) {
    if (pos >= buflen) return -1;
    uint8_t bitmask = buf[pos++];
    if (bitmask == 0) continue;
    if (pos >= buflen) return -1;
    uint8_t hdr = buf[pos++];
    int num_nibbles = (hdr >> 4) + 1;
    int nnz = popcount8(bitmask);
    pos += (static_cast<size_t>(num_nibbles) * nnz + 1) / 2;
    if (pos > buflen) return -1;
  }
  return static_cast<long long>(pos);
}

// Fused DELTA2 decode.  buf points at the wire-type byte of a
// CONST_LONG/DELTA2 vector: u8 wire, u32 n, i64 base, i64 slope,
// [nibble-packed zigzag residuals].  Writes n int64s; returns n or -1.
// wire_const / wire_delta2 are passed in so the wire-code registry stays
// single-sourced in Python (filodb_tpu/codecs/wire.py).
long long dd_decode(const uint8_t* buf, size_t buflen, int wire_const,
                    int wire_delta2, int64_t* out, size_t out_cap) {
  if (buflen < 21) return -1;
  int wire = buf[0];
  if (wire != wire_const && wire != wire_delta2) return -1;
  uint32_t n;
  uint64_t base, slope;
  std::memcpy(&n, buf + 1, 4);
  std::memcpy(&base, buf + 5, 8);
  std::memcpy(&slope, buf + 13, 8);
  if (n > out_cap) return -1;

  uint64_t pred = base;
  if (wire == wire_const) {
    for (uint32_t i = 0; i < n; ++i) {
      out[i] = static_cast<int64_t>(pred);
      pred += slope;
    }
    return n;
  }
  // DELTA2: stream groups of 8 residuals and fuse line + zigzag add.
  size_t pos = 21;
  uint32_t emitted = 0;
  uint64_t resid[8];
  size_t ngroups = (static_cast<size_t>(n) + 7) / 8;
  for (size_t g = 0; g < ngroups; ++g) {
    long long next = np_unpack(buf, buflen, pos, 8, resid);
    if (next < 0) return -1;
    pos = static_cast<size_t>(next);
    for (int i = 0; i < 8 && emitted < n; ++i, ++emitted) {
      out[emitted] = static_cast<int64_t>(
          pred + static_cast<uint64_t>(zigzag_dec(resid[i])));
      pred += slope;
    }
  }
  return n;
}

// Fused XOR-double decode: nibble-unpack count u64 residuals starting at
// offset and invert the XOR-with-previous chain in one pass.
// Returns next offset or -1.
long long xor_unpack(const uint8_t* buf, size_t buflen, size_t offset,
                     size_t count, double* out) {
  size_t pos = offset;
  size_t ngroups = (count + 7) / 8;
  size_t emitted = 0;
  uint64_t acc = 0;
  uint64_t resid[8];
  for (size_t g = 0; g < ngroups; ++g) {
    long long next = np_unpack(buf, buflen, pos, 8, resid);
    if (next < 0) return -1;
    pos = static_cast<size_t>(next);
    for (int i = 0; i < 8 && emitted < count; ++i, ++emitted) {
      acc ^= resid[i];
      std::memcpy(&out[emitted], &acc, 8);
    }
  }
  return static_cast<long long>(pos);
}

// ---------------------------------------------------------------------------
// Columnar container decode: the ingest fast path.
//
// Parses one RecordContainer (filodb_tpu/core/record.py wire layout:
// u32 total, then records of [u16 schema_hash, u32 shard_hash,
// u32 part_hash, i64 ts, data cols..., u16 pklen, pk bytes]) straight
// into columnar arrays, deduplicating partition keys with a hash map so
// Python touches one object per *series*, not per record.  Ingest-side
// equivalent of the reference's zero-copy RecordContainer.iterate over
// off-heap BinaryRecords (reference: core/src/main/scala/filodb.core/
// binaryrecord2/RecordContainer.scala:27, TimeSeriesShard.scala:488-522).
//
// Schema table: per schema, its 16-bit hash, data-column count, and
// column type codes (1 = f64 bit pattern into the i64 cell, 2 = i64,
// 3 = i32 widened, 4 = histogram blob: the cell receives the blob's
// ABSOLUTE byte offset; hist_col_decode below expands the blobs)
// flattened as sch_types[si * max_cols + ci].  String columns are
// unsupported (-2): those containers take the Python path.  Every
// record must carry the same schema hash (-3 otherwise — mixed
// containers fall back too).  Returns the record count, or a negative
// error code: -1 malformed, -2 unsupported column, -3 mixed/unknown
// schema, -4 capacity exceeded.
long long cd_decode(const uint8_t* buf, size_t buflen,
                    const uint16_t* sch_hashes, const uint8_t* sch_ncols,
                    const uint8_t* sch_types, size_t max_cols,
                    size_t n_schemas, size_t cap, int64_t* ts_out,
                    int64_t* vals_out, uint32_t* shard_out,
                    uint32_t* part_out, int32_t* uniq_out,
                    int64_t* pk_off, int64_t* pk_len, int64_t* uniq_first,
                    long long* n_uniq_out, int32_t* schema_hash_out) {
  if (buflen < 4) return -1;
  uint32_t total;
  std::memcpy(&total, buf, 4);
  size_t end = 4 + static_cast<size_t>(total);
  if (end > buflen) return -1;

  // resolve the (single) schema from the first record
  if (end < 4 + 18) return total == 0 ? 0 : -1;
  uint16_t schema_hash;
  std::memcpy(&schema_hash, buf + 4, 2);
  size_t si = n_schemas;
  for (size_t i = 0; i < n_schemas; ++i)
    if (sch_hashes[i] == schema_hash) { si = i; break; }
  if (si == n_schemas) return -3;
  const size_t ncols = sch_ncols[si];
  const uint8_t* types = sch_types + si * max_cols;
  for (size_t c = 0; c < ncols; ++c)
    if (types[c] < 1 || types[c] > 4) return -2;

  std::unordered_map<std::string_view, int32_t> pk_map;
  pk_map.reserve(256);
  size_t pos = 4;
  long long n = 0, n_uniq = 0;
  while (pos < end) {
    if (pos + 18 > end) return -1;
    if (static_cast<size_t>(n) >= cap) return -4;
    uint16_t sh;
    std::memcpy(&sh, buf + pos, 2);
    if (sh != schema_hash) return -3;
    std::memcpy(&shard_out[n], buf + pos + 2, 4);
    std::memcpy(&part_out[n], buf + pos + 6, 4);
    std::memcpy(&ts_out[n], buf + pos + 10, 8);
    pos += 18;
    int64_t* row = vals_out + static_cast<size_t>(n) * max_cols;
    for (size_t c = 0; c < ncols; ++c) {
      switch (types[c]) {
        case 1:  // f64: keep the bit pattern; Python views as float64
        case 2:  // i64
          if (pos + 8 > end) return -1;
          std::memcpy(&row[c], buf + pos, 8);
          pos += 8;
          break;
        case 3: {  // i32 widened
          if (pos + 4 > end) return -1;
          int32_t v;
          std::memcpy(&v, buf + pos, 4);
          row[c] = v;
          pos += 4;
          break;
        }
        case 4: {  // histogram blob: u16 len + bytes; record the offset
          if (pos + 2 > end) return -1;
          uint16_t blen;
          std::memcpy(&blen, buf + pos, 2);
          pos += 2;
          if (pos + blen > end) return -1;
          row[c] = static_cast<int64_t>(pos);
          pos += blen;
          break;
        }
      }
    }
    if (pos + 2 > end) return -1;
    uint16_t pklen;
    std::memcpy(&pklen, buf + pos, 2);
    pos += 2;
    if (pos + pklen > end) return -1;
    std::string_view key(reinterpret_cast<const char*>(buf + pos), pklen);
    auto it = pk_map.find(key);
    int32_t uid;
    if (it == pk_map.end()) {
      uid = static_cast<int32_t>(n_uniq);
      pk_map.emplace(key, uid);
      pk_off[n_uniq] = static_cast<int64_t>(pos);
      pk_len[n_uniq] = pklen;
      uniq_first[n_uniq] = n;
      ++n_uniq;
    } else {
      uid = it->second;
    }
    uniq_out[n] = uid;
    pos += pklen;
    ++n;
  }
  *n_uniq_out = n_uniq;
  *schema_hash_out = static_cast<int32_t>(schema_hash);
  return n;
}

// ---------------------------------------------------------------------------
// Histogram column expansion: decode every record's BinaryHistogram blob
// (filodb_tpu/codecs/histcodec.py encode_hist_value layout: u8 wire_hist,
// u16 n_buckets, bucket scheme [geometric: u8 id + 19 B | custom: u8 id
// + u16 cn + 8*cn B], nibble-packed zigzag deltas) into a dense
// [n, hb_cap] cumulative-counts matrix in one native pass, deduplicating
// bucket schemes by their serialized bytes.  The ingest-side answer to
// the reference's per-record BinHistogram parse (reference:
// memory/format/vectors/HistogramVector.scala:34; the jmh analog is
// HistogramIngestBenchmark.scala:29).
//
// blob_off comes from cd_decode's type-4 cells (each u16 length prefix
// precedes the blob, so the bound is re-read here).  Returns n, or -1
// malformed, -2 wrong wire/scheme, -4 a blob exceeds hb_cap, -5 scheme
// capacity exceeded.
long long hist_col_decode(const uint8_t* buf, size_t buflen,
                          const int64_t* blob_off, size_t n,
                          int wire_hist, int scheme_geo, int scheme_custom,
                          size_t hb_cap, int64_t* counts_out,
                          int32_t* nb_out, int32_t* scheme_idx,
                          int64_t* uscheme_off, int64_t* uscheme_len,
                          size_t cap_schemes, long long* n_schemes_out) {
  std::unordered_map<std::string_view, int32_t> smap;
  smap.reserve(4);
  long long ns = 0;
  uint64_t tmp[8];
  for (size_t i = 0; i < n; ++i) {
    size_t pos = static_cast<size_t>(blob_off[i]);
    if (pos < 2 || pos + 3 > buflen) return -1;
    uint16_t blen;
    std::memcpy(&blen, buf + pos - 2, 2);
    size_t bend = pos + blen;
    if (bend > buflen || pos + 3 > bend) return -1;
    if (buf[pos] != wire_hist) return -2;
    uint16_t nv;
    std::memcpy(&nv, buf + pos + 1, 2);
    if (nv > hb_cap) return -4;
    size_t spos = pos + 3;
    if (spos >= bend) return -1;
    size_t slen;
    int sid = buf[spos];
    if (sid == scheme_geo) {
      slen = 20;
    } else if (sid == scheme_custom) {
      if (spos + 3 > bend) return -1;
      uint16_t cn;
      std::memcpy(&cn, buf + spos + 1, 2);
      slen = 3 + static_cast<size_t>(cn) * 8;
    } else {
      return -2;
    }
    if (spos + slen > bend) return -1;
    std::string_view sv(reinterpret_cast<const char*>(buf + spos), slen);
    auto it = smap.find(sv);
    int32_t suid;
    if (it == smap.end()) {
      if (static_cast<size_t>(ns) >= cap_schemes) return -5;
      suid = static_cast<int32_t>(ns);
      smap.emplace(sv, suid);
      uscheme_off[ns] = static_cast<int64_t>(spos);
      uscheme_len[ns] = static_cast<int64_t>(slen);
      ++ns;
    } else {
      suid = it->second;
    }
    scheme_idx[i] = suid;
    nb_out[i] = nv;
    // nibble-unpack the zigzag deltas group-wise and fuse the cumsum
    int64_t* row = counts_out + i * hb_cap;
    size_t dpos = spos + slen;
    int64_t acc = 0;
    uint32_t emitted = 0;
    size_t ngroups = (static_cast<size_t>(nv) + 7) / 8;
    for (size_t g = 0; g < ngroups; ++g) {
      long long next = np_unpack(buf, bend, dpos, 8, tmp);
      if (next < 0) return -1;
      dpos = static_cast<size_t>(next);
      for (int k = 0; k < 8 && emitted < nv; ++k, ++emitted) {
        acc += zigzag_dec(tmp[k]);
        row[emitted] = acc;
      }
    }
    for (size_t k = nv; k < hb_cap; ++k) row[k] = acc;  // edge-pad
  }
  *n_schemes_out = ns;
  return static_cast<long long>(n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch ENCODE: the flush/downsample hot loop (reference:
// TimeSeriesPartition.encodeOneChunkset optimize() step, and the Spark
// downsampler's chunk re-encode, DownsamplerMain.scala:43).  One call
// encodes a whole batch of vectors — per-vector Python overhead was the
// dominant cost of small downsample chunks.
//
// Wire constants mirror filodb_tpu/codecs/wire.py (DELTA2=1,
// CONST_LONG=2, DELTA2_DOUBLE=16, XOR_DOUBLE=17, RAW_DOUBLE=18,
// CONST_DOUBLE=19, GORILLA_DOUBLE=20); the byte-identity tests against the Python
// encoders guard the pairing.

namespace {

constexpr uint8_t kWireDelta2 = 1;
constexpr uint8_t kWireConstLong = 2;
constexpr uint8_t kWireDelta2Double = 16;
constexpr uint8_t kWireXorDouble = 17;
constexpr uint8_t kWireRawDouble = 18;
constexpr uint8_t kWireConstDouble = 19;
constexpr uint8_t kWireGorillaDouble = 20;

// LSB-first bit writer over a pre-zeroed region (matches
// np.packbits(bitorder="little")).
struct BitWriter {
  uint8_t* out;
  size_t bitpos = 0;
  void put(uint64_t bits, int nbits) {
    for (int i = 0; i < nbits; ++i, ++bitpos) {
      if ((bits >> i) & 1)
        out[bitpos >> 3] |= static_cast<uint8_t>(1u << (bitpos & 7));
    }
  }
};

inline void put_u32(uint8_t* out, uint32_t v) { std::memcpy(out, &v, 4); }
inline void put_i64(uint8_t* out, int64_t v) { std::memcpy(out, &v, 8); }

// DELTA2/CONST_LONG encode of one int64 vector.  scratch holds n u64.
long long ll_encode_one(const int64_t* v, size_t n, uint8_t* out,
                        size_t cap, uint64_t* scratch) {
  if (cap < 21) return -1;
  if (n == 0) {
    out[0] = kWireConstLong;
    std::memset(out + 1, 0, 20);
    return 21;
  }
  int64_t base = v[0];
  int64_t slope = 0;
  if (n > 1) {
    // divide at LONG DOUBLE precision (x86: 64-bit mantissa, holding
    // any int64-pair span exactly) so the quotient matches Python's
    // correctly-rounded int/int true division; a double-precision
    // intermediate would double-round spans beyond 2^53 and break the
    // byte pairing with the Python encoder
    long double diff = static_cast<long double>(
        static_cast<__int128>(v[n - 1]) - static_cast<__int128>(base));
    double d = static_cast<double>(diff /
                                   static_cast<long double>(n - 1));
    d = std::nearbyint(d);  // round-half-even, like Python round()
    // wrap into int64 modulo 2^64, like the Python encoder — residual
    // arithmetic is modular, so wraparound round-trips exactly; a clamp
    // would lose the modular compression on full-span vectors.  |d| <
    // 2^64 always (an int64 pair spans at most 2^64-1), so ONE exact
    // 2^64 shift suffices; in-range values must cast directly (going
    // through fmod/addition at 2^64 scale would quantize them)
    if (d >= 9223372036854775808.0) d -= 18446744073709551616.0;
    else if (d < -9223372036854775808.0) d += 18446744073709551616.0;
    slope = static_cast<int64_t>(d);
  }
  const uint64_t ubase = static_cast<uint64_t>(base);
  const uint64_t uslope = static_cast<uint64_t>(slope);
  bool all_zero = true;
  uint64_t pred = ubase;
  for (size_t i = 0; i < n; ++i, pred += uslope) {
    uint64_t resid = static_cast<uint64_t>(v[i]) - pred;
    scratch[i] = zigzag_enc(static_cast<int64_t>(resid));
    all_zero &= (resid == 0);
  }
  if (all_zero) {
    out[0] = kWireConstLong;
    put_u32(out + 1, static_cast<uint32_t>(n));
    put_i64(out + 5, base);
    put_i64(out + 13, slope);
    return 21;
  }
  if (cap < 21 + np_max_packed(n)) return -1;
  out[0] = kWireDelta2;
  put_u32(out + 1, static_cast<uint32_t>(n));
  put_i64(out + 5, base);
  put_i64(out + 13, slope);
  long long w = np_pack(scratch, n, out + 21);
  return 21 + w;
}

// Full double-selector encode of one f64 vector.  scratch holds n u64,
// packbuf holds np_max_packed(n).
long long dbl_encode_one(const double* v, size_t n, uint8_t* out,
                         size_t cap, uint64_t* scratch, uint8_t* packbuf) {
  // integral doubles -> nested DELTA2 long encoding
  bool integral = n > 0;
  for (size_t i = 0; i < n && integral; ++i) {
    double x = v[i];
    if (!std::isfinite(x) || !(std::fabs(x) < 9223372036854775808.0) ||
        (x == 0.0 && std::signbit(x))) {
      integral = false;
      break;
    }
    int64_t iv = static_cast<int64_t>(x);
    if (static_cast<double>(iv) != x) integral = false;
  }
  if (integral) {
    if (cap < 1) return -1;
    out[0] = kWireDelta2Double;
    // reuse packbuf's tail as the int64 conversion buffer? sizes differ;
    // convert into scratch reinterpreted as int64
    std::vector<int64_t> iv(n);
    for (size_t i = 0; i < n; ++i) iv[i] = static_cast<int64_t>(v[i]);
    long long w = ll_encode_one(iv.data(), n, out + 1, cap - 1, scratch);
    return w < 0 ? -1 : 1 + w;
  }
  // constant (value equality, matching the Python np.all(v[0] == v))
  if (n > 0 && !std::isnan(v[0])) {
    bool all_eq = true;
    for (size_t i = 1; i < n && all_eq; ++i) all_eq = (v[i] == v[0]);
    if (all_eq) {
      if (cap < 13) return -1;
      out[0] = kWireConstDouble;
      put_u32(out + 1, static_cast<uint32_t>(n));
      std::memcpy(out + 5, &v[0], 8);
      return 13;
    }
  }
  // XOR residual chain
  uint64_t prev = 0;
  size_t nnz = 0;
  size_t sig_total = 0;
  for (size_t i = 0; i < n; ++i) {
    uint64_t bits;
    std::memcpy(&bits, &v[i], 8);
    uint64_t r = bits ^ prev;
    prev = bits;
    scratch[i] = r;
    if (r) {
      ++nnz;
      sig_total += 64 - clz64(r) - ctz64(r);
    }
  }
  // closed-form gorilla size vs nibblepack size (same rule as Python)
  size_t gorilla_bytes = 8 + (n + 7) / 8 + (nnz * 12 + 7) / 8
                         + (sig_total + 7) / 8;
  long long packed = np_pack(scratch, n, packbuf);
  // compression must pay for itself: unless the best bit-packed form
  // saves >=10% over raw, emit RAW_DOUBLE (one memcpy to decode).
  // Integer rule identical to the Python encoder (doublecodec.encode).
  size_t best = gorilla_bytes < static_cast<size_t>(packed) + 4
                    ? gorilla_bytes
                    : static_cast<size_t>(packed) + 4;
  size_t raw_bytes = 4 + 8 * n;
  if (best * 10 > raw_bytes * 9) {
    size_t total = 5 + 8 * n;
    if (cap < total) return -1;
    out[0] = kWireRawDouble;
    put_u32(out + 1, static_cast<uint32_t>(n));
    std::memcpy(out + 5, v, 8 * n);
    return static_cast<long long>(total);
  }
  if (gorilla_bytes <= static_cast<size_t>(packed) + 4) {
    size_t total = 1 + gorilla_bytes;
    if (cap < total) return -1;
    std::memset(out, 0, total);
    out[0] = kWireGorillaDouble;
    put_u32(out + 1, static_cast<uint32_t>(n));
    put_u32(out + 5, static_cast<uint32_t>(nnz));
    uint8_t* bitmap = out + 9;
    uint8_t* hdrs = bitmap + (n + 7) / 8;
    uint8_t* sig = hdrs + (nnz * 12 + 7) / 8;
    BitWriter hw{hdrs};
    BitWriter sw{sig};
    for (size_t i = 0; i < n; ++i) {
      uint64_t r = scratch[i];
      if (!r) continue;
      bitmap[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
      int clz = clz64(r);
      int ctz = ctz64(r);
      int len = 64 - clz - ctz;
      hw.put((static_cast<uint64_t>(clz) << 6) |
                 static_cast<uint64_t>(len - 1),
             12);
      sw.put(r >> ctz, len);
    }
    return static_cast<long long>(total);
  }
  size_t total = 5 + static_cast<size_t>(packed);
  if (cap < total) return -1;
  out[0] = kWireXorDouble;
  put_u32(out + 1, static_cast<uint32_t>(n));
  std::memcpy(out + 5, packbuf, static_cast<size_t>(packed));
  return static_cast<long long>(total);
}

// Decode ONE double vector of any double wire form into o[0..n).
// Returns n or -1 on corruption.  iscratch is reused across calls.
long long dbl_decode_one(const uint8_t* b, size_t blen, double* o,
                         size_t n, std::vector<int64_t>& iscratch) {
  if (blen < 1) return -1;
  uint8_t wire = b[0];
  if (wire == kWireDelta2Double) {
    if (iscratch.size() < n) iscratch.resize(n);
    long long got = dd_decode(b + 1, blen - 1, kWireConstLong,
                              kWireDelta2, iscratch.data(), n);
    if (got < 0 || static_cast<size_t>(got) != n) return -1;
    for (size_t i = 0; i < n; ++i)
      o[i] = static_cast<double>(iscratch[i]);
  } else if (wire == kWireConstDouble) {
    if (blen < 13) return -1;
    uint32_t nn;
    std::memcpy(&nn, b + 1, 4);
    if (nn != n) return -1;
    double v;
    std::memcpy(&v, b + 5, 8);
    for (size_t i = 0; i < n; ++i) o[i] = v;
  } else if (wire == kWireXorDouble) {
    uint32_t nn;
    if (blen < 5) return -1;
    std::memcpy(&nn, b + 1, 4);
    if (nn != n) return -1;
    if (xor_unpack(b, blen, 5, n, o) < 0) return -1;
  } else if (wire == kWireRawDouble) {
    uint32_t nn;
    if (blen < 5 + 8 * n) return -1;
    std::memcpy(&nn, b + 1, 4);
    if (nn != n) return -1;
    std::memcpy(o, b + 5, 8 * n);
  } else if (wire == kWireGorillaDouble) {
    if (blen < 9) return -1;
    uint32_t nn, nnz;
    std::memcpy(&nn, b + 1, 4);
    std::memcpy(&nnz, b + 5, 4);
    if (nn != n) return -1;
    size_t bm = 9;
    size_t hdrs = bm + (n + 7) / 8;
    size_t sig = hdrs + (static_cast<size_t>(nnz) * 12 + 7) / 8;
    if (sig > blen) return -1;
    size_t hbit = 0, sbit = 0;
    auto read_bits = [&](const uint8_t* p, size_t& bitpos,
                         int nbits) -> uint64_t {
      uint64_t v = 0;
      for (int i = 0; i < nbits; ++i, ++bitpos)
        v |= static_cast<uint64_t>((p[bitpos >> 3] >> (bitpos & 7)) & 1)
             << i;
      return v;
    };
    uint64_t acc = 0;
    size_t sig_end_bits = (blen - sig) * 8;
    size_t hdr_end_bits = (sig - hdrs) * 8;
    for (size_t i = 0; i < n; ++i) {
      if ((b[bm + (i >> 3)] >> (i & 7)) & 1) {
        // a corrupt bitmap whose popcount exceeds nnz must fail,
        // never walk header reads past the buffer
        if (hbit + 12 > hdr_end_bits) return -1;
        uint64_t hdr = read_bits(b + hdrs, hbit, 12);
        int clz = static_cast<int>(hdr >> 6);
        int len = static_cast<int>(hdr & 63) + 1;
        int ctz = 64 - clz - len;
        if (ctz < 0 || sbit + static_cast<size_t>(len) > sig_end_bits)
          return -1;
        acc ^= read_bits(b + sig, sbit, len) << ctz;
      }
      std::memcpy(&o[i], &acc, 8);
    }
  } else {
    return -1;
  }
  return static_cast<long long>(n);
}

}  // namespace

extern "C" {

// Decode nvec DELTA2/CONST_LONG blobs (each a full encoding incl. the
// wire byte) into one contiguous int64 output.  offs: nvec+1 prefix
// byte offsets into buf; out_offs: nvec+1 prefix VALUE offsets.
// Returns total values or -1 on corruption.
long long ll_decode_batch(const uint8_t* buf, const int64_t* offs,
                          int64_t nvec, int64_t* out,
                          const int64_t* out_offs) {
  for (int64_t k = 0; k < nvec; ++k) {
    size_t expect = static_cast<size_t>(out_offs[k + 1] - out_offs[k]);
    long long got = dd_decode(buf + offs[k],
                              static_cast<size_t>(offs[k + 1] - offs[k]),
                              kWireConstLong, kWireDelta2,
                              out + out_offs[k], expect);
    // a blob whose header count disagrees with the caller-expected
    // count must fail loudly, never serve uninitialized memory
    if (got < 0 || static_cast<size_t>(got) != expect) return -1;
  }
  int64_t total = out_offs[nvec];
  return total;
}

// Decode nvec double blobs (any double wire form) into one contiguous
// f64 output.  Same offset contract as ll_decode_batch.
long long dbl_decode_batch(const uint8_t* buf, const int64_t* offs,
                           int64_t nvec, double* out,
                           const int64_t* out_offs) {
  std::vector<int64_t> iscratch;
  for (int64_t k = 0; k < nvec; ++k) {
    if (dbl_decode_one(buf + offs[k],
                       static_cast<size_t>(offs[k + 1] - offs[k]),
                       out + out_offs[k],
                       static_cast<size_t>(out_offs[k + 1] - out_offs[k]),
                       iscratch) < 0)
      return -1;
  }
  return out_offs[nvec];
}

// Decode data-column `col` of nrows FRAMED ColumnStore row blobs (u16
// vector count, then (u32 byte length, encoded bytes) per vector — the
// pack_vectors layout, store/persistence.py) into caller-placed output
// spans.  This is the ODP bulk page-in hot path: framing walk + codec
// decode in one C pass, replacing a per-row Python unpack + per-chunk
// decode object dance (reference: DemandPagedChunkStore.scala:34 pages
// raw Cassandra chunks straight into block memory).  is_dbl selects the
// double-wire decoder (out is double*), otherwise DELTA2/CONST_LONG
// (out is int64_t*).  Row k writes counts[k] values at out_starts[k] —
// arbitrary placement, so the caller can decode STRAIGHT INTO a padded
// [S, R] query batch and skip the concat/copy assembly entirely.
// Returns total values or -1 on corruption.
long long page_decode_column(const uint8_t* buf, const int64_t* offs,
                             int64_t nrows, int64_t col, int is_dbl,
                             void* out, const int64_t* out_starts,
                             const int64_t* counts) {
  std::vector<int64_t> iscratch;
  long long total = 0;
  for (int64_t k = 0; k < nrows; ++k) {
    const uint8_t* b = buf + offs[k];
    size_t blen = static_cast<size_t>(offs[k + 1] - offs[k]);
    if (blen < 2) return -1;
    uint16_t nvec;
    std::memcpy(&nvec, b, 2);
    if (col < 0 || col >= static_cast<int64_t>(nvec)) return -1;
    size_t pos = 2;
    uint32_t ln = 0;
    for (int64_t j = 0; j <= col; ++j) {
      if (pos + 4 > blen) return -1;
      std::memcpy(&ln, b + pos, 4);
      pos += 4;
      if (j < col) pos += ln;
    }
    if (pos + ln > blen) return -1;
    size_t n = static_cast<size_t>(counts[k]);
    total += counts[k];
    if (is_dbl) {
      if (dbl_decode_one(b + pos, ln,
                         static_cast<double*>(out) + out_starts[k], n,
                         iscratch) < 0)
        return -1;
    } else {
      long long got = dd_decode(b + pos, ln, kWireConstLong, kWireDelta2,
                                static_cast<int64_t*>(out) + out_starts[k],
                                n);
      if (got < 0 || static_cast<size_t>(got) != n) return -1;
    }
  }
  return total;
}

// Encode nvec int64 vectors (DELTA2/CONST_LONG per vector).  starts is
// an nvec+1 prefix-offset array into vals; blob_offs (nvec+1) receives
// output prefix offsets.  Returns total bytes or -1 on overflow.
long long ll_encode_batch(const int64_t* vals, const int64_t* starts,
                          int64_t nvec, uint8_t* out, int64_t cap,
                          int64_t* blob_offs) {
  std::vector<uint64_t> scratch;
  int64_t pos = 0;
  blob_offs[0] = 0;
  for (int64_t k = 0; k < nvec; ++k) {
    size_t n = static_cast<size_t>(starts[k + 1] - starts[k]);
    if (scratch.size() < n) scratch.resize(n);
    long long w = ll_encode_one(vals + starts[k], n, out + pos,
                                static_cast<size_t>(cap - pos),
                                scratch.data());
    if (w < 0) return -1;
    pos += w;
    blob_offs[k + 1] = pos;
  }
  return pos;
}

// Encode nvec float64 vectors with the full double selector.
long long dbl_encode_batch(const double* vals, const int64_t* starts,
                           int64_t nvec, uint8_t* out, int64_t cap,
                           int64_t* blob_offs) {
  std::vector<uint64_t> scratch;
  std::vector<uint8_t> packbuf;
  int64_t pos = 0;
  blob_offs[0] = 0;
  for (int64_t k = 0; k < nvec; ++k) {
    size_t n = static_cast<size_t>(starts[k + 1] - starts[k]);
    if (scratch.size() < n) scratch.resize(n);
    size_t need = np_max_packed(n);
    if (packbuf.size() < need) packbuf.resize(need);
    long long w = dbl_encode_one(vals + starts[k], n, out + pos,
                                 static_cast<size_t>(cap - pos),
                                 scratch.data(), packbuf.data());
    if (w < 0) return -1;
    pos += w;
    blob_offs[k + 1] = pos;
  }
  return pos;
}

// Influx line-protocol batch scan: one pass over the payload finds each
// line's head span, field '=', float value, and integer ns timestamp
// (the gateway's columnar hot path; the Python layer keeps head dedup +
// memoization).  Caller pre-rejects escapes/quotes/comments and
// guarantees a trailing '\n'.  Writes per-line starts/sp1/eq1 offsets,
// values, and timestamps; returns the line count, or -1 when ANY line
// needs the general parser (the fast path is never wrong, only absent).
long long influx_parse_batch(const uint8_t* buf, int64_t n,
                             int64_t max_lines, int64_t* starts,
                             int64_t* sp1, int64_t* eq1, double* values,
                             long long* ts_ns) {
  int64_t nl = 0;
  int64_t i = 0;
  while (i < n) {
    const uint8_t* p =
        static_cast<const uint8_t*>(memchr(buf + i, '\n', n - i));
    if (!p) break;
    int64_t j = p - buf;
    int64_t end = j;
    if (end > i && buf[end - 1] == '\r') --end;
    if (end == i) { i = j + 1; continue; }           // blank line
    if (nl >= max_lines) return -1;
    if (buf[i] == ' ' || buf[end - 1] == ' ') return -1;
    const uint8_t* s1 =
        static_cast<const uint8_t*>(memchr(buf + i, ' ', end - i));
    if (!s1) return -1;                              // no fields
    int64_t a1 = s1 - buf;
    const uint8_t* s2 = static_cast<const uint8_t*>(
        memchr(buf + a1 + 1, ' ', end - a1 - 1));
    if (!s2) return -1;                              // no timestamp
    int64_t a2 = s2 - buf;
    if (memchr(buf + a2 + 1, ' ', end - a2 - 1)) return -1;
    const uint8_t* e1 = static_cast<const uint8_t*>(
        memchr(buf + a1 + 1, '=', a2 - a1 - 1));
    if (!e1) return -1;                              // field without '='
    int64_t b1 = e1 - buf;
    if (b1 == a1 + 1) return -1;                     // empty field name
    if (memchr(buf + b1 + 1, '=', a2 - b1 - 1)) return -1;
    if (memchr(buf + a1 + 1, ',', a2 - a1 - 1)) return -1;  // multi-field
    if (b1 + 1 >= a2) return -1;                     // empty value
    // strtod is laxer than Python float(): it accepts C99 hex floats
    // and "nan(...)" forms.  Reject those up front so acceptance never
    // depends on whether the native library is loaded ("the fast path
    // is never wrong, only absent").
    {
      int64_t v0 = b1 + 1;
      if (buf[v0] == '+' || buf[v0] == '-') ++v0;
      if (v0 + 1 < a2 && buf[v0] == '0' &&
          (buf[v0 + 1] == 'x' || buf[v0 + 1] == 'X'))
        return -1;
      if (memchr(buf + b1 + 1, '(', a2 - b1 - 1)) return -1;
    }
    char* endp = nullptr;
    double v = strtod(reinterpret_cast<const char*>(buf) + b1 + 1, &endp);
    if (endp != reinterpret_cast<const char*>(buf) + a2)
      return -1;          // int/bool/string field value
    if (a2 + 1 >= end || end - (a2 + 1) > 19) return -1;
    unsigned long long t = 0;
    for (int64_t k = a2 + 1; k < end; ++k) {
      uint8_t c = buf[k];
      if (c < '0' || c > '9') return -1;             // sign/garbage ts
      t = t * 10ULL + (c - '0');
    }
    if (t > 9223372036854775807ULL) return -1;
    starts[nl] = i;
    sp1[nl] = a1;
    eq1[nl] = b1;
    values[nl] = v;
    ts_ns[nl] = static_cast<long long>(t);
    ++nl;
    i = j + 1;
  }
  return nl;
}

// Concatenate per-line [starts[k], ends[k]) byte ranges into `out`
// (caller sizes it as sum(ends-starts)).  Replaces the numpy
// arange+repeat flat-index gather on the gateway parse hot path.
// Spans are validated against buf_len (starts[k] >= 0, ends[k] <=
// buf_len) so a malformed span returns -1 instead of a silent
// out-of-bounds read — matching the len < 0 guard.
long long gather_ranges(const uint8_t* buf, int64_t buf_len,
                        const int64_t* starts, const int64_t* ends,
                        int64_t n, uint8_t* out) {
  int64_t pos = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t len = ends[k] - starts[k];
    if (len < 0 || starts[k] < 0 || ends[k] > buf_len) return -1;
    memcpy(out + pos, buf + starts[k], len);
    pos += len;
  }
  return pos;
}

// Per-line 2x64-bit positional head hashes (same formulation as the
// numpy reduceat path in gateway/influx.py: sum(byte * pow[rel]) per
// stream, stream 2 xor'd with the head length).  pow tables are
// caller-provided so Python and C stay bit-identical.  Spans are
// bounds-checked against buf_len like gather_ranges.
long long head_hash128(const uint8_t* buf, int64_t buf_len,
                       const int64_t* starts, const int64_t* ends,
                       int64_t n, const uint64_t* p1, const uint64_t* p2,
                       int64_t npow, uint64_t* h1, uint64_t* h2) {
  for (int64_t k = 0; k < n; ++k) {
    int64_t len = ends[k] - starts[k];
    if (len < 0 || len >= npow || starts[k] < 0 || ends[k] > buf_len)
      return -1;
    const uint8_t* p = buf + starts[k];
    uint64_t a = 0, b = 0;
    for (int64_t r = 0; r < len; ++r) {
      uint64_t c = p[r];
      a += c * p1[r];
      b += c * p2[r];
    }
    h1[k] = a;
    h2[k] = b ^ static_cast<uint64_t>(len);
  }
  return n;
}

// Hash-collision guard: every line's head bytes must equal its group
// representative's (rep[k] indexes into the same line arrays).
// Returns 1 when all match, 0 on any mismatch (caller falls back to
// the per-line parser), -1 on malformed spans (including spans outside
// [0, buf_len)).
long long verify_heads(const uint8_t* buf, int64_t buf_len,
                       const int64_t* starts, const int64_t* ends,
                       const int64_t* rep, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    int64_t len = ends[k] - starts[k];
    int64_t rk = rep[k];
    if (len < 0 || starts[k] < 0 || ends[k] > buf_len ||
        rk < 0 || rk >= n)
      return -1;
    if (ends[rk] - starts[rk] != len) return 0;
    if (starts[rk] < 0 || ends[rk] > buf_len) return -1;
    if (memcmp(buf + starts[k], buf + starts[rk],
               static_cast<size_t>(len)) != 0)
      return 0;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected 0x82F63B78) — the per-chunk checksum of
// the integrity subsystem (filodb_tpu/integrity/).  Hardware SSE4.2
// crc32 instruction when the CPU has it (~15 GB/s), slicing-by-8 table
// kernel otherwise (~1 GB/s): computed over the framed vectors blob at
// flush time and re-verified on every ODP page-in and bulk read-back.
// Bit-identical to the pure-Python fallback in integrity/__init__.py
// (standard CRC32C: crc32c("123456789") == 0xE3069283).

}  // extern "C" (internal CRC kernels are C++-linkage)

namespace {

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c_sw(const uint8_t* buf, long long n, uint32_t crc) {
  static const Crc32cTables tabs;  // magic-static init: thread-safe
  const uint32_t(*t)[256] = tabs.t;
  long long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo;
    std::memcpy(&lo, buf + i, 4);
    lo ^= crc;
    uint32_t hi;
    std::memcpy(&hi, buf + i + 4, 4);
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^
          t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; i < n; ++i) crc = (crc >> 8) ^ t[0][(crc ^ buf[i]) & 0xFF];
  return crc;
}

#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* buf, long long n, uint32_t crc0) {
  uint64_t crc = crc0;
  long long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    std::memcpy(&v, buf + i, 8);
    crc = __builtin_ia32_crc32di(crc, v);
  }
  uint32_t c = static_cast<uint32_t>(crc);
  for (; i < n; ++i) c = __builtin_ia32_crc32qi(c, buf[i]);
  return c;
}

bool crc32c_have_hw() {
  static const bool have = __builtin_cpu_supports("sse4.2");
  return have;
}
#else
uint32_t crc32c_hw(const uint8_t* buf, long long n, uint32_t c) {
  return crc32c_sw(buf, n, c);
}
bool crc32c_have_hw() { return false; }
#endif

inline uint32_t crc32c_run(const uint8_t* buf, long long n, uint32_t seed) {
  uint32_t crc = ~seed;
  crc = crc32c_have_hw() ? crc32c_hw(buf, n, crc) : crc32c_sw(buf, n, crc);
  return ~crc;
}

}  // namespace

extern "C" {

unsigned crc32c_buf(const uint8_t* buf, long long n, unsigned seed) {
  return crc32c_run(buf, n, seed);
}

}  // extern "C" (interleaved batch kernel below is C++-linkage)

namespace {

#if defined(__x86_64__) || defined(__i386__)
// Three independent blobs per iteration: the crc32 instruction has
// 3-cycle latency but 1/cycle throughput, so three interleaved streams
// run ~3x faster than one — and because the streams are SEPARATE blobs
// there is no polynomial-combine step at all.
__attribute__((target("sse4.2")))
void crc3_hw(const uint8_t* b0, const uint8_t* b1, const uint8_t* b2,
             int64_t l0, int64_t l1, int64_t l2, uint32_t* out) {
  uint64_t c0 = 0xFFFFFFFFu, c1 = 0xFFFFFFFFu, c2 = 0xFFFFFFFFu;
  int64_t m = l0 < l1 ? l0 : l1;
  if (l2 < m) m = l2;
  m &= ~int64_t(7);
  int64_t i = 0;
  for (; i < m; i += 8) {
    uint64_t a, b, c;
    std::memcpy(&a, b0 + i, 8);
    std::memcpy(&b, b1 + i, 8);
    std::memcpy(&c, b2 + i, 8);
    c0 = __builtin_ia32_crc32di(c0, a);
    c1 = __builtin_ia32_crc32di(c1, b);
    c2 = __builtin_ia32_crc32di(c2, c);
  }
  out[0] = ~crc32c_hw(b0 + i, l0 - i, static_cast<uint32_t>(c0));
  out[1] = ~crc32c_hw(b1 + i, l1 - i, static_cast<uint32_t>(c1));
  out[2] = ~crc32c_hw(b2 + i, l2 - i, static_cast<uint32_t>(c2));
}
#endif

}  // namespace

extern "C" {

// Batched per-blob verify for the store read-back hot path: ONE ctypes
// call for a whole page-in's rows, blobs passed as a pointer array (no
// Python-side join/copy).  ok[i]=1 when blob i's CRC32C equals
// expect[i]; a computed value of 0 maps to 1, matching
// integrity.chunk_crc's never-zero rule.  Returns the mismatch count.
long long crc32c_verify_batch(const uint8_t* const* blobs,
                              const int64_t* lens, int64_t n,
                              const uint32_t* expect, uint8_t* ok) {
  long long bad = 0;
  int64_t i = 0;
#if defined(__x86_64__) || defined(__i386__)
  if (crc32c_have_hw()) {
    uint32_t c3[3];
    for (; i + 3 <= n; i += 3) {
      crc3_hw(blobs[i], blobs[i + 1], blobs[i + 2],
              lens[i], lens[i + 1], lens[i + 2], c3);
      for (int k = 0; k < 3; ++k) {
        uint32_t c = c3[k] ? c3[k] : 1;
        ok[i + k] = (c == expect[i + k]);
        bad += ok[i + k] ? 0 : 1;
      }
    }
  }
#endif
  for (; i < n; ++i) {
    uint32_t c = crc32c_run(blobs[i], lens[i], 0);
    if (!c) c = 1;
    ok[i] = (c == expect[i]);
    bad += ok[i] ? 0 : 1;
  }
  return bad;
}

// Joined-span form of the batch verify: spans are the consecutive
// regions [offs[i], offs[i+1]) of one buffer — EXACTLY the frame the
// bulk page decoder already builds, so the ODP hot path verifies
// checksums on the decoder's own join with zero extra Python-side
// copies (see _BatchDecodeNative.page_decode).  expect[i]==0 means
// "no checksum recorded" (legacy row) and passes.  Returns the
// mismatch count.
long long crc32c_verify_spans(const uint8_t* buf, const int64_t* offs,
                              int64_t n, const uint32_t* expect,
                              uint8_t* ok) {
  long long bad = 0;
  int64_t i = 0;
#if defined(__x86_64__) || defined(__i386__)
  if (crc32c_have_hw()) {
    uint32_t c3[3];
    for (; i + 3 <= n; i += 3) {
      crc3_hw(buf + offs[i], buf + offs[i + 1], buf + offs[i + 2],
              offs[i + 1] - offs[i], offs[i + 2] - offs[i + 1],
              offs[i + 3] - offs[i + 2], c3);
      for (int k = 0; k < 3; ++k) {
        uint32_t c = c3[k] ? c3[k] : 1;
        ok[i + k] = !expect[i + k] || c == expect[i + k];
        bad += ok[i + k] ? 0 : 1;
      }
    }
  }
#endif
  for (; i < n; ++i) {
    uint32_t c = crc32c_run(buf + offs[i], offs[i + 1] - offs[i], 0);
    if (!c) c = 1;
    ok[i] = !expect[i] || c == expect[i];
    bad += ok[i] ? 0 : 1;
  }
  return bad;
}

}  // extern "C"
