// w2v2io — native data-plane for the TPU wav2vec2 framework.
//
// The reference delegates all IO to the TensorFlow runtime (tf.data /
// tf.io.TFRecordWriter / tf.audio.decode_wav + libsndfile via the
// `soundfile` package; see /root/reference/src/data_utils.py and
// make_tfrecords.py).  This library replaces that stack with a dependency-
// free C++ implementation exposed over a C ABI for ctypes:
//
//   * TFRecord framing (length + masked CRC32C) — wire-compatible with
//     tf.io.TFRecordWriter / tf.data.TFRecordDataset;
//   * the tf.train.Example + TensorProto protobuf subset used by the
//     reference's serialization (`make_tfrecords.py:10-23`): features
//     "speech" (BytesList[serialized float32 TensorProto]) and "label"
//     (BytesList[serialized int32 TensorProto]);
//   * RIFF/WAVE PCM16 decode (tf.audio.decode_wav semantics: float32 in
//     [-1, 1), scale 1/32768);
//   * a full FLAC decoder (constant / verbatim / fixed / LPC subframes,
//     Rice residuals incl. escape codes, L/S R/S M/S stereo decorrelation)
//     — LibriSpeech ships as 16-bit mono FLAC and this image has no FLAC
//     library of any kind.
//
// Build: `make` in this directory (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven; TFRecord masks it as
// ((crc >> 15 | crc << 17) + 0xa282ead8).
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[256];
static bool crc_init_done = false;

static void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[i] = c;
  }
  crc_init_done = true;
}

static uint32_t crc32c(const uint8_t* data, size_t n) {
  crc_init();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; i++) c = kCrcTable[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

static uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// Minimal protobuf wire helpers.
// ---------------------------------------------------------------------------

static void put_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back((char)((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out.push_back((char)v);
}

static void put_tag(std::string& out, int field, int wire) {
  put_varint(out, (uint64_t)(field << 3 | wire));
}

static void put_bytes_field(std::string& out, int field, const std::string& s) {
  put_tag(out, field, 2);
  put_varint(out, s.size());
  out += s;
}

struct ProtoReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  // returns field number, sets wire type; 0 on end/error
  int next(int* wire) {
    if (p >= end || !ok) return 0;
    uint64_t tag = varint();
    *wire = (int)(tag & 7);
    return (int)(tag >> 3);
  }

  bool skip(int wire) {
    switch (wire) {
      case 0: varint(); return ok;
      case 1: if (end - p < 8) return ok = false; p += 8; return true;
      case 2: {
        uint64_t n = varint();
        if (!ok || (uint64_t)(end - p) < n) return ok = false;
        p += n;
        return true;
      }
      case 5: if (end - p < 4) return ok = false; p += 4; return true;
      default: return ok = false;
    }
  }

  bool bytes(const uint8_t** data, size_t* n) {
    uint64_t len = varint();
    if (!ok || (uint64_t)(end - p) < len) { ok = false; return false; }
    *data = p;
    *n = (size_t)len;
    p += len;
    return true;
  }
};

// ---------------------------------------------------------------------------
// TensorProto subset: dtype (field 1, varint), tensor_shape (field 2, msg:
// repeated dim (field 2, msg: size field 1 varint)), tensor_content
// (field 4, bytes).  Matches tf.io.serialize_tensor output for dense 1-D
// numeric tensors.
// ---------------------------------------------------------------------------

enum { DT_FLOAT = 1, DT_INT32 = 3 };

static std::string encode_tensor_1d(const void* data, int64_t n, int dtype,
                                    size_t elem_size) {
  std::string shape_dim, shape, out;
  put_tag(shape_dim, 1, 0);  // TensorShapeProto.Dim.size
  put_varint(shape_dim, (uint64_t)n);
  put_bytes_field(shape, 2, shape_dim);  // TensorShapeProto.dim

  put_tag(out, 1, 0);  // dtype
  put_varint(out, (uint64_t)dtype);
  put_bytes_field(out, 2, shape);  // tensor_shape
  std::string content((const char*)data, n * elem_size);
  put_bytes_field(out, 4, content);  // tensor_content
  return out;
}

// Parse 1-D TensorProto; verifies dtype; returns heap buffer.
// tf.io.serialize_tensor uses tensor_content for n>0; small tensors may use
// the typed repeated fields (float_val field 5, int_val field 6) — handle
// both.
static bool decode_tensor_1d(const uint8_t* buf, size_t len, int want_dtype,
                             std::string* out_content) {
  ProtoReader r{buf, buf + len};
  int dtype = -1;
  std::string typed;  // from float_val/int_val fallback
  out_content->clear();
  int wire;
  while (int field = r.next(&wire)) {
    if (field == 1 && wire == 0) {
      dtype = (int)r.varint();
    } else if (field == 4 && wire == 2) {
      const uint8_t* d; size_t n;
      if (!r.bytes(&d, &n)) return false;
      out_content->assign((const char*)d, n);
    } else if (field == 5 && wire == 5 && want_dtype == DT_FLOAT) {
      if (r.end - r.p < 4) return false;
      typed.append((const char*)r.p, 4);
      r.p += 4;
    } else if (field == 5 && wire == 2 && want_dtype == DT_FLOAT) {
      const uint8_t* d; size_t n;
      if (!r.bytes(&d, &n)) return false;
      typed.append((const char*)d, n);
    } else if (field == 6 && want_dtype == DT_INT32) {
      if (wire == 0) {
        uint64_t v = r.varint();
        int32_t iv = (int32_t)v;
        typed.append((const char*)&iv, 4);
      } else if (wire == 2) {  // packed varints
        const uint8_t* d; size_t n;
        if (!r.bytes(&d, &n)) return false;
        ProtoReader rr{d, d + n};
        while (rr.p < rr.end && rr.ok) {
          int32_t iv = (int32_t)rr.varint();
          typed.append((const char*)&iv, 4);
        }
        if (!rr.ok) return false;
      } else if (!r.skip(wire)) return false;
    } else {
      if (!r.skip(wire)) return false;
    }
  }
  if (!r.ok || dtype != want_dtype) return false;
  if (out_content->empty()) *out_content = typed;
  return true;
}

// ---------------------------------------------------------------------------
// tf.train.Example subset.
// Example: features (field 1, msg Features)
// Features: feature (field 1, map<string, Feature> -> msg: key field 1,
//           value field 2 (msg Feature))
// Feature: bytes_list (field 1, msg BytesList: value field 1, bytes)
// ---------------------------------------------------------------------------

static std::string encode_example(const float* speech, int64_t slen,
                                  const int32_t* label, int64_t llen) {
  std::string speech_tp = encode_tensor_1d(speech, slen, DT_FLOAT, 4);
  std::string label_tp = encode_tensor_1d(label, llen, DT_INT32, 4);

  auto feature_entry = [](const char* key, const std::string& tensor_bytes) {
    std::string bytes_list, feature, entry;
    put_bytes_field(bytes_list, 1, tensor_bytes);  // BytesList.value
    put_bytes_field(feature, 1, bytes_list);       // Feature.bytes_list
    std::string k(key);
    put_bytes_field(entry, 1, k);        // map key
    put_bytes_field(entry, 2, feature);  // map value
    return entry;
  };

  std::string features;
  put_bytes_field(features, 1, feature_entry("label", label_tp));
  put_bytes_field(features, 1, feature_entry("speech", speech_tp));
  std::string example;
  put_bytes_field(example, 1, features);
  return example;
}

// extract feature[key] -> first BytesList entry
static bool example_get_bytes(const uint8_t* buf, size_t len, const char* key,
                              const uint8_t** out, size_t* out_len) {
  ProtoReader ex{buf, buf + len};
  int wire;
  while (int field = ex.next(&wire)) {
    if (field == 1 && wire == 2) {  // Features
      const uint8_t* fd; size_t fn;
      if (!ex.bytes(&fd, &fn)) return false;
      ProtoReader feats{fd, fd + fn};
      while (int f2 = feats.next(&wire)) {
        if (f2 == 1 && wire == 2) {  // map entry
          const uint8_t* ed; size_t en;
          if (!feats.bytes(&ed, &en)) return false;
          ProtoReader entry{ed, ed + en};
          const uint8_t* kd = nullptr; size_t kn = 0;
          const uint8_t* vd = nullptr; size_t vn = 0;
          while (int f3 = entry.next(&wire)) {
            if (f3 == 1 && wire == 2) { if (!entry.bytes(&kd, &kn)) return false; }
            else if (f3 == 2 && wire == 2) { if (!entry.bytes(&vd, &vn)) return false; }
            else if (!entry.skip(wire)) return false;
          }
          if (!entry.ok || !kd) return false;
          if (kn == strlen(key) && memcmp(kd, key, kn) == 0 && vd) {
            ProtoReader feat{vd, vd + vn};
            while (int f4 = feat.next(&wire)) {
              if (f4 == 1 && wire == 2) {  // BytesList
                const uint8_t* bd; size_t bn;
                if (!feat.bytes(&bd, &bn)) return false;
                ProtoReader bl{bd, bd + bn};
                while (int f5 = bl.next(&wire)) {
                  if (f5 == 1 && wire == 2) return bl.bytes(out, out_len);
                  if (!bl.skip(wire)) return false;
                }
                return false;
              }
              if (!feat.skip(wire)) return false;
            }
            return false;
          }
        } else if (!feats.skip(wire)) return false;
      }
    } else if (!ex.skip(wire)) return false;
  }
  return false;
}

// ---------------------------------------------------------------------------
// TFRecord framing
// ---------------------------------------------------------------------------

struct TFRecordWriter {
  FILE* f;
};

struct TFRecordReader {
  FILE* f;
  std::vector<float> speech;
  std::vector<int32_t> label;
};

extern "C" {

void* w2v2_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  return new TFRecordWriter{f};
}

// Writes one record; returns 0 on success.
int w2v2_writer_write(void* handle, const float* speech, int64_t slen,
                      const int32_t* label, int64_t llen) {
  auto* w = (TFRecordWriter*)handle;
  std::string payload = encode_example(speech, slen, label, llen);
  uint64_t n = payload.size();
  uint8_t len_bytes[8];
  memcpy(len_bytes, &n, 8);  // little-endian on all supported targets
  uint32_t len_crc = masked_crc(len_bytes, 8);
  uint32_t data_crc = masked_crc((const uint8_t*)payload.data(), payload.size());
  if (fwrite(len_bytes, 1, 8, w->f) != 8) return 1;
  if (fwrite(&len_crc, 1, 4, w->f) != 4) return 1;
  if (fwrite(payload.data(), 1, payload.size(), w->f) != payload.size()) return 1;
  if (fwrite(&data_crc, 1, 4, w->f) != 4) return 1;
  return 0;
}

void w2v2_writer_close(void* handle) {
  auto* w = (TFRecordWriter*)handle;
  fclose(w->f);
  delete w;
}

void* w2v2_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  return new TFRecordReader{f, {}, {}};
}

// TFRecord reader over an in-memory buffer (the remote-storage path: the
// Python side fetches gs://... bytes via fsspec and parses them here).
// The caller's buffer must outlive the reader; callers pass len >= 1.
void* w2v2_reader_open_buffer(const void* data, int64_t len) {
  FILE* f = fmemopen(const_cast<void*>(data), (size_t)len, "rb");
  if (!f) return nullptr;
  return new TFRecordReader{f, {}, {}};
}

// Reads the next record.  Returns 1 on success, 0 on EOF, -1 on corruption.
// Pointers remain valid until the next call / close.
int w2v2_reader_next(void* handle, const float** speech, int64_t* slen,
                     const int32_t** label, int64_t* llen) try {
  auto* r = (TFRecordReader*)handle;
  uint8_t len_bytes[8];
  size_t got = fread(len_bytes, 1, 8, r->f);
  if (got == 0) return 0;  // clean EOF
  if (got != 8) return -1;
  uint32_t len_crc;
  if (fread(&len_crc, 1, 4, r->f) != 4) return -1;
  if (masked_crc(len_bytes, 8) != len_crc) return -1;
  uint64_t n;
  memcpy(&n, len_bytes, 8);
  if (n > (1ull << 34)) return -1;  // sanity: 16 GiB record cap
  std::vector<uint8_t> payload(n);
  if (fread(payload.data(), 1, n, r->f) != n) return -1;
  uint32_t data_crc;
  if (fread(&data_crc, 1, 4, r->f) != 4) return -1;
  if (masked_crc(payload.data(), n) != data_crc) return -1;

  const uint8_t* tp; size_t tp_len;
  std::string content;
  if (!example_get_bytes(payload.data(), n, "speech", &tp, &tp_len)) return -1;
  if (!decode_tensor_1d(tp, tp_len, DT_FLOAT, &content)) return -1;
  r->speech.resize(content.size() / 4);
  memcpy(r->speech.data(), content.data(), content.size());

  if (!example_get_bytes(payload.data(), n, "label", &tp, &tp_len)) return -1;
  if (!decode_tensor_1d(tp, tp_len, DT_INT32, &content)) return -1;
  r->label.resize(content.size() / 4);
  memcpy(r->label.data(), content.data(), content.size());

  *speech = r->speech.data();
  *slen = (int64_t)r->speech.size();
  *label = r->label.data();
  *llen = (int64_t)r->label.size();
  return 1;
} catch (...) {
  return -1;  // a CRC-valid crafted length can still exceed memory
}

void w2v2_reader_close(void* handle) {
  auto* r = (TFRecordReader*)handle;
  fclose(r->f);
  delete r;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WAV (RIFF PCM) decode — semantics of tf.audio.decode_wav: 16-bit PCM to
// float32 via x / 32768.  Returns channel-averaged mono when squeeze=1 keeps
// shape handling trivial for the Python side; here we return the first
// channel (TIMIT/LibriSpeech fixtures are mono).
// ---------------------------------------------------------------------------

extern "C" {

// Returns number of samples (per channel) on success, -1 on failure.
// *out is malloc'd float32, caller frees via w2v2_free.
// function-try-block: no exception (e.g. bad_alloc on a crafted header) may
// cross the C ABI — callers see a plain -1 failure instead of an abort
int64_t w2v2_decode_wav_buffer(const void* data_in, int64_t len, float** out,
                               int* sample_rate, int* channels) try {
  const uint8_t* bytes = (const uint8_t*)data_in;
  int64_t sz = len;
  std::vector<uint8_t> buf(bytes, bytes + (sz > 0 ? sz : 0));
  if (sz < 44 || memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4))
    return -1;

  size_t pos = 12;
  int fmt_channels = 0, bits = 0, rate = 0, audio_format = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= (size_t)sz) {
    uint32_t chunk_len;
    memcpy(&chunk_len, buf.data() + pos + 4, 4);
    const uint8_t* chunk = buf.data() + pos + 8;
    // declared chunk length must actually be present — a truncated file
    // with a full-size header would otherwise be read past the buffer
    if (!memcmp(buf.data() + pos, "fmt ", 4) && chunk_len >= 16 &&
        pos + 8 + 16 <= (size_t)sz) {
      uint16_t v16;
      memcpy(&v16, chunk, 2); audio_format = v16;
      memcpy(&v16, chunk + 2, 2); fmt_channels = v16;
      uint32_t v32;
      memcpy(&v32, chunk + 4, 4); rate = (int)v32;
      memcpy(&v16, chunk + 14, 2); bits = v16;
    } else if (!memcmp(buf.data() + pos, "data", 4)) {
      data = chunk;
      data_len = chunk_len;
      if (pos + 8 + data_len > (size_t)sz) data_len = sz - pos - 8;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data || audio_format != 1 || bits != 16 || fmt_channels < 1) return -1;

  int64_t n = (int64_t)(data_len / 2) / fmt_channels;
  float* res = (float*)malloc((n ? n : 1) * sizeof(float));
  if (!res) return -1;
  for (int64_t i = 0; i < n; i++) {
    int16_t s;
    memcpy(&s, data + (i * fmt_channels) * 2, 2);  // first channel
    res[i] = (float)s / 32768.0f;
  }
  *out = res;
  *sample_rate = rate;
  *channels = fmt_channels;
  return n;
} catch (...) {
  return -1;
}

int64_t w2v2_decode_wav(const char* path, float** out, int* sample_rate,
                        int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> buf;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 0) { fclose(f); return -1; }
  buf.resize(sz);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) { fclose(f); return -1; }
  fclose(f);
  return w2v2_decode_wav_buffer(buf.data(), sz, out, sample_rate, channels);
}

void w2v2_free(void* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC decoder.
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // bits consumed in current byte (0..7)
  bool ok = true;

  void align() {
    if (bit_pos) { bit_pos = 0; byte_pos++; }
  }

  uint64_t bits(int n) {  // n <= 57
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) { ok = false; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      uint8_t cur = data[byte_pos];
      uint8_t chunk = (uint8_t)((cur >> (avail - take)) & ((1u << take) - 1));
      v = (v << take) | chunk;
      bit_pos += take;
      n -= take;
      if (bit_pos == 8) { bit_pos = 0; byte_pos++; }
    }
    return v;
  }

  int64_t signed_bits(int n) {
    uint64_t v = bits(n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) return (int64_t)v - (1ll << n);
    return (int64_t)v;
  }

  // unary: count zero bits until a 1
  uint32_t unary() {
    uint32_t count = 0;
    while (ok) {
      if (byte_pos >= size) { ok = false; return 0; }
      uint8_t cur = data[byte_pos];
      int avail = 8 - bit_pos;
      uint8_t window = (uint8_t)(cur << bit_pos);  // top `avail` bits valid
      if (window == 0) {
        count += avail;
        bit_pos = 0;
        byte_pos++;
        continue;
      }
      int lead = __builtin_clz((uint32_t)window) - 24;  // zeros in window
      if (lead >= avail) { count += avail; bit_pos = 0; byte_pos++; continue; }
      count += lead;
      bit_pos += lead + 1;
      if (bit_pos >= 8) { bit_pos -= 8; byte_pos++; }
      return count;
    }
    return 0;
  }

  int64_t rice(int param) {
    uint32_t q = unary();
    uint64_t v = ((uint64_t)q << param) | bits(param);
    return (v & 1) ? -((int64_t)(v >> 1)) - 1 : (int64_t)(v >> 1);
  }
};

// UTF-8-style coded number (frame header sample/frame index)
static uint64_t utf8_number(BitReader& br) {
  uint64_t b0 = br.bits(8);
  if (!(b0 & 0x80)) return b0;
  int n = 0;
  uint8_t mask = 0x40;
  while (b0 & mask) { n++; mask >>= 1; }
  uint64_t v = b0 & (mask - 1);
  for (int i = 0; i < n; i++) v = (v << 6) | (br.bits(8) & 0x3f);
  return v;
}

static const int kFixedOrders[5][5] = {
    {0}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

struct Decoder {
  std::vector<int64_t> ch[8];

  bool decode_subframe(BitReader& br, int blocksize, int bps,
                       std::vector<int64_t>& out) {
    if (br.bits(1) != 0) return false;  // padding bit
    int type = (int)br.bits(6);
    int wasted = 0;
    if (br.bits(1)) {  // wasted bits flag
      wasted = 1 + (int)br.unary();
      bps -= wasted;
      // a valid stream wastes fewer bits than the sample width; a corrupt
      // unary run would otherwise drive bps negative / the <<= into UB
      if (wasted >= 32 || bps <= 0) return false;
    }
    out.assign(blocksize, 0);

    if (type == 0) {  // CONSTANT
      int64_t v = br.signed_bits(bps);
      for (int i = 0; i < blocksize; i++) out[i] = v;
    } else if (type == 1) {  // VERBATIM
      for (int i = 0; i < blocksize; i++) out[i] = br.signed_bits(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order = type - 8
      int order = type - 8;
      // warm-up samples must fit the block: a crafted tiny blocksize with
      // a large predictor order would write past out[] otherwise
      if (order > blocksize) return false;
      for (int i = 0; i < order; i++) out[i] = br.signed_bits(bps);
      if (!decode_residual(br, blocksize, order, out)) return false;
      // restore with fixed predictors
      for (int i = order; i < blocksize; i++) {
        int64_t pred = 0;
        switch (order) {
          case 0: pred = 0; break;
          case 1: pred = out[i - 1]; break;
          case 2: pred = 2 * out[i - 1] - out[i - 2]; break;
          case 3: pred = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
          case 4:
            pred = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
            break;
        }
        out[i] += pred;
      }
    } else if (type >= 32) {  // LPC, order = (type & 31) + 1
      int order = (type & 31) + 1;
      if (order > blocksize) return false;  // see FIXED warm-up guard
      for (int i = 0; i < order; i++) out[i] = br.signed_bits(bps);
      int precision = (int)br.bits(4) + 1;
      if (precision == 16) return false;  // invalid
      int shift = (int)br.signed_bits(5);
      // spec requires a non-negative quantization shift; a negative value is
      // a malformed stream — reject rather than hit UB on `pred >> shift`
      if (shift < 0) return false;
      std::vector<int64_t> coefs(order);
      for (int i = 0; i < order; i++) coefs[i] = br.signed_bits(precision);
      if (!decode_residual(br, blocksize, order, out)) return false;
      for (int i = order; i < blocksize; i++) {
        int64_t pred = 0;
        for (int j = 0; j < order; j++) pred += coefs[j] * out[i - 1 - j];
        out[i] += pred >> shift;
      }
    } else {
      return false;  // reserved
    }
    if (wasted)
      for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
    return br.ok;
  }

  bool decode_residual(BitReader& br, int blocksize, int order,
                       std::vector<int64_t>& out) {
    int method = (int)br.bits(2);
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 15 : 31;
    int partition_order = (int)br.bits(4);
    int partitions = 1 << partition_order;
    if (blocksize % partitions) return false;
    int samples_per_part = blocksize >> partition_order;
    int idx = order;
    for (int part = 0; part < partitions; part++) {
      int count = samples_per_part - (part == 0 ? order : 0);
      if (count < 0) return false;
      int param = (int)br.bits(param_bits);
      if (param == escape) {
        int raw_bits = (int)br.bits(5);
        for (int i = 0; i < count; i++) out[idx++] = br.signed_bits(raw_bits);
      } else {
        for (int i = 0; i < count; i++) out[idx++] = br.rice(param);
      }
      if (!br.ok) return false;
    }
    return idx == blocksize;
  }
};

}  // namespace flac

extern "C" {

// Decodes a FLAC stream to float32 (scaled by 1 / 2^(bps-1), first channel).
// Returns sample count per channel, or -1 on failure.
int64_t w2v2_decode_flac_buffer(const void* data, int64_t len, float** out,
                                int* sample_rate, int* channels) try {
  const uint8_t* bytes = (const uint8_t*)data;
  int64_t sz = len;
  std::vector<uint8_t> buf(bytes, bytes + (sz > 0 ? sz : 0));
  if (sz < 8 || memcmp(buf.data(), "fLaC", 4)) return -1;

  flac::BitReader br{buf.data(), (size_t)sz};
  br.byte_pos = 4;

  // metadata blocks; STREAMINFO is mandatory first
  int si_rate = 0, si_channels = 0, si_bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  bool first_block = true;
  while (!last) {
    last = br.bits(1);
    int type = (int)br.bits(7);
    uint32_t len = (uint32_t)br.bits(24);
    if (first_block) {
      if (type != 0 || len < 34) return -1;
      br.bits(16);  // min blocksize
      br.bits(16);  // max blocksize
      br.bits(24);  // min framesize
      br.bits(24);  // max framesize
      si_rate = (int)br.bits(20);
      si_channels = (int)br.bits(3) + 1;
      si_bps = (int)br.bits(5) + 1;
      total_samples = br.bits(36);
      // skip md5 (128 bits)
      br.bits(57); br.bits(57); br.bits(14);
      first_block = false;
    } else {
      br.align();
      br.byte_pos += len;
      if (br.byte_pos > br.size) return -1;
    }
  }
  br.align();
  if (si_channels < 1 || si_channels > 8 || si_bps < 4) return -1;

  std::vector<float> samples;
  // reserve is only a hint — clamp it so a crafted 36-bit STREAMINFO count
  // cannot force a terabyte-scale allocation before any audio is decoded
  if (total_samples)
    samples.reserve((size_t)(total_samples < (1ull << 24) ? total_samples
                                                          : (1ull << 24)));
  // decompression-bomb guard.  FLAC legitimately reaches ~4850 samples/byte
  // (CONSTANT frames over digital silence), so no expansion ratio alone can
  // separate hostile from legit input — and the declared total is attacker-
  // controlled too.  Bound the whole-file decode by the declared total
  // (one block of slack: a final frame may overshoot slightly and is
  // trimmed below), by a ratio just above the achievable maximum, AND by
  // an absolute ceiling of 2^28 samples (~4.6 h @ 16 kHz, a 1 GB buffer):
  // a crafted small upload can then never grow the buffer toward
  // bad_alloc/OOM on a serving host.  Longer-than-4.6 h audio must be
  // decoded in chapters (transcribe_long chunks far below this anyway).
  uint64_t max_out = total_samples ? total_samples + 65536
                                   : (uint64_t)sz * 5000 + 65536;
  if (max_out > (1ull << 28)) max_out = 1ull << 28;
  flac::Decoder dec;
  double scale = 1.0 / (double)(1ll << (si_bps - 1));

  static const int kBlockSizes[16] = {0,    192,  576,  1152, 2304, 4608, -1, -2,
                                      256,  512,  1024, 2048, 4096, 8192,
                                      16384, 32768};
  static const int kRates[16] = {0 /*streaminfo*/, 88200, 176400, 192000,
                                 8000, 16000, 22050, 24000, 32000, 44100,
                                 48000, 96000, -1, -2, -3, 0};

  while (br.ok && br.byte_pos < br.size) {
    // frame header: 14-bit sync 0b11111111111110
    uint64_t sync = br.bits(14);
    if (!br.ok) break;
    if (sync != 0x3ffe) return -1;
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_code = (int)br.bits(4);
    int bps_code = (int)br.bits(3);
    br.bits(1);  // reserved
    flac::utf8_number(br);
    int blocksize;
    if (bs_code == 6) blocksize = (int)br.bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.bits(16) + 1;
    else if (bs_code >= 1) blocksize = kBlockSizes[bs_code];
    else return -1;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    (void)kRates;
    int bps = si_bps;
    static const int kBps[8] = {0, 8, 12, -1, 16, 20, 24, 32};
    if (bps_code != 0) {
      if (kBps[bps_code] <= 0) return -1;
      bps = kBps[bps_code];
    }
    br.bits(8);  // header CRC-8 (not verified; payload CRC16 guards data)

    int nch = si_channels;
    int assignment = 0;  // 0 = independent
    if (ch_code <= 7) { nch = ch_code + 1; assignment = 0; }
    else if (ch_code == 8) { nch = 2; assignment = 1; }   // left/side
    else if (ch_code == 9) { nch = 2; assignment = 2; }   // right/side
    else if (ch_code == 10) { nch = 2; assignment = 3; }  // mid/side
    else return -1;

    for (int c = 0; c < nch; c++) {
      int sub_bps = bps;
      // side channel carries one extra bit
      if ((assignment == 1 && c == 1) || (assignment == 2 && c == 0) ||
          (assignment == 3 && c == 1))
        sub_bps += 1;
      if (!dec.decode_subframe(br, blocksize, sub_bps, dec.ch[c])) return -1;
    }
    br.align();
    br.bits(16);  // frame CRC-16

    // stereo decorrelation
    if (assignment == 1) {  // left/side: right = left - side
      for (int i = 0; i < blocksize; i++) dec.ch[1][i] = dec.ch[0][i] - dec.ch[1][i];
    } else if (assignment == 2) {  // right/side: left = right + side
      for (int i = 0; i < blocksize; i++) dec.ch[0][i] = dec.ch[1][i] + dec.ch[0][i];
    } else if (assignment == 3) {  // mid/side
      for (int i = 0; i < blocksize; i++) {
        int64_t mid = dec.ch[0][i], side = dec.ch[1][i];
        mid = (mid << 1) | (side & 1);
        dec.ch[0][i] = (mid + side) >> 1;
        dec.ch[1][i] = (mid - side) >> 1;
      }
    }

    if (samples.size() + (size_t)blocksize > max_out) return -1;
    for (int i = 0; i < blocksize; i++)
      samples.push_back((float)(dec.ch[0][i] * scale));  // first channel

    if (total_samples && samples.size() >= total_samples) break;
  }
  if (total_samples && samples.size() > total_samples)
    samples.resize(total_samples);

  float* res = (float*)malloc((samples.empty() ? 1 : samples.size()) *
                              sizeof(float));
  if (!res) return -1;
  memcpy(res, samples.data(), samples.size() * sizeof(float));
  *out = res;
  *sample_rate = si_rate;
  *channels = si_channels;
  return (int64_t)samples.size();
} catch (...) {
  return -1;
}

int64_t w2v2_decode_flac(const char* path, float** out, int* sample_rate,
                         int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> buf;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 0) { fclose(f); return -1; }
  buf.resize(sz);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) { fclose(f); return -1; }
  fclose(f);
  return w2v2_decode_flac_buffer(buf.data(), sz, out, sample_rate, channels);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel batch decode — the data-plane "runtime" piece: a std::thread pool
// decodes many FLAC files concurrently (ctypes releases the GIL around the
// call, so Python-side prefetch threads keep feeding the device meanwhile).
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

extern "C" {

// Decodes `n` FLAC files with up to `num_threads` workers.
// outs[i]/lens[i]/rates[i] receive per-file results; lens[i] == -1 marks a
// failed file.  Buffers are malloc'd; caller frees each via w2v2_free.
void w2v2_decode_flac_batch(const char** paths, int64_t n, int num_threads,
                            float** outs, int64_t* lens, int* rates) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int channels = 0;
      lens[i] = w2v2_decode_flac(paths[i], &outs[i], &rates[i], &channels);
    }
  };
  std::vector<std::thread> pool;
  int spawn = (int)std::min<int64_t>(num_threads, n);
  pool.reserve(spawn);
  for (int t = 0; t < spawn; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
