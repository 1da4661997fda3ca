// Minimal OpenEXR scanline reader/writer (no OpenEXR library dependency).
//
// Host-native counterpart of the reference's HDRI ingestion, which uses the
// OpenEXR RgbaInputFile API inline in the GL layer
// (src/NGLScene.cpp:205-231,368-401).  Reads single-part scanline images
// with HALF or FLOAT channels under NONE / RLE / ZIPS / ZIP / PIZ / PXR24 /
// B44 / B44A / DWAA / DWAB compression — the full OpenEXR scanline codec
// set (csrc/piz.cc holds the wavelet+Huffman codec, csrc/dwa.cc the lossy
// DCT one).  Output is planar-interleaved RGB float32 rows
// (top-down, matching the reference's Rgba buffer order).  The writer
// emits HALF scanlines under every scanline codec except B44A (identical
// to B44 for RGB-without-alpha): NONE / RLE / ZIPS / ZIP / PIZ / PXR24 /
// B44 / DWAA / DWAB.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace vtrace {

// csrc/dwa.cc
bool dwa_uncompress(const uint8_t* in, size_t in_len, int w, int nlines,
                    const std::vector<std::string>& ch_names,
                    const std::vector<int>& ch_types, uint8_t* out,
                    size_t out_size);
bool dwa_compress_rgb(const uint16_t* rows, int w, int nlines,
                      std::vector<uint8_t>* out, float quant);

// csrc/piz.cc
bool piz_uncompress(const uint8_t* in, size_t in_len, int nx, int ny,
                    const int* ch_size_shorts, int n_ch, uint8_t* out);
bool piz_compress(const uint8_t* in, int nx, int ny,
                  const int* ch_size_shorts, int n_ch,
                  std::vector<uint8_t>* out);

namespace {

constexpr uint32_t kMagic = 20000630;  // 0x762f3101 little-endian

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int e = -1;
      uint32_t m = mant;
      do {
        ++e;
        m <<= 1;
      } while (!(m & 0x400));
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((m & 0x3FF) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t float_to_half(float f) {
  // Round-to-nearest-even with subnormal support (matches the library's
  // half conversion; a truncating version loses up to one ULP on every
  // written sample and broke DWA bit-parity — tests/test_exr_golden.py).
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint16_t sign = (uint16_t)((bits >> 16) & 0x8000);
  int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFF;
  if (((bits >> 23) & 0xFF) == 0xFF)  // inf / nan
    return (uint16_t)(sign | 0x7C00 | (mant ? 0x200 : 0));
  if (exp >= 31) return (uint16_t)(sign | 0x7C00);
  if (exp <= 0) {
    if (exp < -10) return sign;  // underflows to zero even after rounding
    mant |= 0x800000;
    int shift = 14 - exp;
    uint32_t v = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t half_bit = 1u << (shift - 1);
    if (rem > half_bit || (rem == half_bit && (v & 1))) ++v;
    return (uint16_t)(sign | v);
  }
  uint32_t v = mant >> 13;
  uint32_t rem = mant & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (v & 1))) {
    ++v;
    if (v == 0x400) {
      v = 0;
      ++exp;
      if (exp >= 31) return (uint16_t)(sign | 0x7C00);
    }
  }
  return (uint16_t)(sign | ((uint32_t)exp << 10) | v);
}

struct Channel {
  std::string name;
  int type;  // 0 UINT, 1 HALF, 2 FLOAT
};

struct Reader {
  FILE* f = nullptr;
  ~Reader() {
    if (f) std::fclose(f);
  }
  bool read(void* p, size_t n) { return std::fread(p, 1, n, f) == n; }
  template <typename T>
  bool get(T* v) {
    return read(v, sizeof(T));
  }
  bool get_string(std::string* s) {
    s->clear();
    for (;;) {
      char c;
      if (!get(&c)) return false;
      if (c == 0) return true;
      if (s->size() > 255) return false;
      s->push_back(c);
    }
  }
};

// EXR zip post-processing: delta-decode then de-interleave (the inverse of
// the OpenEXR "predictor + interleave" pre-compression transform).  RLE
// blocks use the same transform.
void exr_unfilter(std::vector<uint8_t>& data) {
  for (size_t i = 1; i < data.size(); ++i)
    data[i] = (uint8_t)(data[i] + data[i - 1] - 128);
  std::vector<uint8_t> out(data.size());
  const uint8_t* t1 = data.data();
  const uint8_t* t2 = data.data() + (data.size() + 1) / 2;
  for (size_t i = 0; i < data.size(); ++i)
    out[i] = (i % 2 == 0) ? *t1++ : *t2++;
  data.swap(out);
}

// EXR RLE: int8 n < 0 -> -n literal bytes; n >= 0 -> next byte n+1 times.
bool rle_decode(const uint8_t* in, size_t n, size_t want,
                std::vector<uint8_t>* out) {
  out->clear();
  out->reserve(want);
  size_t i = 0;
  while (i < n && out->size() < want) {
    int8_t c = (int8_t)in[i++];
    if (c < 0) {
      size_t cnt = (size_t)(-(int)c);
      if (i + cnt > n || out->size() + cnt > want) return false;
      out->insert(out->end(), in + i, in + i + cnt);
      i += cnt;
    } else {
      if (i >= n || out->size() + (size_t)c + 1 > want) return false;
      out->insert(out->end(), (size_t)c + 1, in[i++]);
    }
  }
  return out->size() == want;
}

// PXR24 block reconstruction: zlib output holds, per scanline, per channel,
// byte PLANES (float -> top 3 bytes, half -> 2 bytes); per pixel the bytes
// recombine into one diff whose running sum over the line is the pixel
// value — the delta is on the COMBINED word, so low-byte carries propagate
// into the high bytes (validated bit-exact against the system OpenEXR,
// tests/test_exr_golden.py; a per-plane accumulation corrupts any line
// whose low-byte sums wrap).  Rebuild the standard raw scanline layout.
bool pxr24_reconstruct(const std::vector<uint8_t>& planes, int w, int nlines,
                       const std::vector<Channel>& channels,
                       std::vector<uint8_t>* raw, size_t want) {
  raw->assign(want, 0);
  size_t sp = 0;
  size_t dp = 0;
  for (int line = 0; line < nlines; ++line) {
    for (const Channel& ch : channels) {
      int nplanes = ch.type == 2 ? 3 : 2;
      if (sp + (size_t)nplanes * w > planes.size()) return false;
      const uint8_t* p0 = planes.data() + sp;
      const uint8_t* p1 = p0 + w;
      const uint8_t* p2 = p1 + w;
      if (ch.type == 2) {  // FLOAT: bits = pixel24 << 8
        uint32_t pixel = 0;
        for (int x = 0; x < w; ++x) {
          uint32_t diff = ((uint32_t)p0[x] << 16) | ((uint32_t)p1[x] << 8)
                          | (uint32_t)p2[x];
          pixel = (pixel + diff) & 0xFFFFFF;
          uint32_t bits = pixel << 8;
          std::memcpy(raw->data() + dp + (size_t)x * 4, &bits, 4);
        }
        dp += (size_t)w * 4;
      } else {  // HALF
        uint16_t pixel = 0;
        for (int x = 0; x < w; ++x) {
          uint16_t diff = (uint16_t)(((uint16_t)p0[x] << 8) | p1[x]);
          pixel = (uint16_t)(pixel + diff);
          std::memcpy(raw->data() + dp + (size_t)x * 2, &pixel, 2);
        }
        dp += (size_t)w * 2;
      }
      sp += (size_t)nplanes * w;
    }
  }
  return dp == want;
}

// Decode one compressed chunk covering `nlines` lines of `bw` pixels into
// the standard raw scanline layout (shared by the scanline and tiled
// paths).  `row_bytes` = sum of channel sizes * bw.
// ---------------------------------------------------------------------------
// B44 / B44A (compression 6 / 7): HALF channels in 4x4 pixel blocks of 14
// bytes (3 bytes for B44A "flat" blocks); FLOAT/UINT channels stored raw.
// Written from the OpenEXR file-format specification of the codec: each
// half is sign-transformed to t (monotonic unsigned ordering), the block
// stores t[0] plus fifteen 6-bit chain deltas scaled by a per-block shift.
// ---------------------------------------------------------------------------

bool b44_unpack14(const uint8_t* b, uint16_t s[16]) {
  const uint32_t shift = b[2] >> 2;
  if (shift > 16) return false;  // malformed: halves are 16-bit
  const uint32_t bias = 0x20u << shift;
  s[0] = (uint16_t)((b[0] << 8) | b[1]);
  // Twelve packed bytes hold the 6-bit shift plus fifteen 6-bit codes in
  // four 3-byte groups; chain order: down the first column, then along
  // each row.
  auto code = [&](int idx) -> uint32_t {  // idx 0..14
    const int bit = 6 * (idx + 1);  // after the shift field
    const int byte = 2 + bit / 8;
    const uint32_t w =
        ((uint32_t)b[byte] << 8) | (byte + 1 < 14 ? b[byte + 1] : 0);
    return (w >> (16 - 6 - bit % 8)) & 0x3f;
  };
  static const int8_t chain[15][2] = {
      {0, 4},  {4, 8},  {8, 12},  {0, 1},  {4, 5},
      {8, 9},  {12, 13}, {1, 2},  {5, 6},  {9, 10},
      {13, 14}, {2, 3},  {6, 7},  {10, 11}, {14, 15}};
  for (int i = 0; i < 15; ++i)
    s[chain[i][1]] =
        (uint16_t)(s[chain[i][0]] + (code(i) << shift) - bias);
  for (int i = 0; i < 16; ++i)
    s[i] = (s[i] & 0x8000) ? (uint16_t)(s[i] & 0x7fff) : (uint16_t)~s[i];
  return true;
}

bool b44_uncompress(const uint8_t* in, size_t n, int w, int nlines,
                    const std::vector<Channel>& channels,
                    const std::vector<size_t>& ch_offset,
                    const std::vector<int>& ch_size, size_t row_bytes,
                    std::vector<uint8_t>* raw) {
  raw->assign(row_bytes * (size_t)nlines, 0);
  const uint8_t* p = in;
  const uint8_t* end = in + n;
  const int bx = (w + 3) / 4, by = (nlines + 3) / 4;
  std::vector<uint16_t> plane((size_t)by * 4 * bx * 4);
  for (size_t c = 0; c < channels.size(); ++c) {
    uint8_t* dst_base = raw->data() + ch_offset[c];
    if (channels[c].type != 1) {  // FLOAT/UINT: stored uncompressed
      const size_t need = (size_t)w * nlines * ch_size[c];
      if (p + need > end) return false;
      for (int y = 0; y < nlines; ++y)
        std::memcpy(dst_base + row_bytes * y, p + (size_t)w * ch_size[c] * y,
                    (size_t)w * ch_size[c]);
      p += need;
      continue;
    }
    for (int r = 0; r < by; ++r)
      for (int b = 0; b < bx; ++b) {
        uint16_t s[16];
        if (p + 3 > end) return false;
        if (p[2] >= 0xfc) {  // B44A flat block
          s[0] = (uint16_t)((p[0] << 8) | p[1]);
          for (int i = 1; i < 16; ++i) s[i] = s[0];
          for (int i = 0; i < 16; ++i)
            s[i] = (s[i] & 0x8000) ? (uint16_t)(s[i] & 0x7fff)
                                   : (uint16_t)~s[i];
          p += 3;
        } else {
          if (p + 14 > end || !b44_unpack14(p, s)) return false;
          p += 14;
        }
        for (int i = 0; i < 16; ++i)
          plane[(size_t)(r * 4 + i / 4) * bx * 4 + b * 4 + i % 4] = s[i];
      }
    for (int y = 0; y < nlines; ++y) {
      uint16_t* dst = (uint16_t*)(dst_base + row_bytes * y);
      for (int x = 0; x < w; ++x) dst[x] = plane[(size_t)y * bx * 4 + x];
    }
  }
  return true;
}

bool decode_chunk(uint8_t compression, const std::vector<uint8_t>& packed,
                  int bw, int nlines, size_t row_bytes,
                  const std::vector<Channel>& channels,
                  std::vector<uint8_t>* raw) {
  const size_t want = row_bytes * (size_t)nlines;
  const size_t dsize = packed.size();
  if (compression == 0 || dsize >= want) {
    // All compressors fall back to storing raw bytes when compression
    // would not shrink the block.
    if (dsize < want) return false;
    raw->assign(packed.begin(), packed.begin() + want);
  } else if (compression == 1) {  // RLE
    if (!rle_decode(packed.data(), dsize, want, raw)) return false;
    exr_unfilter(*raw);
  } else if (compression == 4) {  // PIZ
    std::vector<int> ch_shorts(channels.size());
    for (size_t c = 0; c < channels.size(); ++c)
      ch_shorts[c] = channels[c].type == 2 ? 2 : 1;
    raw->resize(want);
    if (!piz_uncompress(packed.data(), dsize, bw, nlines, ch_shorts.data(),
                        (int)channels.size(), raw->data()))
      return false;
  } else if (compression == 5) {  // PXR24
    size_t planes_size = 0;
    for (const Channel& ch : channels)
      planes_size += (size_t)(ch.type == 2 ? 3 : 2) * bw;
    planes_size *= (size_t)nlines;
    std::vector<uint8_t> planes(planes_size);
    uLongf dst_len = (uLongf)planes_size;
    if (uncompress(planes.data(), &dst_len, packed.data(), (uLong)dsize) !=
            Z_OK ||
        dst_len != planes_size)
      return false;
    if (!pxr24_reconstruct(planes, bw, nlines, channels, raw, want))
      return false;
  } else if (compression == 6 || compression == 7) {  // B44 / B44A
    size_t off = 0;
    std::vector<size_t> ch_offset(channels.size());
    std::vector<int> ch_size(channels.size());
    for (size_t c = 0; c < channels.size(); ++c) {
      ch_offset[c] = off;
      ch_size[c] = channels[c].type == 1 ? 2 : 4;
      off += (size_t)bw * ch_size[c];
    }
    if (!b44_uncompress(packed.data(), dsize, bw, nlines, channels,
                        ch_offset, ch_size, row_bytes, raw))
      return false;
  } else if (compression == 8 || compression == 9) {  // DWAA / DWAB
    std::vector<std::string> names(channels.size());
    std::vector<int> types(channels.size());
    for (size_t c = 0; c < channels.size(); ++c) {
      names[c] = channels[c].name;
      types[c] = channels[c].type;
    }
    raw->resize(want);
    if (!dwa_uncompress(packed.data(), dsize, bw, nlines, names, types,
                        raw->data(), want))
      return false;
  } else {  // ZIPS / ZIP
    raw->resize(want);
    uLongf dst_len = (uLongf)want;
    if (uncompress(raw->data(), &dst_len, packed.data(), (uLong)dsize) !=
            Z_OK ||
        dst_len != want)
      return false;
    exr_unfilter(*raw);
  }
  return true;
}

// B44 encoder: one 4x4 block of t-space values -> 14 bytes.  Picks the
// smallest shift whose 6-bit chain codes fit, encoding against the
// RECONSTRUCTED chain (error feedback) exactly as the decoder will replay
// it.
void b44_pack14(const uint16_t t[16], uint8_t b[14]) {
  static const int8_t chain[15][2] = {
      {0, 4},  {4, 8},  {8, 12},  {0, 1},  {4, 5},
      {8, 9},  {12, 13}, {1, 2},  {5, 6},  {9, 10},
      {13, 14}, {2, 3},  {6, 7},  {10, 11}, {14, 15}};
  // Every reconstructed value lives on the lattice t0 + k*2^shift (codes
  // move in whole steps), so the per-pixel error is fixed by the residue
  // (t[i] - t0) mod 2^shift.  Two tricks keep it low (both reverse-
  // engineered from system-OpenEXR output, which this encoder now matches
  // in quality — tests/test_exr_golden.py):
  //  * anchor the lattice to tMax by adjusting the STORED t0, so the
  //    largest-exponent pixels (whose t-units are worth the most in
  //    absolute value) reconstruct near-exactly;
  //  * round-to-nearest code selection with error feedback, so every
  //    other pixel lands on its nearest lattice point (<= half a step)
  //    instead of drifting up to a full step.
  uint16_t t_max = t[0];
  for (int i = 1; i < 16; ++i)
    if (t[i] > t_max) t_max = t[i];
  uint32_t codes[15];
  uint32_t shift = 0;
  int32_t t0 = t[0];
  for (; shift <= 16; ++shift) {
    const int32_t bias = 0x20 << shift;
    const int32_t half_step = shift ? (1 << (shift - 1)) : 0;
    const int32_t mask = (int32_t)((1u << shift) - 1);
    int32_t res = ((int32_t)t[0] - (int32_t)t_max) & mask;
    if (res > half_step) res -= (int32_t)(1u << shift);  // nearest anchor
    t0 = (int32_t)t[0] - res;
    if (t0 < 0) t0 += 1 << shift;
    if (t0 > 0xFFFF) t0 -= 1 << shift;
    int32_t recon[16];
    recon[0] = t0;
    bool ok = true;
    for (int i = 0; i < 15 && ok; ++i) {
      const int a = chain[i][0], c = chain[i][1];
      int32_t d = ((int32_t)t[c] - recon[a] + bias + half_step) >> shift;
      if (d < 0 || d > 0x3f) {
        ok = false;
        break;
      }
      codes[i] = (uint32_t)d;
      recon[c] = recon[a] + ((int32_t)(codes[i] << shift)) - bias;
    }
    if (ok) break;
  }
  if (shift > 16) shift = 16;  // unreachable for valid halves; clamp
  b[0] = (uint8_t)((uint16_t)t0 >> 8);
  b[1] = (uint8_t)((uint16_t)t0 & 0xff);
  uint32_t fields[16];
  fields[0] = shift;
  for (int i = 0; i < 15; ++i) fields[i + 1] = codes[i];
  for (int g = 0; g < 4; ++g) {
    uint32_t x = (fields[4 * g] << 18) | (fields[4 * g + 1] << 12) |
                 (fields[4 * g + 2] << 6) | fields[4 * g + 3];
    b[2 + 3 * g] = (uint8_t)(x >> 16);
    b[3 + 3 * g] = (uint8_t)(x >> 8);
    b[4 + 3 * g] = (uint8_t)x;
  }
}

uint16_t b44_to_t(uint16_t h) {
  if ((h & 0x7c00) == 0x7c00) return 0x8000;  // inf/nan -> zero-ish
  return (h & 0x8000) ? (uint16_t)(~h & 0xffff) : (uint16_t)(h | 0x8000);
}

// Encode `nlines` rows of 3 interleaved-by-plane HALF channels (the
// writer's `rows` layout: per line, B plane then G then R) as B44 blocks.
void b44_compress(const uint16_t* rows, int w, int nlines,
                  std::vector<uint8_t>* out) {
  const int bx = (w + 3) / 4, by = (nlines + 3) / 4;
  out->clear();
  out->reserve((size_t)3 * bx * by * 14);
  uint8_t blk[14];
  for (int c = 0; c < 3; ++c)
    for (int r = 0; r < by; ++r)
      for (int b = 0; b < bx; ++b) {
        uint16_t t[16];
        for (int i = 0; i < 16; ++i) {
          int y = std::min(r * 4 + i / 4, nlines - 1);
          int x = std::min(b * 4 + i % 4, w - 1);  // edge replication
          t[i] = b44_to_t(rows[((size_t)y * 3 + c) * w + x]);
        }
        b44_pack14(t, blk);
        out->insert(out->end(), blk, blk + 14);
      }
}

}  // namespace

// Named exports shared with csrc/dwa.cc (the DWA DC stream uses the same
// zip post-filter, its RLE channels the same byte RLE, and coefficients
// the same half conversions) — one implementation each, not copies.
float vt_half_to_float(uint16_t h) { return half_to_float(h); }
uint16_t vt_float_to_half(float f) { return float_to_half(f); }
void vt_exr_unfilter(std::vector<uint8_t>& data) { exr_unfilter(data); }
bool vt_exr_rle_decode(const uint8_t* in, size_t n, size_t want,
                       std::vector<uint8_t>* out) {
  return rle_decode(in, n, want, out);
}

extern "C" {

// Read an EXR into [h*w*3] float32 RGB (top-down). Returns 0 on success,
// >0 error codes: 1 open, 2 magic/version, 3 header parse, 4 unsupported
// (deep/multipart/compression/channels), 5 data corrupt.  Scanline and
// single-part tiled layouts (ONE_LEVEL and the level-(0,0) plane of
// MIPMAP/RIPMAP files) are both handled.
// One part's header state (single-part files have exactly one; multipart
// files a sequence, each REQUIRED to carry "type" and "chunkCount" —
// OpenEXR 2 file-layout spec).
struct PartHeader {
  std::vector<Channel> channels;
  int32_t dw[4] = {0, 0, 0, 0};
  uint8_t compression = 0;
  uint32_t tile_x = 0, tile_y = 0;
  uint8_t tile_mode = 0;
  std::string part_type;  // "scanlineimage"/"tiledimage"/"deepscanline"/...
  int64_t chunk_count = -1;
};

// Parse one header (attribute list up to the empty terminator name).
// Returns 0 ok, else the vt_load_exr error code.
static int parse_part_header(Reader& r, PartHeader* ph) {
  for (;;) {
    std::string name;
    if (!r.get_string(&name)) return 3;
    if (name.empty()) break;
    std::string type;
    if (!r.get_string(&type)) return 3;
    int32_t size;
    if (!r.get(&size) || size < 0 || size > (1 << 26)) return 3;
    std::vector<uint8_t> buf(size);
    if (!r.read(buf.data(), size)) return 3;

    if (name == "channels" && type == "chlist") {
      size_t p = 0;
      while (p < buf.size() && buf[p] != 0) {
        std::string cn;
        while (p < buf.size() && buf[p] != 0) cn.push_back((char)buf[p++]);
        ++p;  // skip nul
        if (p + 16 > buf.size()) return 3;
        int32_t ptype;
        std::memcpy(&ptype, &buf[p], 4);
        ph->channels.push_back({cn, ptype});
        p += 16;  // type, pLinear+pad, xSampling, ySampling
      }
    } else if (name == "dataWindow" && type == "box2i") {
      if (size != 16) return 3;
      std::memcpy(ph->dw, buf.data(), 16);
    } else if (name == "compression" && type == "compression") {
      ph->compression = buf[0];
    } else if (name == "tiles" && type == "tiledesc") {
      if (size != 9) return 3;
      std::memcpy(&ph->tile_x, &buf[0], 4);
      std::memcpy(&ph->tile_y, &buf[4], 4);
      ph->tile_mode = buf[8];
    } else if (name == "type" && type == "string") {
      ph->part_type.assign((const char*)buf.data(), buf.size());
    } else if (name == "chunkCount" && type == "int") {
      if (size != 4) return 3;
      int32_t cc;
      std::memcpy(&cc, buf.data(), 4);
      ph->chunk_count = cc;
    }
  }
  return 0;
}

int vt_load_exr(const char* path, float** out_rgb, int* out_w, int* out_h) {
  Reader r;
  r.f = std::fopen(path, "rb");
  if (!r.f) return 1;
  uint32_t magic, version;
  if (!r.get(&magic) || !r.get(&version) || magic != kMagic) return 2;
  // Deep single-part (0x800) stays unsupported; MULTIPART (0x1000) files
  // are read by selecting the first regular-image part (part 0's RGB in
  // practice — the reference reads whatever its linked OpenEXR reads,
  // /root/reference/src/NGLScene.cpp:368-401).  The long-name flag
  // (0x400) only relaxes the attribute-name limit and parses fine;
  // tiled (0x200 / a "tiledimage" part type) takes the tile path below.
  const bool multipart = (version & 0x1000) != 0;
  if (!multipart && (version & 0x800)) return 4;

  std::vector<PartHeader> parts;
  if (!multipart) {
    parts.emplace_back();
    int rc = parse_part_header(r, &parts[0]);
    if (rc) return rc;
  } else {
    for (;;) {
      // The header list ends with an empty header (a lone 0x00).
      char c;
      if (!r.get(&c)) return 3;
      if (c == 0) break;
      if (fseek(r.f, -1, SEEK_CUR) != 0) return 3;
      parts.emplace_back();
      int rc = parse_part_header(r, &parts.back());
      if (rc) return rc;
      if (parts.size() > 256) return 3;
    }
    if (parts.empty()) return 3;
  }

  // Select the first regular-image part; its offset table position needs
  // every earlier part's chunkCount (required in multipart headers).
  int sel = -1;
  int64_t skip_chunks = 0;
  for (size_t i = 0; i < parts.size(); ++i) {
    const std::string& t = parts[i].part_type;
    if (!multipart || t == "scanlineimage" || t == "tiledimage") {
      sel = (int)i;
      break;
    }
    if (parts[i].chunk_count < 0) return 4;  // cannot skip an unsized part
    skip_chunks += parts[i].chunk_count;
  }
  if (sel < 0) return 4;  // deep-only multipart
  const PartHeader& P = parts[sel];
  const std::vector<Channel>& channels = P.channels;
  const int32_t* dw = P.dw;
  const uint8_t compression = P.compression;
  const uint32_t tile_x = P.tile_x, tile_y = P.tile_y;
  const uint8_t tile_mode = P.tile_mode;
  const bool tiled =
      multipart ? P.part_type == "tiledimage" : (version & 0x200) != 0;
  if (multipart && P.chunk_count < 0) return 3;

  const int w = dw[2] - dw[0] + 1;
  const int h = dw[3] - dw[1] + 1;
  if (w <= 0 || h <= 0 || (int64_t)w * h > (int64_t)1 << 30) return 3;
  // compression: 0 NONE, 1 RLE, 2 ZIPS (1 line), 3 ZIP (16 lines),
  // 4 PIZ (32 lines), 5 PXR24 (16 lines), 6 B44 / 7 B44A (32 lines)
  int lines_per_block;
  if (compression == 0 || compression == 1 || compression == 2)
    lines_per_block = 1;
  else if (compression == 3 || compression == 5)
    lines_per_block = 16;
  else if (compression == 4 || compression == 6 || compression == 7 ||
           compression == 8)
    lines_per_block = 32;
  else if (compression == 9)  // DWAB
    lines_per_block = 256;
  else
    return 4;
  if (compression == 1) lines_per_block = 1;

  // Channels appear in the file sorted by name; find R,G,B (fall back to
  // Y for grayscale).
  int idx_rgb[3] = {-1, -1, -1};
  size_t row_bytes = 0;
  std::vector<size_t> ch_offset(channels.size());
  std::vector<int> ch_size(channels.size());
  for (size_t c = 0; c < channels.size(); ++c) {
    if (channels[c].type == 0) return 4;  // UINT channels unsupported
    ch_offset[c] = row_bytes;
    ch_size[c] = channels[c].type == 1 ? 2 : 4;
    row_bytes += (size_t)w * ch_size[c];
    if (channels[c].name == "R") idx_rgb[0] = (int)c;
    if (channels[c].name == "G") idx_rgb[1] = (int)c;
    if (channels[c].name == "B") idx_rgb[2] = (int)c;
    if (channels[c].name == "Y" && idx_rgb[0] < 0) {
      idx_rgb[0] = idx_rgb[1] = idx_rgb[2] = (int)c;
    }
  }
  if (idx_rgb[0] < 0 || idx_rgb[1] < 0 || idx_rgb[2] < 0) return 4;

  float* rgb = (float*)std::malloc(sizeof(float) * 3 * (size_t)w * h);
  if (!rgb) return 5;

  // Scatter `bh` decoded lines of `bw` pixels into rgb at (x0, y0).
  auto scatter = [&](const std::vector<uint8_t>& raw, int x0, int y0, int bw,
                     int bh) {
    size_t rb = 0;
    std::vector<size_t> off(channels.size());
    for (size_t c = 0; c < channels.size(); ++c) {
      off[c] = rb;
      rb += (size_t)bw * ch_size[c];
    }
    for (int line = 0; line < bh; ++line) {
      const uint8_t* row = raw.data() + rb * (size_t)line;
      const int y = y0 + line;
      if (y < 0 || y >= h) continue;
      for (int k = 0; k < 3; ++k) {
        const int c = idx_rgb[k];
        const uint8_t* src = row + off[c];
        float* dst = rgb + ((size_t)y * w + x0) * 3 + k;
        if (ch_size[c] == 2) {
          const uint16_t* hp = (const uint16_t*)src;
          for (int x = 0; x < bw; ++x, dst += 3) *dst = half_to_float(hp[x]);
        } else {
          const float* fp = (const float*)src;
          for (int x = 0; x < bw; ++x, dst += 3) *dst = fp[x];
        }
      }
    }
  };

  std::vector<uint8_t> raw, packed;
  // Multipart: offset tables are stored per part in part order right after
  // the header list; skip the earlier (e.g. deep) parts' tables, and each
  // chunk leads with its part number.
  if (skip_chunks &&
      fseek(r.f, (long)(8 * skip_chunks), SEEK_CUR) != 0)
    goto corrupt;
  if (!tiled) {
    const int n_blocks = (h + lines_per_block - 1) / lines_per_block;
    if (multipart && P.chunk_count != n_blocks) goto corrupt;
    std::vector<uint64_t> offsets(n_blocks);
    if (!r.read(offsets.data(), 8 * (size_t)n_blocks)) goto corrupt;

    for (int b = 0; b < n_blocks; ++b) {
      if (fseek(r.f, (long)offsets[b], SEEK_SET) != 0) goto corrupt;
      if (multipart) {
        int32_t pnum;
        if (!r.get(&pnum) || pnum != sel) goto corrupt;
      }
      int32_t y0, dsize;
      if (!r.get(&y0) || !r.get(&dsize) || dsize < 0) goto corrupt;
      y0 -= dw[1];
      // Unvalidated y0 > h would make nlines negative and the size_t
      // multiply below wrap to a huge allocation (aborting under
      // -fno-exceptions); reject out-of-range block headers as corruption.
      if (y0 < 0 || y0 >= h) goto corrupt;
      const int nlines = std::min(lines_per_block, h - y0);
      if (nlines <= 0) goto corrupt;
      packed.resize(dsize);
      if (!r.read(packed.data(), dsize)) goto corrupt;
      if (!decode_chunk(compression, packed, w, nlines, row_bytes, channels,
                        &raw))
        goto corrupt;
      scatter(raw, 0, y0, w, nlines);
    }
  } else {
    // Tiled single-part: offset table covers every level; only level (0,0)
    // tiles — identified by the lx/ly fields each tile block carries — are
    // scattered.  Level sizes follow the tiledesc rounding mode.
    if (tile_x == 0 || tile_y == 0 || tile_x > (1u << 20) ||
        tile_y > (1u << 20))
      goto corrupt;
    const int level_mode = tile_mode & 0xF;       // 0 one, 1 mip, 2 rip
    const int round_up = (tile_mode >> 4) != 0;   // rounding mode
    if (level_mode > 2) goto corrupt;
    auto level_size = [&](int n, int l) {
      int64_t d = (int64_t)1 << l;
      int64_t s = round_up ? (n + d - 1) / d : n / d;
      return (int)(s < 1 ? 1 : s);
    };
    auto n_levels_for = [&](int n) {
      int lv = 1;
      while (n > 1) {
        n = round_up ? (n + 1) / 2 : n / 2;
        ++lv;
      }
      return lv;
    };
    int nlx = 1, nly = 1;
    if (level_mode == 1)
      nlx = nly = n_levels_for(std::max(w, h));
    else if (level_mode == 2) {
      nlx = n_levels_for(w);
      nly = n_levels_for(h);
    }
    int64_t n_chunks = 0;
    for (int ly = 0; ly < nly; ++ly)
      for (int lx = 0; lx < nlx; ++lx) {
        if (level_mode == 1 && lx != ly) continue;
        int64_t tx = (level_size(w, lx) + tile_x - 1) / tile_x;
        int64_t ty = (level_size(h, ly) + tile_y - 1) / tile_y;
        n_chunks += tx * ty;
      }
    if (n_chunks <= 0 || n_chunks > (int64_t)1 << 24) goto corrupt;
    if (multipart && P.chunk_count != n_chunks) goto corrupt;
    {
      std::vector<uint64_t> offsets(n_chunks);
      if (!r.read(offsets.data(), 8 * (size_t)n_chunks)) goto corrupt;
      for (int64_t b = 0; b < n_chunks; ++b) {
        if (fseek(r.f, (long)offsets[b], SEEK_SET) != 0) goto corrupt;
        if (multipart) {
          int32_t pnum;
          if (!r.get(&pnum) || pnum != sel) goto corrupt;
        }
        int32_t tdx, tdy, tlx, tly, dsize;
        if (!r.get(&tdx) || !r.get(&tdy) || !r.get(&tlx) || !r.get(&tly) ||
            !r.get(&dsize) || dsize < 0)
          goto corrupt;
        if (tlx != 0 || tly != 0) continue;  // only the full-res plane
        const int x0 = (int)((int64_t)tdx * tile_x);
        const int y0 = (int)((int64_t)tdy * tile_y);
        if (x0 < 0 || x0 >= w || y0 < 0 || y0 >= h) goto corrupt;
        const int bw = std::min((int)tile_x, w - x0);
        const int bh = std::min((int)tile_y, h - y0);
        size_t rb = 0;
        for (size_t c = 0; c < channels.size(); ++c)
          rb += (size_t)bw * ch_size[c];
        packed.resize(dsize);
        if (!r.read(packed.data(), dsize)) goto corrupt;
        if (!decode_chunk(compression, packed, bw, bh, rb, channels, &raw))
          goto corrupt;
        scatter(raw, x0, y0, bw, bh);
      }
    }
  }
  *out_rgb = rgb;
  *out_w = w;
  *out_h = h;
  return 0;
corrupt:
  std::free(rgb);
  return 5;
}

// Write [h*w*3] float32 RGB as a HALF scanline EXR.
// compression: 0 = NONE, 3 = ZIP, 4 = PIZ, 6 = B44 (lossy),
// 8 = DWAA / 9 = DWAB (lossy DCT, 32/256-line chunks).
// Returns 0 ok, 1 open, 4 unsupported.
// EXR RLE encode (inverse of rle_decode): runs of >= 3 equal bytes become
// (count-1, byte) with count <= 128; other bytes are literal chunks of at
// most 127 prefixed by -count.
static void rle_encode(const uint8_t* in, size_t n, std::vector<uint8_t>* out) {
  out->clear();
  size_t i = 0;
  while (i < n) {
    size_t run = 1;
    while (i + run < n && in[i + run] == in[i] && run < 128) ++run;
    if (run >= 3) {
      out->push_back((uint8_t)(run - 1));
      out->push_back(in[i]);
      i += run;
    } else {
      size_t lit = i;
      // Extend the literal until a run of >= 3 starts (or 127 reached).
      while (lit < n && lit - i < 127) {
        if (lit + 2 < n && in[lit] == in[lit + 1] && in[lit] == in[lit + 2])
          break;
        ++lit;
      }
      out->push_back((uint8_t)(int8_t)(-(int)(lit - i)));
      out->insert(out->end(), in + i, in + lit);
      i = lit;
    }
  }
}

// The ZIP/RLE pre-compression transform (inverse of exr_unfilter):
// de-interleave bytes into two halves, then delta-encode.
static void exr_filter(std::vector<uint8_t>& data) {
  std::vector<uint8_t> tmp(data.size());
  const size_t half = (data.size() + 1) / 2;
  for (size_t i = 0; i < data.size(); ++i)
    tmp[(i % 2) ? half + i / 2 : i / 2] = data[i];
  for (size_t i = tmp.size(); i-- > 1;)
    tmp[i] = (uint8_t)(tmp[i] - tmp[i - 1] + 128);
  data.swap(tmp);
}

// PXR24 pre-compression (inverse of pxr24_reconstruct, HALF channels):
// per line, per channel, per-pixel diffs of the 16-bit values split into
// high/low byte planes; the caller deflates the plane stream.
static void pxr24_planes_rgb(const uint16_t* rows, int w, int nlines,
                             std::vector<uint8_t>* planes) {
  planes->resize((size_t)nlines * 3 * 2 * w);
  uint8_t* dst = planes->data();
  for (int line = 0; line < nlines; ++line) {
    for (int c = 0; c < 3; ++c) {
      const uint16_t* p = rows + ((size_t)line * 3 + c) * w;
      uint16_t prev = 0;
      for (int x = 0; x < w; ++x) {
        uint16_t diff = (uint16_t)(p[x] - prev);
        prev = p[x];
        dst[x] = (uint8_t)(diff >> 8);
        dst[w + x] = (uint8_t)(diff & 0xFF);
      }
      dst += 2 * (size_t)w;
    }
  }
}

int vt_write_exr_c(const char* path, const float* rgb, int w, int h,
                   int compression) {
  if (compression < 0 || compression > 9 || compression == 7)
    return 4;  // B44A adds nothing over B44 for RGB-without-alpha
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  auto put = [&](const void* p, size_t n) { std::fwrite(p, 1, n, f); };
  auto put_str = [&](const char* s) { put(s, std::strlen(s) + 1); };
  auto put_attr = [&](const char* n, const char* t, const void* d, int32_t sz) {
    put_str(n);
    put_str(t);
    put(&sz, 4);
    put(d, sz);
  };
  uint32_t magic = kMagic, version = 2;
  put(&magic, 4);
  put(&version, 4);

  // chlist: B, G, R (alphabetical), HALF
  std::vector<uint8_t> chl;
  for (const char* cn : {"B", "G", "R"}) {
    for (const char* p = cn; *p; ++p) chl.push_back(*p);
    chl.push_back(0);
    int32_t vals[4] = {1 /*HALF*/, 0 /*pLinear+pad*/, 1, 1};
    const uint8_t* vp = (const uint8_t*)vals;
    chl.insert(chl.end(), vp, vp + 16);
  }
  chl.push_back(0);
  put_attr("channels", "chlist", chl.data(), (int32_t)chl.size());
  uint8_t comp = (uint8_t)compression;
  put_attr("compression", "compression", &comp, 1);
  int32_t box[4] = {0, 0, w - 1, h - 1};
  put_attr("dataWindow", "box2i", box, 16);
  put_attr("displayWindow", "box2i", box, 16);
  uint8_t lineorder = 0;
  put_attr("lineOrder", "lineOrder", &lineorder, 1);
  float par = 1.f;
  put_attr("pixelAspectRatio", "float", &par, 4);
  float swc[2] = {0.f, 0.f};
  put_attr("screenWindowCenter", "v2f", swc, 8);
  float sww = 1.f;
  put_attr("screenWindowWidth", "float", &sww, 4);
  uint8_t end = 0;
  put(&end, 1);

  const size_t row_bytes = (size_t)w * 2 * 3;  // 3 half channels
  const int lines_per_block =
      compression == 9
          ? 256
          : (compression == 4 || compression == 6 || compression == 8)
                ? 32
                : ((compression == 3 || compression == 5) ? 16 : 1);
  const int n_blocks = (h + lines_per_block - 1) / lines_per_block;

  // Prepare per-block payloads first (offset table precedes the data).
  std::vector<std::vector<uint8_t>> blocks(n_blocks);
  std::vector<uint16_t> rows((size_t)lines_per_block * 3 * w);
  for (int b = 0; b < n_blocks; ++b) {
    const int y0 = b * lines_per_block;
    const int nlines = std::min(lines_per_block, h - y0);
    const size_t want = row_bytes * (size_t)nlines;
    for (int line = 0; line < nlines; ++line) {
      const int y = y0 + line;
      uint16_t* row = rows.data() + (size_t)line * 3 * w;
      // channels alphabetical: B, G, R
      for (int x = 0; x < w; ++x)
        row[x] = float_to_half(rgb[(y * (size_t)w + x) * 3 + 2]);
      for (int x = 0; x < w; ++x)
        row[w + x] = float_to_half(rgb[(y * (size_t)w + x) * 3 + 1]);
      for (int x = 0; x < w; ++x)
        row[2 * w + x] = float_to_half(rgb[(y * (size_t)w + x) * 3]);
    }
    if (compression == 6) {  // B44: always block-coded (lossy)
      std::vector<uint8_t> out;
      b44_compress(rows.data(), w, nlines, &out);
      if (out.size() >= want)
        out.assign((const uint8_t*)rows.data(),
                   (const uint8_t*)rows.data() + want);
      blocks[b].swap(out);
    } else if (compression == 8 || compression == 9) {  // DWAA / DWAB
      std::vector<uint8_t> out;
      if (!dwa_compress_rgb(rows.data(), w, nlines, &out, 1e-3f) ||
          out.size() >= want)
        out.assign((const uint8_t*)rows.data(),
                   (const uint8_t*)rows.data() + want);
      blocks[b].swap(out);
    } else if (compression == 4) {
      const int ch_shorts[3] = {1, 1, 1};
      std::vector<uint8_t> out;
      if (!piz_compress((const uint8_t*)rows.data(), w, nlines, ch_shorts, 3,
                        &out) ||
          out.size() >= want) {
        // Fallback: store the raw bytes (readers treat dsize >= want as raw).
        out.assign((const uint8_t*)rows.data(),
                   (const uint8_t*)rows.data() + want);
      }
      blocks[b].swap(out);
    } else if (compression == 2 || compression == 3) {  // ZIPS/ZIP
      std::vector<uint8_t> tmp((const uint8_t*)rows.data(),
                               (const uint8_t*)rows.data() + want);
      exr_filter(tmp);
      uLongf dst_len = compressBound((uLong)tmp.size());
      std::vector<uint8_t> out(dst_len);
      if (compress(out.data(), &dst_len, tmp.data(), (uLong)tmp.size()) !=
              Z_OK ||
          dst_len >= want) {
        out.assign((const uint8_t*)rows.data(),
                   (const uint8_t*)rows.data() + want);
      } else {
        out.resize(dst_len);
      }
      blocks[b].swap(out);
    } else if (compression == 1) {  // RLE: filter + run-length
      std::vector<uint8_t> tmp((const uint8_t*)rows.data(),
                               (const uint8_t*)rows.data() + want);
      exr_filter(tmp);
      std::vector<uint8_t> out;
      rle_encode(tmp.data(), tmp.size(), &out);
      if (out.size() >= want)
        out.assign((const uint8_t*)rows.data(),
                   (const uint8_t*)rows.data() + want);
      blocks[b].swap(out);
    } else if (compression == 5) {  // PXR24: byte planes + deflate
      std::vector<uint8_t> planes;
      pxr24_planes_rgb(rows.data(), w, nlines, &planes);
      uLongf dst_len = compressBound((uLong)planes.size());
      std::vector<uint8_t> out(dst_len);
      if (compress(out.data(), &dst_len, planes.data(),
                   (uLong)planes.size()) != Z_OK ||
          dst_len >= want) {
        out.assign((const uint8_t*)rows.data(),
                   (const uint8_t*)rows.data() + want);
      } else {
        out.resize(dst_len);
      }
      blocks[b].swap(out);
    } else {
      blocks[b].assign((const uint8_t*)rows.data(),
                       (const uint8_t*)rows.data() + want);
    }
  }

  const uint64_t table_pos = (uint64_t)ftell(f);
  uint64_t off = table_pos + 8ull * n_blocks;
  for (int b = 0; b < n_blocks; ++b) {
    put(&off, 8);
    off += 8 + blocks[b].size();
  }
  for (int b = 0; b < n_blocks; ++b) {
    int32_t yy = b * lines_per_block;
    int32_t sz = (int32_t)blocks[b].size();
    put(&yy, 4);
    put(&sz, 4);
    put(blocks[b].data(), blocks[b].size());
  }
  std::fclose(f);
  return 0;
}

// Back-compatible uncompressed writer.
int vt_write_exr(const char* path, const float* rgb, int w, int h) {
  return vt_write_exr_c(path, rgb, w, h, 0);
}

}  // extern "C"
}  // namespace vtrace
