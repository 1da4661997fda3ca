// DWAA / DWAB decoder (OpenEXR compression 8 / 9).
//
// The reference ingests arbitrary EXRs through the OpenEXR library
// (src/NGLScene.cpp:205-231); DWA is the last codec family the
// dependency-free reader was missing.  Written from the OpenEXR data
// format, with every layout detail cross-checked against files produced
// by the SYSTEM OpenEXR library (tests/test_exr_golden.py):
//
//   header: 11 little-endian uint64s —
//     version, unknownUncompressedSize, unknownCompressedSize,
//     acCompressedSize, dcCompressedSize, rleCompressedSize,
//     rleUncompressedSize, rleRawSize, totalAcUncompressedCount,
//     totalDcUncompressedCount, acCompression (0 = the PIZ Huffman
//     codec, 1 = deflate)
//   version >= 2: serialized channel-classification rules —
//     uint16 total byte size (self-inclusive), then per rule:
//     name '\0', value byte (bits 7..4: cscIdx+1, 3..2: scheme
//     0 UNKNOWN / 1 LOSSY_DCT / 2 RLE, 0: case-insensitive), type byte
//     (0 UINT / 1 HALF / 2 FLOAT)
//   streams, in order: AC, DC, RLE, UNKNOWN
//
// LOSSY_DCT channels quantize 8x8 blocks of a pseudo-perceptual transfer
// of the pixels: nonlinear(x) = sign(x) * (|x| <= 1 ? |x|^(1/2.2)
//                                                   : 1 + ln|x|/2.2)
// (verified against library output across four decades, half-exact).
// R/G/B channel triples are additionally rotated to Y Cb Cr (BT.709
// analog: Y = .2126 R' + .7152 G' + .0722 B', Cb = (B'-Y)/1.8556,
// Cr = (R'-Y)/1.5748) AFTER the transfer curve.  Per 8x8 block the DC
// coefficient (orthonormal scale: DC = 8 * mean) lives in the DC stream
// (deflate + the EXR delta/interleave filter, planes in set order Y Cb
// Cr); the 63 AC coefficients are zigzag-ordered halfs in the AC stream
// with 0xFFxx tokens encoding zero runs.  Decode: coefficients -> IDCT
// -> inverse CSC -> half -> inverse transfer -> output half.
//
// RLE-schemed channels (e.g. alpha) deflate + EXR-RLE + byte-plane
// deinterleave; UNKNOWN channels are deflated raw planes.

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace vtrace {

bool vt_huf_uncompress(const uint8_t* in, size_t in_len, uint16_t* raw,
                       size_t n_raw);  // csrc/piz.cc
bool vt_huf_compress(const uint16_t* raw, size_t n,
                     std::vector<uint8_t>* out);  // csrc/piz.cc
float vt_half_to_float(uint16_t h);   // csrc/exr.cc
uint16_t vt_float_to_half(float f);   // csrc/exr.cc
void vt_exr_unfilter(std::vector<uint8_t>& data);          // csrc/exr.cc
bool vt_exr_rle_decode(const uint8_t* in, size_t n, size_t want,
                       std::vector<uint8_t>* out);         // csrc/exr.cc

namespace {

inline float half_to_float(uint16_t h) { return vt_half_to_float(h); }
inline uint16_t float_to_half(float f) { return vt_float_to_half(f); }

// DWA transfer curve (see module comment).
float to_linear(float x) {
  double a = std::fabs((double)x);
  double y = a <= 1.0 ? std::pow(a, 2.2) : std::exp(2.2 * (a - 1.0));
  return (float)(x < 0 ? -y : y);
}

// ---- small stream helpers --------------------------------------------------

bool inflate_to(const uint8_t* in, size_t n, std::vector<uint8_t>* out,
                size_t want) {
  out->assign(want, 0);
  if (want == 0) return n == 0;
  uLongf dlen = (uLongf)want;
  if (uncompress(out->data(), &dlen, in, (uLong)n) != Z_OK) return false;
  return dlen == want;
}

// JPEG zigzag order: zigzag[i] = raster index of the i-th coefficient.
constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Orthonormal 8x8 inverse DCT-II (JPEG normalization: DC = 8 * mean).
struct DctBasis {
  double b[8][8];  // b[u][x] = C(u) * cos((2x+1) u pi / 16)
  DctBasis() {
    for (int u = 0; u < 8; ++u) {
      double cu = u == 0 ? 1.0 / std::sqrt(2.0) : 1.0;
      for (int x = 0; x < 8; ++x)
        b[u][x] = cu * std::cos((2 * x + 1) * u * M_PI / 16.0);
    }
  }
};

void idct8x8(const float* F, float* out) {
  // Magic static: thread-safe init (ctypes releases the GIL, so two
  // Python threads can decode concurrently).
  static const DctBasis kb;
  const auto& basis = kb.b;
  double tmp[64];
  for (int y = 0; y < 8; ++y)  // rows: over u
    for (int x = 0; x < 8; ++x) {
      double s = 0;
      for (int u = 0; u < 8; ++u) s += F[y * 8 + u] * basis[u][x];
      tmp[y * 8 + x] = s * 0.5;
    }
  for (int x = 0; x < 8; ++x)  // cols: over v
    for (int y = 0; y < 8; ++y) {
      double s = 0;
      for (int v = 0; v < 8; ++v) s += tmp[v * 8 + x] * basis[v][y];
      out[y * 8 + x] = (float)(s * 0.5);
    }
}

struct Rule {
  std::string suffix;
  int scheme = 0;  // 0 UNKNOWN, 1 LOSSY_DCT, 2 RLE
  int csc = -1;    // 0 R, 1 G, 2 B within a color set
  int type = 1;    // 0 UINT, 1 HALF, 2 FLOAT
};

}  // namespace

// Decode one DWA chunk into the standard raw scanline layout (per line,
// channels in file order).  `ch_names`/`ch_types` follow the file channel
// list; HALF and FLOAT channels decode under LOSSY_DCT/UNKNOWN (FLOAT
// lossy output is the library's half-LUT value widened); RLE is
// HALF-only.
bool dwa_uncompress(const uint8_t* in, size_t in_len, int w, int nlines,
                    const std::vector<std::string>& ch_names,
                    const std::vector<int>& ch_types, uint8_t* out,
                    size_t out_size) {
  const int n_ch = (int)ch_names.size();
  if (in_len < 88) return false;
  uint64_t hdr[11];
  std::memcpy(hdr, in, 88);
  const uint64_t version = hdr[0], unk_unc = hdr[1], unk_cmp = hdr[2],
                 ac_cmp = hdr[3], dc_cmp = hdr[4], rle_cmp = hdr[5],
                 rle_unc = hdr[6], rle_raw = hdr[7], ac_cnt = hdr[8],
                 dc_cnt = hdr[9], ac_scheme = hdr[10];
  if (version > 2 || ac_scheme > 1) return false;
  size_t p = 88;

  std::vector<Rule> rules;
  if (version >= 2) {
    if (p + 2 > in_len) return false;
    uint16_t rs;
    std::memcpy(&rs, in + p, 2);
    if (rs < 2 || p + rs > in_len) return false;
    size_t rp = p + 2, rend = p + rs;
    while (rp < rend) {
      Rule r;
      while (rp < rend && in[rp] != 0) r.suffix.push_back((char)in[rp++]);
      if (rp + 3 > rend) return false;
      ++rp;  // NUL
      uint8_t v = in[rp++];
      r.csc = (int)(v >> 4) - 1;
      r.scheme = (v >> 2) & 3;
      r.type = in[rp++];  // rule pixel type (rules are per name AND type)
      rules.push_back(std::move(r));
    }
    p = rend;
  }
  // Every size/count is attacker-controlled: bound each individually
  // against the input and the pixel budget BEFORE any allocation (a sum
  // can wrap in uint64, and with -fno-exceptions an oversized vector
  // aborts the process instead of surfacing error 5).
  const int nbx = (w + 7) / 8, nby = (nlines + 7) / 8;
  const size_t n_blocks = (size_t)nbx * nby;
  const size_t max_plane_bytes = (size_t)n_ch * w * nlines * 4 + 64;
  if (ac_cmp > in_len || dc_cmp > in_len || rle_cmp > in_len ||
      unk_cmp > in_len)
    return false;
  if (p + ac_cmp > in_len || p + ac_cmp + dc_cmp > in_len ||
      p + ac_cmp + dc_cmp + rle_cmp > in_len ||
      p + ac_cmp + dc_cmp + rle_cmp + unk_cmp > in_len)
    return false;
  if (ac_cnt > (size_t)n_ch * n_blocks * 64 ||
      dc_cnt > (size_t)n_ch * n_blocks || rle_raw > max_plane_bytes ||
      rle_unc > 2 * max_plane_bytes || unk_unc > max_plane_bytes)
    return false;
  const uint8_t* ac_ptr = in + p;
  const uint8_t* dc_ptr = ac_ptr + ac_cmp;
  const uint8_t* rle_ptr = dc_ptr + dc_cmp;
  const uint8_t* unk_ptr = rle_ptr + rle_cmp;

  // ---- streams ----
  std::vector<uint16_t> ac(ac_cnt);
  if (ac_cnt) {
    if (ac_scheme == 0) {
      if (!vt_huf_uncompress(ac_ptr, ac_cmp, ac.data(), ac_cnt)) return false;
    } else {
      std::vector<uint8_t> b;
      if (!inflate_to(ac_ptr, ac_cmp, &b, ac_cnt * 2)) return false;
      std::memcpy(ac.data(), b.data(), b.size());
    }
  }
  std::vector<uint8_t> dc;
  if (dc_cnt) {
    if (!inflate_to(dc_ptr, dc_cmp, &dc, dc_cnt * 2)) return false;
    vt_exr_unfilter(dc);
  }
  std::vector<uint8_t> rle;
  if (rle_raw) {
    std::vector<uint8_t> tmp;
    if (!inflate_to(rle_ptr, rle_cmp, &tmp, rle_unc)) return false;
    if (!vt_exr_rle_decode(tmp.data(), tmp.size(), rle_raw, &rle))
      return false;
  }
  std::vector<uint8_t> unk;
  if (unk_unc && !inflate_to(unk_ptr, unk_cmp, &unk, unk_unc)) return false;

  // ---- classify channels -------------------------------------------------
  // Rules are keyed by (name suffix, pixel type); FLOAT channels can be
  // LOSSY_DCT too (the library DCTs them through the same half
  // coefficients and widens on output).  FLOAT under the RLE scheme has
  // no defined layout here — refuse rather than decode garbage.
  std::vector<int> scheme(n_ch, 0), csc(n_ch, -1);
  for (int c = 0; c < n_ch; ++c) {
    const std::string& n = ch_names[c];
    std::string suffix = n.substr(n.find_last_of('.') + 1);
    for (const Rule& r : rules)
      if (suffix == r.suffix && r.type == ch_types[c]) {
        scheme[c] = r.scheme;
        csc[c] = r.csc;
        break;
      }
    if (scheme[c] == 2 && ch_types[c] != 1) return false;
  }
  // Complete R/G/B sets (one per layer prefix; file order otherwise).
  std::vector<int> set_of(n_ch, -1);
  std::vector<std::vector<int>> sets;  // members by csc index 0,1,2
  for (int c = 0; c < n_ch; ++c) {
    if (scheme[c] != 1 || csc[c] < 0 || set_of[c] >= 0) continue;
    std::string prefix = ch_names[c].substr(0, ch_names[c].find_last_of('.') + 1);
    std::vector<int> members(3, -1);
    for (int d = 0; d < n_ch; ++d)
      if (scheme[d] == 1 && csc[d] >= 0 && csc[d] < 3 &&
          ch_names[d].substr(0, ch_names[d].find_last_of('.') + 1) == prefix)
        members[csc[d]] = d;
    if (members[0] >= 0 && members[1] >= 0 && members[2] >= 0) {
      for (int m : members) set_of[m] = (int)sets.size();
      sets.push_back(members);
    }
  }

  // ---- LOSSY_DCT planes ----------------------------------------------------
  const size_t plane_px = n_blocks * 64;
  size_t ac_pos = 0, dc_pos = 0;

  size_t row_bytes = 0;
  std::vector<size_t> ch_off(n_ch);  // byte offset of channel c in a line
  for (int c = 0; c < n_ch; ++c) {
    ch_off[c] = row_bytes;
    row_bytes += (size_t)w * (ch_types[c] == 1 ? 2 : 4);
  }
  if (out_size != row_bytes * nlines) return false;
  std::memset(out, 0, out_size);

  // Stream shapes (cross-checked against library token dumps): the DC
  // stream is PLANAR — one n_blocks plane of halfs per lossy channel, in
  // processing order — while the AC stream is BLOCK-MAJOR with the set's
  // channels interleaved: for each block, channel 0's tokens, then
  // channel 1's, then channel 2's.
  auto decode_block = [&](size_t dc_plane_base, size_t b,
                          float* out64) -> bool {
    float F[64] = {0};
    size_t dcp = (dc_plane_base + b) * 2;
    if (dcp + 2 > dc.size()) return false;
    uint16_t dc_h;
    std::memcpy(&dc_h, dc.data() + dcp, 2);
    F[0] = half_to_float(dc_h);
    int pos = 1;
    while (pos < 64) {
      if (ac_pos >= ac.size()) return false;
      uint16_t v = ac[ac_pos++];
      if ((v & 0xFF00) == 0xFF00) {
        int run = v & 0xFF;
        pos += run == 0 ? (64 - pos) : run;
      } else {
        F[kZigzag[pos]] = half_to_float(v);
        ++pos;
      }
    }
    idct8x8(F, out64);
    return true;
  };

  auto store_half = [&](int c, int x, int y, uint16_t h) {
    std::memcpy(out + (size_t)y * row_bytes + ch_off[c] + (size_t)x * 2, &h, 2);
  };
  // Lossy-channel store: the decoded value is the half the library's LUT
  // produces; FLOAT channels receive that half widened to float32.
  auto store_lossy = [&](int c, int x, int y, float v) {
    uint16_t h = float_to_half(to_linear(half_to_float(float_to_half(v))));
    if (ch_types[c] == 1) {
      std::memcpy(out + (size_t)y * row_bytes + ch_off[c] + (size_t)x * 2,
                  &h, 2);
    } else {
      float f = half_to_float(h);
      std::memcpy(out + (size_t)y * row_bytes + ch_off[c] + (size_t)x * 4,
                  &f, 4);
    }
  };

  std::vector<std::vector<float>> planes;  // scratch per set
  std::vector<bool> done(n_ch, false);
  for (int c = 0; c < n_ch; ++c) {
    if (done[c] || scheme[c] != 1) continue;
    if (set_of[c] >= 0) {
      const std::vector<int>& m = sets[set_of[c]];
      planes.assign(3, std::vector<float>(plane_px, 0.0f));
      for (size_t b = 0; b < n_blocks; ++b)
        for (int k = 0; k < 3; ++k)
          if (!decode_block(dc_pos + (size_t)k * n_blocks, b,
                            planes[k].data() + b * 64))
            return false;
      dc_pos += 3 * n_blocks;
      for (int k = 0; k < 3; ++k) done[m[k]] = true;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          size_t base = ((size_t)by * nbx + bx) * 64;
          for (int i = 0; i < 64; ++i) {
            int x = bx * 8 + i % 8, y = by * 8 + i / 8;
            if (x >= w || y >= nlines) continue;
            float Y = planes[0][base + i];
            float Cb = planes[1][base + i];
            float Cr = planes[2][base + i];
            float R = Y + 1.5747f * Cr;
            float G = Y - 0.1873f * Cb - 0.4682f * Cr;
            float B = Y + 1.8556f * Cb;
            const float rgb[3] = {R, G, B};
            for (int k = 0; k < 3; ++k) store_lossy(m[k], x, y, rgb[k]);
          }
        }
    } else {
      std::vector<float> plane(plane_px, 0.0f);
      for (size_t b = 0; b < n_blocks; ++b)
        if (!decode_block(dc_pos, b, plane.data() + b * 64)) return false;
      dc_pos += n_blocks;
      done[c] = true;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          size_t base = ((size_t)by * nbx + bx) * 64;
          for (int i = 0; i < 64; ++i) {
            int x = bx * 8 + i % 8, y = by * 8 + i / 8;
            if (x >= w || y >= nlines) continue;
            store_lossy(c, x, y, plane[base + i]);
          }
        }
    }
  }

  // ---- RLE channels: byte planes (high then low), per channel ------------
  size_t rle_pos = 0;
  for (int c = 0; c < n_ch; ++c) {
    if (scheme[c] != 2) continue;
    size_t n_px = (size_t)w * nlines;
    if (rle_pos + 2 * n_px > rle.size()) return false;
    const uint8_t* hi = rle.data() + rle_pos;
    const uint8_t* lo = hi + n_px;
    for (int y = 0; y < nlines; ++y)
      for (int x = 0; x < w; ++x) {
        size_t i = (size_t)y * w + x;
        uint16_t h = (uint16_t)(((uint16_t)hi[i] << 8) | lo[i]);
        store_half(c, x, y, h);
      }
    rle_pos += 2 * n_px;
  }

  // ---- UNKNOWN channels: raw planes in file order -------------------------
  size_t unk_pos = 0;
  for (int c = 0; c < n_ch; ++c) {
    if (scheme[c] != 0) continue;
    size_t sz = (size_t)w * nlines * (ch_types[c] == 1 ? 2 : 4);
    if (unk_pos + sz > unk.size()) {
      if (unk.empty()) continue;  // tolerated: channel stays zero
      return false;
    }
    size_t px_bytes = ch_types[c] == 1 ? 2 : 4;
    for (int y = 0; y < nlines; ++y)
      std::memcpy(out + (size_t)y * row_bytes + ch_off[c],
                  unk.data() + unk_pos + (size_t)y * w * px_bytes,
                  (size_t)w * px_bytes);
    unk_pos += sz;
  }
  return true;
}

namespace {

// Forward transfer curve (inverse of to_linear).
float to_nonlinear(float x) {
  double a = std::fabs((double)x);
  double y = a <= 1.0 ? std::pow(a, 1.0 / 2.2) : 1.0 + std::log(a) / 2.2;
  return (float)(x < 0 ? -y : y);
}

// Orthonormal forward 8x8 DCT-II (transpose of idct8x8).
void dct8x8(const float* px, float* F) {
  static const DctBasis kb;  // magic static: thread-safe init
  const auto& basis = kb.b;
  double tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += px[y * 8 + x] * basis[u][x];
      tmp[y * 8 + u] = s * 0.5;
    }
  for (int u = 0; u < 8; ++u)
    for (int v = 0; v < 8; ++v) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += tmp[y * 8 + u] * basis[v][y];
      F[v * 8 + u] = (float)(s * 0.5);
    }
}

void zip_filter(std::vector<uint8_t>& d) {  // inverse of unfilter
  std::vector<uint8_t> t(d.size());
  const size_t half = (d.size() + 1) / 2;
  for (size_t i = 0; i < d.size(); ++i)
    t[(i & 1) ? half + i / 2 : i / 2] = d[i];
  for (size_t i = t.size(); i-- > 1;)
    t[i] = (uint8_t)(t[i] - t[i - 1] + 128);
  d.swap(t);
}

bool deflate_vec(const std::vector<uint8_t>& in, std::vector<uint8_t>* out) {
  uLongf dlen = compressBound((uLong)in.size());
  out->resize(dlen);
  if (compress(out->data(), &dlen, in.data(), (uLong)in.size()) != Z_OK)
    return false;
  out->resize(dlen);
  return true;
}

}  // namespace

// Encode `nlines` rows of 3 interleaved-by-plane HALF channels (the
// writer's layout: per line, B plane then G then R) as one DWA chunk.
// Mirrors the decoder's verified stream layout; quantization is a simple
// small-coefficient threshold (|ac| < `quant` in nonlinear space is
// dropped) — files are somewhat larger than the library's
// candidate-search encoder produces, but decode identically through both
// readers (tests/test_exr_golden.py cross-reads them).
bool dwa_compress_rgb(const uint16_t* rows, int w, int nlines,
                      std::vector<uint8_t>* out, float quant) {
  const int nbx = (w + 7) / 8, nby = (nlines + 7) / 8;
  const size_t n_blocks = (size_t)nbx * nby;
  const size_t plane_px = n_blocks * 64;

  // Transfer curve + CSC forward into padded Y/Cb/Cr planes
  // (edge-replicated so edge blocks stay smooth).
  std::vector<float> Y(plane_px), Cb(plane_px), Cr(plane_px);
  for (int by = 0; by < nby; ++by)
    for (int bx = 0; bx < nbx; ++bx)
      for (int i = 0; i < 64; ++i) {
        int x = bx * 8 + i % 8, y = by * 8 + i / 8;
        if (x >= w) x = w - 1;
        if (y >= nlines) y = nlines - 1;
        float B = to_nonlinear(half_to_float(rows[((size_t)y * 3) * w + x]));
        float G =
            to_nonlinear(half_to_float(rows[((size_t)y * 3 + 1) * w + x]));
        float R =
            to_nonlinear(half_to_float(rows[((size_t)y * 3 + 2) * w + x]));
        float yy = 0.2126f * R + 0.7152f * G + 0.0722f * B;
        size_t o = ((size_t)by * nbx + bx) * 64 + i;
        Y[o] = yy;
        Cb[o] = (B - yy) / 1.8556f;
        Cr[o] = (R - yy) / 1.5748f;
      }

  // DCT + quantize; DC planar, AC block-major channel-interleaved.
  std::vector<uint16_t> dc(3 * n_blocks);
  std::vector<uint16_t> ac;
  ac.reserve(n_blocks * 16);
  const float* planes[3] = {Y.data(), Cb.data(), Cr.data()};
  for (size_t b = 0; b < n_blocks; ++b)
    for (int k = 0; k < 3; ++k) {
      float F[64];
      dct8x8(planes[k] + b * 64, F);
      dc[k * n_blocks + b] = float_to_half(F[0]);
      int run = 0;
      for (int pos = 1; pos < 64; ++pos) {
        uint16_t h = float_to_half(F[kZigzag[pos]]);
        if ((h & 0x7FFF) == 0 || std::fabs(half_to_float(h)) < quant) {
          ++run;
          continue;
        }
        while (run > 0) {
          int r = run > 0xFE ? 0xFE : run;
          ac.push_back((uint16_t)(0xFF00 | r));
          run -= r;
        }
        ac.push_back(h);
      }
      if (run > 0) ac.push_back(0xFF00);  // zeros to end of block
    }

  // Streams.
  std::vector<uint8_t> ac_cmp;
  if (!vt_huf_compress(ac.data(), ac.size(), &ac_cmp)) return false;
  std::vector<uint8_t> dc_bytes((const uint8_t*)dc.data(),
                                (const uint8_t*)dc.data() + dc.size() * 2);
  zip_filter(dc_bytes);
  std::vector<uint8_t> dc_cmp;
  if (!deflate_vec(dc_bytes, &dc_cmp)) return false;

  // Header + rules (R/G/B LOSSY_DCT with csc indices 0/1/2, HALF).
  uint64_t hdr[11] = {2, 0, 0, ac_cmp.size(), dc_cmp.size(), 0, 0,
                      0, ac.size(), dc.size(), 0};
  const uint8_t rules[] = {
      14, 0,  // total size (self-inclusive)
      'R', 0, 0x14, 1, 'G', 0, 0x24, 1, 'B', 0, 0x34, 1,
  };
  out->clear();
  out->insert(out->end(), (const uint8_t*)hdr, (const uint8_t*)hdr + 88);
  out->insert(out->end(), rules, rules + sizeof(rules));
  out->insert(out->end(), ac_cmp.begin(), ac_cmp.end());
  out->insert(out->end(), dc_cmp.begin(), dc_cmp.end());
  return true;
}

}  // namespace vtrace
