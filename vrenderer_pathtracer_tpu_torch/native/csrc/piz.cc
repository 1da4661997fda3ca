// PIZ codec: wavelet + Huffman EXR compression (OpenEXR "piz" format).
//
// Written from the published format specification (OpenEXR
// "TechnicalIntroduction" + the PIZ data layout documented for
// ImfPizCompressor/ImfHuf/ImfWav): per 32-scanline block —
//
//   uint16 minNonZero, uint16 maxNonZero        (bitmap byte range)
//   uint8  bitmap[min..max]                     (bit v set => value v used)
//   int32  hufLength
//   uint8  hufData[hufLength]
//
// where the Huffman payload itself is
//
//   uint32 im, iM, tableLength, nBits, zero     (5 LE words)
//   packed 6-bit canonical code lengths for symbols im..iM
//     (59..62 = short zero runs of 2..5, 63 + 8 bits = long zero run)
//   MSB-first bitstream; decoded symbol iM acts as a run-length marker
//     (next 8 bits repeat the previous symbol)
//
// and the pixel path is: ushort view of each channel plane -> forward LUT
// (compacting the used-value set from the bitmap) -> 2-D integer wavelet
// (14-bit lossless lifting when the value range allows, mod-2^16
// otherwise) -> Huffman.  Decoding runs the exact inverse.  The reference
// ingests PIZ HDRIs through the OpenEXR library (src/NGLScene.cpp:205-231);
// this re-derivation keeps the repo dependency-free.
//
// Both directions are implemented so write_exr can emit PIZ and the codec
// is round-trip testable without external encoders.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace vtrace {
namespace {

constexpr int HUF_ENCBITS = 16;
constexpr int HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1;  // 65537
constexpr int HUF_DECBITS = 14;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;

constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;
constexpr int LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN;

constexpr int BITMAP_SIZE = 1 << (HUF_ENCBITS - 3);  // 8192 bytes

inline uint64_t huf_code(uint64_t h) { return h >> 6; }
inline int huf_length(uint64_t h) { return (int)(h & 63); }

// ---- bit IO --------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t c = 0;
  int lc = 0;
  void put(int nbits, uint64_t bits) {
    c = (c << nbits) | bits;
    lc += nbits;
    while (lc >= 8) {
      lc -= 8;
      out->push_back((uint8_t)(c >> lc));
    }
  }
  void flush() {
    if (lc > 0) {
      out->push_back((uint8_t)(c << (8 - lc)));
      lc = 0;
    }
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t c = 0;
  int lc = 0;
  bool get(int nbits, uint64_t* bits) {
    while (lc < nbits) {
      if (p >= end) return false;
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= nbits;
    *bits = (c >> lc) & ((1ull << nbits) - 1);
    return true;
  }
};

// ---- canonical code construction (shared by encoder and decoder) --------

void canonical_code_table(uint64_t* hcode) {
  uint64_t n[59] = {0};
  for (int i = 0; i < HUF_ENCSIZE; ++i) n[hcode[i] & 63] += 1;
  // Assign consecutive codes, longest codes first at value 0.
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    int l = (int)(hcode[i] & 63);
    if (l > 0) hcode[i] = (uint64_t)l | (n[l]++ << 6);
  }
}

// ---- code-length table packing ------------------------------------------

void pack_enc_table(const uint64_t* hcode, int im, int iM, BitWriter* w) {
  for (int i = im; i <= iM; ++i) {
    int l = huf_length(hcode[i]);
    if (l == 0) {
      int zerun = 1;
      while (i < iM && zerun < LONGEST_LONG_RUN) {
        if (huf_length(hcode[i + 1]) != 0) break;
        ++i;
        ++zerun;
      }
      if (zerun >= 2) {
        if (zerun >= SHORTEST_LONG_RUN) {
          w->put(6, LONG_ZEROCODE_RUN);
          w->put(8, (uint64_t)(zerun - SHORTEST_LONG_RUN));
        } else {
          w->put(6, (uint64_t)(SHORT_ZEROCODE_RUN + zerun - 2));
        }
      } else {
        w->put(6, 0);
      }
    } else {
      w->put(6, (uint64_t)l);
    }
  }
}

bool unpack_enc_table(BitReader* r, int im, int iM, uint64_t* hcode) {
  std::memset(hcode, 0, sizeof(uint64_t) * HUF_ENCSIZE);
  for (int i = im; i <= iM;) {
    uint64_t l;
    if (!r->get(6, &l)) return false;
    if (l == LONG_ZEROCODE_RUN) {
      uint64_t z;
      if (!r->get(8, &z)) return false;
      int zerun = (int)z + SHORTEST_LONG_RUN;
      if (i + zerun > iM + 1) return false;
      i += zerun;
    } else if (l >= SHORT_ZEROCODE_RUN) {
      int zerun = (int)l - SHORT_ZEROCODE_RUN + 2;
      if (i + zerun > iM + 1) return false;
      i += zerun;
    } else {
      hcode[i++] = l;
    }
  }
  // Partial byte between table and bitstream is NOT flushed in the format;
  // the caller keeps reading from the same BitReader.
  canonical_code_table(hcode);
  return true;
}

// ---- decoding table ------------------------------------------------------

struct HufDec {
  int len = 0;
  int lit = 0;
  std::vector<int> p;  // long-code candidates
};

bool build_dec_table(const uint64_t* hcode, int im, int iM,
                     std::vector<HufDec>* table) {
  table->assign(HUF_DECSIZE, HufDec());
  for (int i = im; i <= iM; ++i) {
    uint64_t c = huf_code(hcode[i]);
    int l = huf_length(hcode[i]);
    if (l == 0) continue;
    if (c >> l) return false;  // code longer than its length
    if (l > HUF_DECBITS) {
      HufDec& d = (*table)[(c >> (l - HUF_DECBITS)) & HUF_DECMASK];
      if (d.len) return false;  // clash with a short code
      d.p.push_back(i);
    } else {
      HufDec* d = &(*table)[(c << (HUF_DECBITS - l)) & HUF_DECMASK];
      int n = 1 << (HUF_DECBITS - l);
      for (int j = 0; j < n; ++j, ++d) {
        if (d->len || !d->p.empty()) return false;
        d->len = l;
        d->lit = i;
      }
    }
  }
  return true;
}

// ---- huffman encode ------------------------------------------------------

// Simple two-queue Huffman on the used symbols; falls back to equal-length
// codes if the tree would exceed the 58-bit packing limit (vanishingly
// rare).  Any valid canonical prefix code decodes correctly.
void build_code_lengths(const uint64_t* freq, int im, int iM,
                        uint64_t* hcode) {
  std::memset(hcode, 0, sizeof(uint64_t) * HUF_ENCSIZE);
  struct Node {
    uint64_t f;
    std::vector<int> syms;
  };
  std::vector<Node> leaves;
  for (int i = im; i <= iM; ++i)
    if (freq[i]) leaves.push_back({freq[i], {i}});
  if (leaves.empty()) return;
  if (leaves.size() == 1) {
    hcode[leaves[0].syms[0]] = 1;
    return;
  }
  std::sort(leaves.begin(), leaves.end(),
            [](const Node& a, const Node& b) { return a.f < b.f; });
  // Two-queue merge: leaves (sorted) + internal nodes (created in
  // non-decreasing order).
  std::vector<Node> internal;
  size_t li = 0, ii = 0;
  auto take = [&]() -> Node {
    if (li < leaves.size() &&
        (ii >= internal.size() || leaves[li].f <= internal[ii].f))
      return std::move(leaves[li++]);
    return std::move(internal[ii++]);
  };
  while ((leaves.size() - li) + (internal.size() - ii) > 1) {
    Node a = take();
    Node b = take();
    for (int s : a.syms) hcode[s] += 1;
    for (int s : b.syms) hcode[s] += 1;
    Node m{a.f + b.f, {}};
    m.syms.reserve(a.syms.size() + b.syms.size());
    m.syms.insert(m.syms.end(), a.syms.begin(), a.syms.end());
    m.syms.insert(m.syms.end(), b.syms.begin(), b.syms.end());
    internal.push_back(std::move(m));
  }
  uint64_t maxlen = 0;
  for (int i = im; i <= iM; ++i) maxlen = hcode[i] > maxlen ? hcode[i] : maxlen;
  if (maxlen > 58) {
    // Equal-length fallback: ceil(log2(n)) bits for every used symbol.
    int n_used = 0;
    for (int i = im; i <= iM; ++i)
      if (freq[i]) ++n_used;
    int l = 1;
    while ((1 << l) < n_used) ++l;
    for (int i = im; i <= iM; ++i) hcode[i] = freq[i] ? (uint64_t)l : 0;
  }
}

void output_code(BitWriter* w, uint64_t hc) {
  w->put(huf_length(hc), huf_code(hc));
}

void send_run(BitWriter* w, uint64_t scode, uint64_t rlcode, int run) {
  // Emit the symbol once, then (rl marker, 8-bit count) when shorter.
  if (huf_length(scode) + huf_length(rlcode) + 8 <
      huf_length(scode) * (run + 1)) {
    output_code(w, scode);
    output_code(w, rlcode);
    w->put(8, (uint64_t)run);
  } else {
    for (int i = 0; i <= run; ++i) output_code(w, scode);
  }
}

// Compress `n` ushort symbols into `out`. Returns false only on internal
// error (never for valid input).
bool huf_compress(const uint16_t* raw, size_t n, std::vector<uint8_t>* out) {
  if (n == 0) return true;
  std::vector<uint64_t> freq(HUF_ENCSIZE, 0);
  for (size_t i = 0; i < n; ++i) freq[raw[i]] += 1;
  // Reserve the top symbol (65536, never a data value) as the run-length
  // marker so a literal data symbol can never collide with it.
  freq[HUF_ENCSIZE - 1] = 1;
  int im = 0;
  while (!freq[im]) ++im;
  int iM = HUF_ENCSIZE - 1;

  std::vector<uint64_t> hcode(HUF_ENCSIZE);
  build_code_lengths(freq.data(), im, iM, hcode.data());
  canonical_code_table(hcode.data());

  size_t head = out->size();
  out->resize(head + 20);  // im, iM, tableLength, nBits, zero

  BitWriter tw{out};
  pack_enc_table(hcode.data(), im, iM, &tw);
  tw.flush();
  uint32_t table_len = (uint32_t)(out->size() - head - 20);

  BitWriter bw{out};
  size_t bits_start = out->size();
  uint64_t rl = hcode[iM];
  int run = 0;
  uint16_t prev = raw[0];
  for (size_t i = 1; i <= n; ++i) {
    if (i < n && raw[i] == prev && run < 255) {
      ++run;
    } else {
      send_run(&bw, hcode[prev], rl, run);
      run = 0;
      if (i < n) prev = raw[i];
    }
  }
  uint32_t n_bits =
      (uint32_t)((out->size() - bits_start) * 8 + bw.lc);
  bw.flush();

  uint8_t* h = out->data() + head;
  uint32_t words[5] = {(uint32_t)im, (uint32_t)iM, table_len, n_bits, 0};
  std::memcpy(h, words, 20);
  return true;
}

bool huf_uncompress(const uint8_t* in, size_t in_len, uint16_t* raw,
                    size_t n_raw) {
  if (n_raw == 0) return true;
  if (in_len < 20) return false;
  uint32_t words[5];
  std::memcpy(words, in, 20);
  int im = (int)words[0], iM = (int)words[1];
  uint32_t n_bits = words[3];
  if (im < 0 || im >= HUF_ENCSIZE || iM < 0 || iM >= HUF_ENCSIZE || im > iM)
    return false;

  BitReader r{in + 20, in + in_len};
  std::vector<uint64_t> hcode(HUF_ENCSIZE);
  if (!unpack_enc_table(&r, im, iM, hcode.data())) return false;
  // The bitstream begins on the byte boundary after the packed table.
  size_t table_len = words[2];
  if (20 + table_len > in_len) return false;
  BitReader br{in + 20 + table_len, in + in_len};
  if ((size_t)(br.end - br.p) * 8 < n_bits) return false;

  std::vector<HufDec> table;
  if (!build_dec_table(hcode.data(), im, iM, &table)) return false;

  size_t out = 0;
  uint64_t c = 0;
  int lc = 0;
  const uint8_t* p = br.p;
  const uint8_t* in_end = p + (n_bits + 7) / 8;

  auto emit = [&](int s) -> bool {
    if (s == iM) {  // run-length marker: repeat previous symbol
      if (lc < 8) {
        if (p >= in_end) return false;
        c = (c << 8) | *p++;
        lc += 8;
      }
      lc -= 8;
      int cnt = (int)((c >> lc) & 0xFF);
      if (out == 0 || out + cnt > n_raw) return false;
      uint16_t v = raw[out - 1];
      for (int i = 0; i < cnt; ++i) raw[out++] = v;
    } else {
      if (out >= n_raw) return false;
      raw[out++] = (uint16_t)s;
    }
    return true;
  };

  while (p < in_end) {
    c = (c << 8) | *p++;
    lc += 8;
    while (lc >= HUF_DECBITS) {
      const HufDec& d = table[(c >> (lc - HUF_DECBITS)) & HUF_DECMASK];
      if (d.len) {
        lc -= d.len;
        if (!emit(d.lit)) return false;
      } else if (!d.p.empty()) {
        bool found = false;
        for (int j : d.p) {
          int l = huf_length(hcode[j]);
          while (lc < l && p < in_end) {
            c = (c << 8) | *p++;
            lc += 8;
          }
          if (lc >= l &&
              huf_code(hcode[j]) == ((c >> (lc - l)) & ((1ull << l) - 1))) {
            lc -= l;
            if (!emit(j)) return false;
            found = true;
            break;
          }
        }
        if (!found) return false;
      } else {
        return false;
      }
      if (out == n_raw) return true;
    }
  }
  // Tail: the final byte's LOW bits are padding beyond n_bits — drop them,
  // then decode the remaining short codes.
  int pad = (int)((8 - n_bits) & 7);
  if (lc < pad) return out == n_raw;
  c >>= pad;
  lc -= pad;
  while (lc > 0) {
    const HufDec& d = table[(c << (HUF_DECBITS - lc)) & HUF_DECMASK];
    if (d.len && d.len <= lc) {
      lc -= d.len;
      if (!emit(d.lit)) return false;
      if (out == n_raw) return true;
    } else {
      return false;
    }
  }
  return out == n_raw;
}

// ---- 2-D integer wavelet -------------------------------------------------

constexpr int A_OFFSET = 1 << 15;
constexpr int M_OFFSET = 1 << 15;
constexpr int MOD_MASK = (1 << 16) - 1;
constexpr int NBITS14 = 14;

inline void wenc14(uint16_t a, uint16_t b, uint16_t* l, uint16_t* h) {
  int16_t as = (int16_t)a, bs = (int16_t)b;
  int16_t ms = (int16_t)((as + bs) >> 1);
  int16_t ds = (int16_t)(as - bs);
  *l = (uint16_t)ms;
  *h = (uint16_t)ds;
}

inline void wdec14(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int16_t ls = (int16_t)l, hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = (int16_t)ai;
  int16_t bs = (int16_t)(ai - hi);
  *a = (uint16_t)as;
  *b = (uint16_t)bs;
}

inline void wenc16(uint16_t a, uint16_t b, uint16_t* l, uint16_t* h) {
  int ao = (a + A_OFFSET) & MOD_MASK;
  int m = (ao + b) >> 1;
  int d = ao - b;
  if (d < 0) m = (m + M_OFFSET) & MOD_MASK;
  d &= MOD_MASK;
  *l = (uint16_t)m;
  *h = (uint16_t)d;
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & MOD_MASK;
  int aa = (d + bb - A_OFFSET) & MOD_MASK;
  *b = (uint16_t)bb;
  *a = (uint16_t)aa;
}

void wav2_encode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << NBITS14);
  int n = nx > ny ? ny : nx;
  int p = 1, p2 = 2;
  while (p2 <= n) {
    int py = 0;
    int ey = oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      int px = py;
      int ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* a = in + px;
        uint16_t* b = in + px + ox1;
        uint16_t* cc = in + px + oy1;
        uint16_t* dd = in + px + oy1 + ox1;
        if (w14) {
          wenc14(*a, *b, &i00, &i01);
          wenc14(*cc, *dd, &i10, &i11);
          wenc14(i00, i10, a, cc);
          wenc14(i01, i11, b, dd);
        } else {
          wenc16(*a, *b, &i00, &i01);
          wenc16(*cc, *dd, &i10, &i11);
          wenc16(i00, i10, a, cc);
          wenc16(i01, i11, b, dd);
        }
      }
      if (nx & p) {
        uint16_t* a = in + px;
        uint16_t* cc = in + px + oy1;
        if (w14)
          wenc14(*a, *cc, &i00, cc);
        else
          wenc16(*a, *cc, &i00, cc);
        *a = i00;
      }
    }
    if (ny & p) {
      int px = py;
      int ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* a = in + px;
        uint16_t* b = in + px + ox1;
        uint16_t i00;
        if (w14)
          wenc14(*a, *b, &i00, b);
        else
          wenc16(*a, *b, &i00, b);
        *a = i00;
      }
    }
    p = p2;
    p2 <<= 1;
  }
}

void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << NBITS14);
  int n = nx > ny ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;
  while (p >= 1) {
    int py = 0;
    int ey = oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      int px = py;
      int ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* a = in + px;
        uint16_t* b = in + px + ox1;
        uint16_t* cc = in + px + oy1;
        uint16_t* dd = in + px + oy1 + ox1;
        if (w14) {
          wdec14(*a, *cc, &i00, &i10);
          wdec14(*b, *dd, &i01, &i11);
          wdec14(i00, i01, a, b);
          wdec14(i10, i11, cc, dd);
        } else {
          wdec16(*a, *cc, &i00, &i10);
          wdec16(*b, *dd, &i01, &i11);
          wdec16(i00, i01, a, b);
          wdec16(i10, i11, cc, dd);
        }
      }
      if (nx & p) {
        uint16_t* a = in + px;
        uint16_t* cc = in + px + oy1;
        if (w14)
          wdec14(*a, *cc, &i00, cc);
        else
          wdec16(*a, *cc, &i00, cc);
        *a = i00;
      }
    }
    if (ny & p) {
      int px = py;
      int ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* a = in + px;
        uint16_t* b = in + px + ox1;
        if (w14)
          wdec14(*a, *b, &i00, b);
        else
          wdec16(*a, *b, &i00, b);
        *a = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// ---- bitmap / LUT --------------------------------------------------------

uint16_t forward_lut_from_bitmap(const uint8_t* bitmap, uint16_t* lut) {
  int k = 0;
  for (int d = 0; d < HUF_ENCSIZE - 1; ++d) {
    if (d == 0 || (bitmap[d >> 3] & (1 << (d & 7))))
      lut[d] = (uint16_t)k++;
    else
      lut[d] = 0;
  }
  return (uint16_t)(k - 1);  // maximum value in the compacted range
}

uint16_t reverse_lut_from_bitmap(const uint8_t* bitmap, uint16_t* lut) {
  int k = 0;
  for (int d = 0; d < HUF_ENCSIZE - 1; ++d) {
    if (d == 0 || (bitmap[d >> 3] & (1 << (d & 7)))) lut[k++] = (uint16_t)d;
  }
  for (int i = k; i < HUF_ENCSIZE - 1; ++i) lut[i] = 0;
  return (uint16_t)(k - 1);
}

}  // namespace

// ---- public PIZ block codec ---------------------------------------------
// Data layout on both sides: scanline-major raw bytes (per line, channels
// in file order, each nx values of 2*size bytes).

bool piz_uncompress(const uint8_t* in, size_t in_len, int nx, int ny,
                    const int* ch_size_shorts, int n_ch, uint8_t* out) {
  if (in_len < 4) return false;
  uint16_t min_nz, max_nz;
  std::memcpy(&min_nz, in, 2);
  std::memcpy(&max_nz, in + 2, 2);
  size_t pos = 4;
  std::vector<uint8_t> bitmap(BITMAP_SIZE, 0);
  if (min_nz >= BITMAP_SIZE && min_nz != BITMAP_SIZE - 1 && max_nz != 0) {
    if (min_nz >= BITMAP_SIZE) return false;
  }
  if (min_nz <= max_nz) {
    size_t nbytes = (size_t)max_nz - min_nz + 1;
    if (max_nz >= BITMAP_SIZE || pos + nbytes > in_len) return false;
    std::memcpy(bitmap.data() + min_nz, in + pos, nbytes);
    pos += nbytes;
  }
  std::vector<uint16_t> lut(HUF_ENCSIZE);
  uint16_t max_value = reverse_lut_from_bitmap(bitmap.data(), lut.data());

  if (pos + 4 > in_len) return false;
  int32_t huf_len;
  std::memcpy(&huf_len, in + pos, 4);
  pos += 4;
  if (huf_len < 0 || pos + (size_t)huf_len > in_len) return false;

  size_t total_shorts = 0;
  for (int c = 0; c < n_ch; ++c)
    total_shorts += (size_t)nx * ny * ch_size_shorts[c];
  std::vector<uint16_t> tmp(total_shorts);
  if (!huf_uncompress(in + pos, (size_t)huf_len, tmp.data(), total_shorts))
    return false;

  // Per-channel planes: wavelet-decode each interleaved short sub-plane.
  size_t base = 0;
  for (int c = 0; c < n_ch; ++c) {
    int size = ch_size_shorts[c];
    for (int j = 0; j < size; ++j)
      wav2_decode(tmp.data() + base + j, nx, size, ny, size * nx, max_value);
    base += (size_t)nx * ny * size;
  }
  for (size_t i = 0; i < total_shorts; ++i) tmp[i] = lut[tmp[i]];

  // Reassemble scanline-major output.
  std::vector<size_t> ch_base(n_ch);
  size_t acc = 0;
  for (int c = 0; c < n_ch; ++c) {
    ch_base[c] = acc;
    acc += (size_t)nx * ny * ch_size_shorts[c];
  }
  uint8_t* dst = out;
  for (int y = 0; y < ny; ++y) {
    for (int c = 0; c < n_ch; ++c) {
      size_t row_shorts = (size_t)nx * ch_size_shorts[c];
      std::memcpy(dst, tmp.data() + ch_base[c] + y * row_shorts,
                  row_shorts * 2);
      dst += row_shorts * 2;
    }
  }
  return true;
}

bool piz_compress(const uint8_t* in, int nx, int ny,
                  const int* ch_size_shorts, int n_ch,
                  std::vector<uint8_t>* out) {
  size_t total_shorts = 0;
  for (int c = 0; c < n_ch; ++c)
    total_shorts += (size_t)nx * ny * ch_size_shorts[c];

  // Scanline-major -> channel planes.
  std::vector<uint16_t> tmp(total_shorts);
  std::vector<size_t> ch_base(n_ch);
  size_t acc = 0;
  for (int c = 0; c < n_ch; ++c) {
    ch_base[c] = acc;
    acc += (size_t)nx * ny * ch_size_shorts[c];
  }
  const uint8_t* src = in;
  for (int y = 0; y < ny; ++y) {
    for (int c = 0; c < n_ch; ++c) {
      size_t row_shorts = (size_t)nx * ch_size_shorts[c];
      std::memcpy(tmp.data() + ch_base[c] + y * row_shorts, src,
                  row_shorts * 2);
      src += row_shorts * 2;
    }
  }

  std::vector<uint8_t> bitmap(BITMAP_SIZE, 0);
  for (size_t i = 0; i < total_shorts; ++i) {
    uint16_t v = tmp[i];
    if (v) bitmap[v >> 3] |= (uint8_t)(1 << (v & 7));
  }
  std::vector<uint16_t> lut(HUF_ENCSIZE);
  uint16_t max_value = forward_lut_from_bitmap(bitmap.data(), lut.data());
  for (size_t i = 0; i < total_shorts; ++i) tmp[i] = lut[tmp[i]];

  uint16_t min_nz = BITMAP_SIZE - 1, max_nz = 0;
  for (int i = 0; i < BITMAP_SIZE; ++i) {
    if (bitmap[i]) {
      if (i < min_nz) min_nz = (uint16_t)i;
      if (i > max_nz) max_nz = (uint16_t)i;
    }
  }

  size_t base = 0;
  for (int c = 0; c < n_ch; ++c) {
    int size = ch_size_shorts[c];
    for (int j = 0; j < size; ++j)
      wav2_encode(tmp.data() + base + j, nx, size, ny, size * nx, max_value);
    base += (size_t)nx * ny * size;
  }

  out->clear();
  out->push_back((uint8_t)(min_nz & 0xFF));
  out->push_back((uint8_t)(min_nz >> 8));
  out->push_back((uint8_t)(max_nz & 0xFF));
  out->push_back((uint8_t)(max_nz >> 8));
  if (min_nz <= max_nz)
    out->insert(out->end(), bitmap.begin() + min_nz,
                bitmap.begin() + max_nz + 1);
  size_t len_pos = out->size();
  out->resize(len_pos + 4);
  size_t huf_start = out->size();
  if (!huf_compress(tmp.data(), total_shorts, out)) return false;
  int32_t huf_len = (int32_t)(out->size() - huf_start);
  std::memcpy(out->data() + len_pos, &huf_len, 4);
  return true;
}

// The DWA codec's STATIC_HUFFMAN AC stream is the same ImfHuf format PIZ
// uses; csrc/dwa.cc borrows the codec through these named exports.
bool vt_huf_uncompress(const uint8_t* in, size_t in_len, uint16_t* raw,
                       size_t n_raw) {
  return huf_uncompress(in, in_len, raw, n_raw);
}

bool vt_huf_compress(const uint16_t* raw, size_t n, std::vector<uint8_t>* out) {
  return huf_compress(raw, n, out);
}

}  // namespace vtrace
