// dicomfast — native DICOM slice decoder for the host ingest path.
//
// Role: the reference delegated heavy host-side decode to native code
// (kornia-rs / torchvision C++, SURVEY.md section 2c); this is the
// TPU-framework equivalent for the volumetric ingest path: parsing a
// CT series of hundreds of slices is pure CPU work that sits on the
// critical path of volume streaming (SURVEY.md section 3.3), so it is
// implemented in C++ with a C ABI and called from Python via ctypes
// with the GIL released (one thread per file in the Python pool).
//
// Scope matches mies_tpu_torch/io/dicom.py exactly (the Python twin defines
// the semantics and remains the fallback): Part-10 or raw datasets,
// implicit/explicit VR little endian, uncompressed 8/16-bit PixelData,
// RLE Lossless (PS3.5 Annex G segment table + PackBits, single
// fragment — the per-slice series contract) or JPEG-LS (.4.80/.4.81,
// a T.87 decoder mirroring io/jpegls.py — the Python coder is
// sample-sequential and ~1.5 s/frame, so the series hot path needs
// the native twin), rescale slope/intercept applied to int16 output.
//
// Build: g++ -O3 -shared -fPIC -o _dicomfast.so dicomfast.cpp
//        (see mies_tpu_torch/native/__init__.py::build)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <utility>
#include <vector>

namespace {

constexpr uint32_t kUndefined = 0xFFFFFFFFu;

struct Meta {
  int32_t rows = 0;
  int32_t cols = 0;
  int32_t bits = 16;
  int32_t is_signed = 0;
  int32_t instance = -1;
  int32_t has_slice_loc = 0;
  int32_t has_ipp_z = 0;
  double slope = 1.0;
  double intercept = 0.0;
  double slice_loc = 0.0;
  double ipp_z = 0.0;
};

inline uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
inline uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0] | (p[1] << 8) | (p[2] << 16) |
                               (static_cast<uint32_t>(p[3]) << 24));
}

inline bool long_vr(const char* vr) {
  static const char* kLong[] = {"OB", "OW", "OF", "OD", "OL",
                                "SQ", "UC", "UR", "UT", "UN"};
  for (const char* v : kLong)
    if (vr[0] == v[0] && vr[1] == v[1]) return true;
  return false;
}

double parse_double(const uint8_t* v, uint32_t len) {
  char buf[64];
  uint32_t n = len < 63 ? len : 63;
  memcpy(buf, v, n);
  buf[n] = 0;
  return atof(buf);
}

// Reads one element header; advances pos. Returns false on truncation.
struct Elem {
  uint16_t group, elem;
  char vr[3] = {0, 0, 0};
  uint32_t length;
  size_t value_pos;
};

bool read_elem(const uint8_t* d, size_t n, size_t& pos, bool expl, Elem* e) {
  if (pos + 8 > n) return false;
  e->group = rd16(d + pos);
  e->elem = rd16(d + pos + 2);
  // item / delimiter tags always have implicit 4-byte length
  if (e->group == 0xFFFE) {
    e->length = rd32(d + pos + 4);
    pos += 8;
    e->value_pos = pos;
    return true;
  }
  if (expl) {
    e->vr[0] = static_cast<char>(d[pos + 4]);
    e->vr[1] = static_cast<char>(d[pos + 5]);
    if (long_vr(e->vr)) {
      if (pos + 12 > n) return false;
      e->length = rd32(d + pos + 8);
      pos += 12;
    } else {
      e->length = rd16(d + pos + 6);
      pos += 8;
    }
  } else {
    e->length = rd32(d + pos + 4);
    pos += 8;
  }
  e->value_pos = pos;
  return true;
}

// Skip an undefined-length element (sequence) by walking delimiters.
bool skip_undefined(const uint8_t* d, size_t n, size_t& pos, bool expl) {
  int depth = 1;
  Elem e;
  while (depth > 0) {
    if (!read_elem(d, n, pos, expl, &e)) return false;
    if (e.group == 0xFFFE && e.elem == 0xE0DD) {
      depth--;
    } else if (e.group == 0xFFFE) {
      // item start/end with defined or undefined length: contents are
      // parsed element-by-element, nothing to skip
    } else if (e.length == kUndefined) {
      depth++;
    } else {
      if (pos + e.length > n) return false;
      pos += e.length;
    }
  }
  return true;
}

// PackBits (PS3.5 G.3.2) -> exactly `expected` bytes; trailing pad
// replication past `expected` is discarded (mirrors the Python twin).
bool packbits_decode(const uint8_t* s, size_t len, uint8_t* out,
                     size_t expected) {
  size_t i = 0, o = 0;
  while (o < expected) {
    if (i >= len) return false;
    uint8_t n = s[i++];
    if (n < 128) {
      size_t cnt = static_cast<size_t>(n) + 1;
      if (i + cnt > len) return false;
      size_t take = cnt < expected - o ? cnt : expected - o;
      memcpy(out + o, s + i, take);
      i += cnt;
      o += take;
    } else if (n > 128) {
      if (i >= len) return false;
      size_t cnt = 257 - static_cast<size_t>(n);
      size_t take = cnt < expected - o ? cnt : expected - o;
      memset(out + o, s[i], take);
      i += 1;
      o += take;
    }  // n == 128: no-op
  }
  return true;
}

// One RLE Lossless fragment (64-byte segment table + PackBits planes,
// MSB plane first) -> little-endian raw pixel bytes in `out`
// (npx * bytes_per_px). Returns 0 / -7 (corrupt RLE).
int rle_decode_frame(const uint8_t* frag, size_t flen, size_t npx,
                     int bytes_per_px, std::vector<uint8_t>* out) {
  if (flen < 64) return -7;
  uint32_t nseg = rd32(frag);
  if (nseg != static_cast<uint32_t>(bytes_per_px)) return -7;
  out->resize(npx * bytes_per_px);
  std::vector<uint8_t> plane(npx);
  for (uint32_t k = 0; k < nseg; ++k) {
    uint32_t a = rd32(frag + 4 + 4 * k);
    uint32_t b = (k + 1 < nseg) ? rd32(frag + 4 + 4 * (k + 1))
                                : static_cast<uint32_t>(flen);
    if (a < 64 || b < a || b > flen) return -7;
    if (!packbits_decode(frag + a, b - a, plane.data(), npx)) return -7;
    // segment 0 carries the MSBs (PS3.5 G.2); output is little-endian
    size_t byte_idx = static_cast<size_t>(bytes_per_px - 1 - k);
    for (size_t i = 0; i < npx; ++i)
      (*out)[i * bytes_per_px + byte_idx] = plane[i];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG-LS (ITU-T T.87) decoder — mirrors mies_tpu_torch/io/jpegls.py
// (the Python twin defines the semantics; fuzz tests pin bit equality).
// ---------------------------------------------------------------------------

struct JlsParams {
  int maxval, near, t1, t2, t3, reset;
  int range, qbpp, bpp, limit;
};

constexpr int kJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                        2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6,
                        7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct JlsState {
  int64_t A[367], B[367], C[367], N[367], Nn[2];
  int run_index = 0;
};

struct JlsBits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool prev_ff = false;

  void fill() {
    while (nbits <= 48) {
      if (pos >= n) {
        acc <<= 8;
        nbits += 8;
        prev_ff = false;
        continue;
      }
      uint8_t b = d[pos];
      if (prev_ff && (b & 0x80)) {  // marker: stop feeding real data
        acc <<= 8;
        nbits += 8;
        continue;
      }
      ++pos;
      if (prev_ff) {  // stuffed byte: MSB forced 0, 7 payload bits
        acc = (acc << 7) | (b & 0x7F);
        nbits += 7;
      } else {
        acc = (acc << 8) | b;
        nbits += 8;
      }
      prev_ff = (b == 0xFF);
    }
  }
  uint32_t bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    nbits -= k;
    uint32_t v = static_cast<uint32_t>((acc >> nbits) &
                                       ((1ull << k) - 1));
    acc &= (1ull << nbits) - 1;
    return v;
  }
  int bit() { return static_cast<int>(bits(1)); }
};

inline int jls_clamp_t(int v, int lo, int maxval) {
  return v < lo ? lo : (v > maxval ? maxval : v);
}

void jls_default_thresholds(int maxval, int near, int* t1, int* t2,
                            int* t3) {
  if (maxval >= 128) {
    int f = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
    *t1 = jls_clamp_t(f * (3 - 2) + 2 + 3 * near, near + 1, maxval);
    *t2 = jls_clamp_t(f * (7 - 3) + 3 + 5 * near, *t1, maxval);
    *t3 = jls_clamp_t(f * (21 - 4) + 4 + 7 * near, *t2, maxval);
  } else {
    int f = 256 / (maxval + 1);
    int a = 3 / f + 3 * near;
    *t1 = jls_clamp_t(a > 2 ? a : 2, near + 1, maxval);
    int b = 7 / f + 5 * near;
    *t2 = jls_clamp_t(b > 3 ? b : 3, *t1, maxval);
    int c = 21 / f + 7 * near;
    *t3 = jls_clamp_t(c > 4 ? c : 4, *t2, maxval);
  }
}

inline int jls_bitlen(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;  // ceil(log2(v)) for v >= 1
  return k;
}

void jls_derive(JlsParams* p) {
  p->range = (p->maxval + 2 * p->near) / (2 * p->near + 1) + 1;
  // qbpp = bit length of (range - 1), min 1
  int q = 0;
  for (int r = p->range - 1; r > 0; r >>= 1) ++q;
  p->qbpp = q > 1 ? q : 1;
  int b = 0;
  for (int m = p->maxval; m > 0; m >>= 1) ++b;
  p->bpp = b > 2 ? b : 2;
  p->limit = 2 * (p->bpp + (p->bpp > 8 ? p->bpp : 8));
}

void jls_init_state(JlsState* st, const JlsParams& p) {
  int64_t a0 = (p.range + 32) / 64;
  if (a0 < 2) a0 = 2;
  for (int i = 0; i < 367; ++i) {
    st->A[i] = a0;
    st->B[i] = 0;
    st->C[i] = 0;
    st->N[i] = 1;
  }
  st->Nn[0] = st->Nn[1] = 0;
  st->run_index = 0;
}

inline int jls_quantize(int d, const JlsParams& p) {
  if (d <= -p.t3) return -4;
  if (d <= -p.t2) return -3;
  if (d <= -p.t1) return -2;
  if (d < -p.near) return -1;
  if (d <= p.near) return 0;
  if (d < p.t1) return 1;
  if (d < p.t2) return 2;
  if (d < p.t3) return 3;
  return 4;
}

inline int jls_golomb_k(int64_t n, int64_t a) {
  int k = 0;
  while ((n << k) < a) ++k;
  return k;
}

// Golomb-limited decode (T.87 A.5.3). Returns -1 on corruption.
inline int jls_decode_lg(JlsBits* br, int k, int glimit, int qbpp) {
  int hi = 0;
  while (br->bit() == 0) {
    if (++hi > glimit) return -1;
  }
  if (hi < glimit - qbpp - 1)
    return (hi << k) | static_cast<int>(br->bits(k));
  return static_cast<int>(br->bits(qbpp)) + 1;
}

void jls_update_regular(JlsState* st, const JlsParams& p, int q,
                        int errval) {
  st->B[q] += static_cast<int64_t>(errval) * (2 * p.near + 1);
  st->A[q] += errval < 0 ? -errval : errval;
  if (st->N[q] == p.reset) {
    st->A[q] >>= 1;
    int64_t b = st->B[q];
    st->B[q] = b >= 0 ? (b >> 1) : -((1 - b) >> 1);
    st->N[q] >>= 1;
  }
  st->N[q] += 1;
  if (st->B[q] <= -st->N[q]) {
    st->B[q] += st->N[q];
    if (st->C[q] > -128) st->C[q] -= 1;
    if (st->B[q] <= -st->N[q]) st->B[q] = -st->N[q] + 1;
  } else if (st->B[q] > 0) {
    st->B[q] -= st->N[q];
    if (st->C[q] < 127) st->C[q] += 1;
    if (st->B[q] > 0) st->B[q] = 0;
  }
}

// Decode the run-interruption sample; returns 0 / -9 (corrupt).
int jls_run_interruption(JlsBits* br, int ra, int rb,
                         const JlsParams& p, JlsState* st, int* rx_out) {
  int t = 2 * p.near + 1;
  int ad = ra - rb;
  if (ad < 0) ad = -ad;
  int ritype = ad <= p.near ? 1 : 0;
  int px, sign;
  if (ritype) {
    px = ra;
    sign = 1;
  } else {
    px = rb;
    sign = rb < ra ? -1 : 1;
  }
  int q = 365 + ritype;
  int64_t temp = st->A[q] + (ritype ? (st->N[q] >> 1) : 0);
  int k = jls_golomb_k(st->N[q], temp);
  int glimit = p.limit - kJ[st->run_index] - 1;
  int emerr = jls_decode_lg(br, k, glimit, p.qbpp);
  if (emerr < 0) return -9;
  int errval, mapv;
  int tmp = emerr + ritype;
  if (tmp == 0) {
    errval = 0;
  } else {
    int mag;
    if (tmp & 1) {
      mag = (tmp + 1) / 2;
      mapv = 1;
    } else {
      mag = tmp / 2;
      mapv = 0;
    }
    bool special = (k == 0 && 2 * st->Nn[q - 365] < st->N[q]);
    if (mapv)
      errval = special ? mag : -mag;
    else
      errval = special ? -mag : mag;
  }
  int rx = px + sign * errval * t;
  if (rx < -p.near)
    rx += p.range * t;
  else if (rx > p.maxval + p.near)
    rx -= p.range * t;
  rx = rx < 0 ? 0 : (rx > p.maxval ? p.maxval : rx);
  *rx_out = rx;
  if (errval < 0) st->Nn[q - 365] += 1;
  st->A[q] += (emerr + 1 - ritype) >> 1;
  if (st->N[q] == p.reset) {
    st->A[q] >>= 1;
    st->N[q] >>= 1;
    st->Nn[q - 365] >>= 1;
  }
  st->N[q] += 1;
  return 0;
}

// One JPEG-LS codestream -> uint16 samples (rows*cols). Returns 0/-9.
int jls_decode_frame(const uint8_t* blob, size_t flen, int exp_rows,
                     int exp_cols, std::vector<uint16_t>* out) {
  if (flen < 4 || blob[0] != 0xFF || blob[1] != 0xD8) return -9;
  size_t pos = 2;
  int precision = -1, rows = 0, cols = 0;
  int maxval = 0, lt1 = 0, lt2 = 0, lt3 = 0, reset = 64;
  while (pos + 4 <= flen) {
    if (blob[pos] != 0xFF) return -9;
    uint8_t m = blob[pos + 1];
    if (m == 0xFF) {
      ++pos;
      continue;
    }
    pos += 2;
    if (m == 0xD9) return -9;  // EOI before scan
    if (pos + 2 > flen) return -9;
    uint32_t seglen = (blob[pos] << 8) | blob[pos + 1];
    if (pos + seglen > flen || seglen < 2) return -9;
    const uint8_t* seg = blob + pos + 2;
    uint32_t sn = seglen - 2;
    if (m == 0xF7) {  // SOF55
      if (sn < 9) return -9;
      precision = seg[0];
      rows = (seg[1] << 8) | seg[2];
      cols = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) return -9;  // multi-component: Python fallback
      if (precision < 2 || precision > 16) return -9;
    } else if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      return -9;  // some other SOF family
    } else if (m == 0xF8) {  // LSE
      if (sn >= 11 && seg[0] == 1) {
        maxval = (seg[1] << 8) | seg[2];
        lt1 = (seg[3] << 8) | seg[4];
        lt2 = (seg[5] << 8) | seg[6];
        lt3 = (seg[7] << 8) | seg[8];
        reset = (seg[9] << 8) | seg[10];
      } else {
        return -9;  // mapping tables: Python fallback
      }
    } else if (m == 0xDD) {  // DRI
      if (sn >= 2 && ((seg[0] << 8) | seg[1]) != 0) return -9;
    } else if (m == 0xDA) {  // SOS
      if (precision < 0 || sn < 6) return -9;
      int ns = seg[0];
      if (ns != 1) return -9;
      int near = seg[1 + 2 * ns];
      int ilv = seg[2 + 2 * ns];
      int al = seg[3 + 2 * ns] & 0x0F;
      if (ilv != 0 || al != 0) return -9;
      if (rows != exp_rows || cols != exp_cols) return -9;
      JlsParams p;
      p.maxval = maxval ? maxval : (1 << precision) - 1;
      p.near = near;
      p.reset = reset ? reset : 64;
      if (lt1 == 0 && lt2 == 0 && lt3 == 0)
        jls_default_thresholds(p.maxval, near, &p.t1, &p.t2, &p.t3);
      else {
        p.t1 = lt1;
        p.t2 = lt2;
        p.t3 = lt3;
      }
      jls_derive(&p);
      JlsState st;
      jls_init_state(&st, p);
      JlsBits br{blob, flen, pos + seglen};
      out->assign(static_cast<size_t>(rows) * cols, 0);
      std::vector<int> prev(cols, 0), cur(cols, 0);
      int c0 = 0;
      int t = 2 * p.near + 1;
      for (int y = 0; y < rows; ++y) {
        int x = 0;
        while (x < cols) {
          int b = prev[x];
          int c = x > 0 ? prev[x - 1] : c0;
          int d = x + 1 < cols ? prev[x + 1] : prev[cols - 1];
          int a = x > 0 ? cur[x - 1] : prev[0];
          int q1 = jls_quantize(d - b, p);
          int q2 = jls_quantize(b - c, p);
          int q3 = jls_quantize(c - a, p);
          int q = 81 * q1 + 9 * q2 + q3;
          if (q == 0) {  // run mode
            int runval = a;
            for (;;) {
              if (br.bit() == 1) {
                int seg_n = 1 << kJ[st.run_index];
                int n = seg_n < cols - x ? seg_n : cols - x;
                for (int i = 0; i < n; ++i) cur[x + i] = runval;
                x += n;
                if (n == seg_n && st.run_index < 31) st.run_index += 1;
                if (x == cols) break;
              } else {
                int nbits = kJ[st.run_index];
                int n = nbits ? static_cast<int>(br.bits(nbits)) : 0;
                if (n > cols - x) return -9;
                for (int i = 0; i < n; ++i) cur[x + i] = runval;
                x += n;
                int rx;
                int rc2 = jls_run_interruption(&br, runval, prev[x], p,
                                               &st, &rx);
                if (rc2 != 0) return rc2;
                cur[x] = rx;
                if (st.run_index > 0) st.run_index -= 1;
                x += 1;
                break;
              }
            }
            continue;
          }
          int sign;
          if (q < 0) {
            sign = -1;
            q = -q;
          } else {
            sign = 1;
          }
          int med = c >= (a > b ? a : b)   ? (a < b ? a : b)
                    : c <= (a < b ? a : b) ? (a > b ? a : b)
                                           : a + b - c;
          int px = med + sign * static_cast<int>(st.C[q]);
          px = px < 0 ? 0 : (px > p.maxval ? p.maxval : px);
          int k = jls_golomb_k(st.N[q], st.A[q]);
          int merr = jls_decode_lg(&br, k, p.limit, p.qbpp);
          if (merr < 0) return -9;
          int errval;
          if (p.near == 0 && k == 0 && 2 * st.B[q] <= -st.N[q]) {
            // inverse of: e >= 0 -> 2e+1 (odd), e < 0 -> -2(e+1)
            errval = (merr & 1) ? (merr - 1) / 2 : -(merr / 2) - 1;
          } else {
            errval = (merr & 1) ? -((merr + 1) / 2) : merr / 2;
          }
          int rx = px + sign * errval * t;
          if (rx < -p.near)
            rx += p.range * t;
          else if (rx > p.maxval + p.near)
            rx -= p.range * t;
          rx = rx < 0 ? 0 : (rx > p.maxval ? p.maxval : rx);
          cur[x] = rx;
          jls_update_regular(&st, p, q, errval);
          ++x;
        }
        for (int i = 0; i < cols; ++i)
          (*out)[static_cast<size_t>(y) * cols + i] =
              static_cast<uint16_t>(cur[i]);
        c0 = prev[0];
        std::swap(prev, cur);
      }
      return 0;
    }
    pos += seglen;
  }
  return -9;
}

}  // namespace

extern "C" {

// Parse a DICOM file image held in memory.
//   data/len     — file bytes
//   meta         — output metadata (always filled on success)
//   out_pixels   — if non-null, int16 buffer of rows*cols receiving the
//                  rescaled HU pixels; pass null to probe metadata only.
// Returns 0 on success; negative error codes otherwise:
//   -1 truncated/garbled, -2 unsupported transfer syntax,
//   -3 missing PixelData/Rows/Cols, -4 unsupported BitsAllocated,
//   -7 corrupt RLE PixelData, -8 multi-fragment (multi-frame) RLE,
//   -9 corrupt/unsupported JPEG-LS PixelData,
//   -10 color (SamplesPerPixel != 1) — the Python twin decodes those.
int mies_dicom_parse(const uint8_t* data, size_t len, Meta* meta,
                     int16_t* out_pixels) {
  *meta = Meta();
  size_t pos = 0;
  bool expl = true;
  bool rle = false;
  bool jls = false;
  int samples = 1;  // SamplesPerPixel: color routes to the Python twin

  if (len > 132 && memcmp(data + 128, "DICM", 4) == 0) {
    // file-meta group: always explicit VR LE
    pos = 132;
    Elem e;
    while (pos < len) {
      size_t save = pos;
      if (!read_elem(data, len, pos, true, &e)) return -1;
      if (e.group != 0x0002) {
        pos = save;
        break;
      }
      if (pos + e.length > len) return -1;
      if (e.elem == 0x0010) {  // TransferSyntaxUID
        char uid[64] = {0};
        uint32_t n = e.length < 63 ? e.length : 63;
        memcpy(uid, data + pos, n);
        for (int i = static_cast<int>(n) - 1;
             i >= 0 && (uid[i] == 0 || uid[i] == ' '); --i)
          uid[i] = 0;
        if (strcmp(uid, "1.2.840.10008.1.2") == 0) {
          expl = false;
        } else if (strcmp(uid, "1.2.840.10008.1.2.1") == 0) {
          expl = true;
        } else if (strcmp(uid, "1.2.840.10008.1.2.5") == 0) {
          expl = true;  // encapsulated syntaxes are explicit VR LE
          rle = true;
        } else if (strcmp(uid, "1.2.840.10008.1.2.4.80") == 0 ||
                   strcmp(uid, "1.2.840.10008.1.2.4.81") == 0) {
          expl = true;
          jls = true;
        } else {
          return -2;
        }
      }
      pos += e.length;
    }
  }

  const uint8_t* px = nullptr;
  uint32_t px_len = 0;
  const uint8_t* frag = nullptr;  // the one RLE PixelData fragment
  uint32_t frag_len = 0;
  Elem e;
  while (pos < len) {
    if (!read_elem(data, len, pos, expl, &e)) break;
    if (e.length == kUndefined) {
      if ((rle || jls) && e.group == 0x7FE0 && e.elem == 0x0010) {
        // encapsulated PixelData: Basic Offset Table item first
        // (redundant for RLE — one frame per fragment), then exactly
        // one fragment (the per-slice contract; the Python twin
        // handles multi-frame files), then the sequence delimiter.
        bool first = true;
        bool closed = false;
        while (pos < len) {
          Elem it;
          if (!read_elem(data, len, pos, expl, &it)) return -1;
          if (it.group == 0xFFFE && it.elem == 0xE0DD) {
            closed = true;
            break;
          }
          if (it.group != 0xFFFE || it.elem != 0xE000 ||
              it.length == kUndefined || pos + it.length > len)
            return -7;
          if (first) {
            first = false;  // Basic Offset Table
          } else {
            if (frag) return -8;  // second fragment = multi-frame
            frag = data + pos;
            frag_len = it.length;
          }
          pos += it.length;
        }
        if (!closed) return -7;
        continue;
      }
      if (!skip_undefined(data, len, pos, expl)) return -1;
      continue;
    }
    if (pos + e.length > len) return -1;
    const uint8_t* v = data + pos;
    uint32_t l = e.length;
    if (e.group == 0x7FE0 && e.elem == 0x0010) {
      px = v;
      px_len = l;
    } else if (e.group == 0x0028) {
      // rd16 needs 2 value bytes; a malformed zero-length US element at
      // the buffer tail must not read past the end (the Python twin
      // fails safely via struct.error) — ignore short elements instead
      switch (e.elem) {
        case 0x0002: if (l >= 2) samples = rd16(v); break;
        case 0x0010: if (l >= 2) meta->rows = rd16(v); break;
        case 0x0011: if (l >= 2) meta->cols = rd16(v); break;
        case 0x0100: if (l >= 2) meta->bits = rd16(v); break;
        case 0x0103: if (l >= 2) meta->is_signed = rd16(v) == 1; break;
        case 0x1052: if (l > 0) meta->intercept = parse_double(v, l); break;
        case 0x1053: if (l > 0) meta->slope = parse_double(v, l); break;
      }
    } else if (e.group == 0x0020) {
      if (e.elem == 0x0013) {
        meta->instance = static_cast<int32_t>(parse_double(v, l));
      } else if (e.elem == 0x1041) {
        meta->slice_loc = parse_double(v, l);
        meta->has_slice_loc = 1;
      } else if (e.elem == 0x0032) {
        // ImagePositionPatient: "x\\y\\z" — take z
        char buf[128] = {0};
        uint32_t n = l < 127 ? l : 127;
        memcpy(buf, v, n);
        char* last = strrchr(buf, '\\');
        if (last) {
          meta->ipp_z = atof(last + 1);
          meta->has_ipp_z = 1;
        }
      }
    }
    pos += e.length;
  }

  if ((!px && !frag) || meta->rows <= 0 || meta->cols <= 0) return -3;
  if (samples != 1) return -10;  // color: the grayscale fast path would
                                 // silently read 1/3 of the frame
  const size_t npx = static_cast<size_t>(meta->rows) * meta->cols;

  if (!out_pixels) return 0;

  std::vector<uint8_t> rle_buf;
  std::vector<uint16_t> jls_buf;
  if (frag) {
    if (meta->bits != 8 && meta->bits != 16) return -4;
    if (jls) {
      int rc = jls_decode_frame(frag, frag_len, meta->rows, meta->cols,
                                &jls_buf);
      if (rc != 0) return rc;
      if (meta->bits == 8) {
        rle_buf.resize(npx);
        for (size_t i = 0; i < npx; ++i)
          rle_buf[i] = static_cast<uint8_t>(jls_buf[i]);
        px = rle_buf.data();
        px_len = static_cast<uint32_t>(npx);
      } else {
        // host is little-endian: the uint16 sample buffer IS the
        // stored-dtype byte layout the conversion below expects
        px = reinterpret_cast<const uint8_t*>(jls_buf.data());
        px_len = static_cast<uint32_t>(npx * 2);
      }
    } else {
      int rc =
          rle_decode_frame(frag, frag_len, npx, meta->bits / 8, &rle_buf);
      if (rc != 0) return rc;
      px = rle_buf.data();
      px_len = static_cast<uint32_t>(rle_buf.size());
    }
  }

  const double slope = meta->slope, icpt = meta->intercept;
  const bool rescale = slope != 1.0 || icpt != 0.0;
  // Rescaled values SATURATE at the int16 range (matching the Python
  // twin's np.clip; a float->int16 cast out of range is UB besides).
  // Unrescaled unsigned values use a bit-preserving modulo cast: the
  // Python wrapper views the buffer back as uint16.
  const auto sat16 = [](double v) -> int16_t {
    if (v <= -32768.0) return INT16_MIN;
    if (v >= 32767.0) return INT16_MAX;
    return static_cast<int16_t>(v);
  };
  if (meta->bits == 16) {
    if (px_len < npx * 2) return -1;
    if (meta->is_signed) {
      const int16_t* s = reinterpret_cast<const int16_t*>(px);
      if (rescale)
        for (size_t i = 0; i < npx; ++i)
          out_pixels[i] = sat16(static_cast<double>(
              static_cast<float>(s[i]) * slope + icpt));
      else
        memcpy(out_pixels, s, npx * 2);
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(px);
      for (size_t i = 0; i < npx; ++i)
        out_pixels[i] = rescale
            ? sat16(static_cast<double>(
                  static_cast<float>(s[i]) * slope + icpt))
            : static_cast<int16_t>(s[i]);
    }
  } else if (meta->bits == 8) {
    if (px_len < npx) return -1;
    for (size_t i = 0; i < npx; ++i)
      out_pixels[i] = rescale
          ? sat16(static_cast<double>(
                static_cast<float>(px[i]) * slope + icpt))
          : static_cast<int16_t>(px[i]);
  } else {
    return -4;
  }
  return 0;
}

// Read + parse a file from disk (avoids shipping bytes through Python).
int mies_dicom_read_file(const char* path, Meta* meta, int16_t* out_pixels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -5;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) {
    fclose(f);
    return -5;
  }
  uint8_t* buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(sz)));
  if (!buf) {
    fclose(f);
    return -6;
  }
  size_t got = fread(buf, 1, static_cast<size_t>(sz), f);
  fclose(f);
  int rc = (got == static_cast<size_t>(sz))
               ? mies_dicom_parse(buf, got, meta, out_pixels)
               : -5;
  free(buf);
  return rc;
}

}  // extern "C"
