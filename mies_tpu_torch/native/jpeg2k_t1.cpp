// jpeg2k_t1 — native EBCOT Tier-1 block coder (decode + encode).
//
// Role: io/jpeg2k.py's from-spec Tier-1 is bit-serial pure Python at
// ~2.7 s per 512x512 12-bit frame; with the encoder the same loops also sit on the DICOM .4.90 WRITE path. This
// is the C++ twin of _t1_decode_block/_t1_encode_block and the Annex C
// MQ coder — SAME contexts, scan pattern, pass structure and stuffing
// rules; the Python twin defines the semantics and the tests pin BIT
// equality on random blocks and whole codestreams. Tier-2 (packets,
// tag trees, wavelet) stays in Python: geometry-light, numpy-fast.
//
// Built into _dicomfast.so next to dicomfast.cpp (one host-runtime
// library; see mies_tpu_torch/native/__init__.py::build).

#include <cstdint>
#include <cstring>

#include <vector>

namespace {

// (Qe, NMPS, NLPS, SWITCH) — ISO 15444-1 Table C.2.
struct Qe {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr Qe kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int kCtxRL = 17;
constexpr int kCtxUNI = 18;
constexpr int kNCtx = 19;

// Zero-coding context LUT [hh][h][v][d] (Table D.1), h/v in 0..2,
// d in 0..4 — generated the same way as the Python _ZC_LUT.
struct ZcLut {
  uint8_t t[2][3][3][5];
  constexpr ZcLut() : t() {
    for (int hh = 0; hh < 2; ++hh)
      for (int h = 0; h < 3; ++h)
        for (int v = 0; v < 3; ++v)
          for (int d = 0; d < 5; ++d) {
            int c = 0;
            if (!hh) {
              if (h == 2) c = 8;
              else if (h == 1) c = v >= 1 ? 7 : (d >= 1 ? 6 : 5);
              else if (v == 2) c = 4;
              else if (v == 1) c = 3;
              else c = d >= 2 ? 2 : (d == 1 ? 1 : 0);
            } else {
              int hv = h + v;
              if (d >= 3) c = 8;
              else if (d == 2) c = hv >= 1 ? 7 : 6;
              else if (d == 1) c = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
              else c = hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
            }
            t[hh][h][v][d] = static_cast<uint8_t>(c);
          }
  }
};
constexpr ZcLut kZc;

// (sign context, xor) by (H+1, V+1) — Table D.2.
constexpr uint8_t kScCtx[3][3] = {{13, 12, 11}, {10, 9, 10},
                                  {11, 12, 13}};
constexpr uint8_t kScXor[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};

// ---------------------------------------------------------------------------
// MQ decoder (Annex C, software conventions) — mirrors _MQDecoder.
// ---------------------------------------------------------------------------

struct MQDec {
  const uint8_t* data;
  size_t len;
  size_t bp = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;
  uint8_t idx[kNCtx] = {};
  uint8_t mps[kNCtx] = {};

  uint8_t b(size_t off = 0) const {
    size_t i = bp + off;
    return i < len ? data[i] : 0xFF;
  }

  void bytein() {
    if (b() == 0xFF) {
      if (b(1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp += 1;
        c += static_cast<uint32_t>(b()) << 9;
        ct = 7;
      }
    } else {
      bp += 1;
      c += static_cast<uint32_t>(b()) << 8;
      ct = 8;
    }
  }

  void init(const uint8_t* d, size_t n) {
    data = d;
    len = n;
    memset(idx, 0, sizeof(idx));
    memset(mps, 0, sizeof(mps));
    idx[0] = 4;
    idx[kCtxRL] = 3;
    idx[kCtxUNI] = 46;
    bp = 0;
    c = static_cast<uint32_t>(b()) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(int cx) {
    const Qe q = kQe[idx[cx]];
    int d;
    a -= q.qe;
    if (((c >> 16) & 0xFFFF) < q.qe) {
      if (a < q.qe) {  // LPS exchange (C-17)
        d = mps[cx];
        idx[cx] = q.nmps;
      } else {
        d = 1 - mps[cx];
        if (q.sw) mps[cx] = 1 - mps[cx];
        idx[cx] = q.nlps;
      }
      a = q.qe;
    } else {
      c -= static_cast<uint32_t>(q.qe) << 16;
      if (a & 0x8000) return mps[cx];
      if (a < q.qe) {  // MPS exchange (C-16)
        d = 1 - mps[cx];
        if (q.sw) mps[cx] = 1 - mps[cx];
        idx[cx] = q.nlps;
      } else {
        d = mps[cx];
        idx[cx] = q.nmps;
      }
    }
    do {  // RENORMD
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct -= 1;
    } while (!(a & 0x8000));
    return d;
  }
};

// ---------------------------------------------------------------------------
// MQ encoder (Annex C.3) — mirrors _MQEncoder incl. the byte-store
// truncations and the trailing-0xFF drop.
// ---------------------------------------------------------------------------

struct MQEnc {
  std::vector<uint8_t> buf;  // buf[0] = the B-before-BPST sentinel
  uint32_t c = 0, a = 0x8000;
  int ct = 12;
  uint8_t idx[kNCtx] = {};
  uint8_t mps[kNCtx] = {};

  void init() {
    buf.assign(1, 0);
    c = 0;
    a = 0x8000;
    ct = 12;
    memset(idx, 0, sizeof(idx));
    memset(mps, 0, sizeof(mps));
    idx[0] = 4;
    idx[kCtxRL] = 3;
    idx[kCtxUNI] = 46;
  }

  void byteout() {
    if (buf.back() == 0xFF) {
      buf.push_back((c >> 20) & 0xFF);
      c &= 0xFFFFF;
      ct = 7;
    } else if (c < 0x8000000u) {
      buf.push_back((c >> 19) & 0xFF);
      c &= 0x7FFFF;
      ct = 8;
    } else {
      buf.back() += 1;  // carry
      if (buf.back() == 0xFF) {
        c &= 0x7FFFFFF;
        buf.push_back((c >> 20) & 0xFF);
        c &= 0xFFFFF;
        ct = 7;
      } else {
        buf.push_back((c >> 19) & 0xFF);
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }

  void encode(int cx, int d) {
    const Qe q = kQe[idx[cx]];
    a -= q.qe;
    if (d == mps[cx]) {
      if (a & 0x8000) {  // fast path, no renorm
        c += q.qe;
        return;
      }
      if (a < q.qe) a = q.qe;
      else c += q.qe;
      idx[cx] = q.nmps;
    } else {
      if (a < q.qe) c += q.qe;
      else a = q.qe;
      if (q.sw) mps[cx] = 1 - mps[cx];
      idx[cx] = q.nlps;
    }
    do {  // RENORME
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct -= 1;
      if (ct == 0) byteout();
    } while (!(a & 0x8000));
  }

  // SETBITS + 2 byteouts; drops a trailing 0xFF. Returns segment size
  // (bytes after the sentinel).
  size_t flush() {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf.back() == 0xFF) buf.pop_back();
    return buf.size() - 1;
  }
};

struct T1State {
  int w, h, W;
  std::vector<uint8_t> sig, chi, pi, ref;

  void init(int ww, int hh) {
    w = ww;
    h = hh;
    W = w + 2;
    size_t n = static_cast<size_t>(W) * (h + 2);
    sig.assign(n, 0);
    chi.assign(n, 0);
    pi.assign(n, 0);
    ref.assign(n, 0);
  }
};

inline int clamp1(int v) { return v < -1 ? -1 : (v > 1 ? 1 : v); }

}  // namespace

extern "C" {

// Decode one codeblock's concatenated MQ segments.
//   band: 0 LL, 1 HL, 2 LH, 3 HH (gain kinds; HL swaps h/v, HH uses
//   the second ZC table — matching _t1_decode_block's flags).
//   mag_out:  int32 [h, w];  chi_out: uint8 [h, w] (1 = negative).
// Returns undecoded_planes (>= 0) on success.
int mies_j2k_t1_decode(const uint8_t* data, size_t len, int w, int h,
                       int band, int npasses, int numbps,
                       int32_t* mag_out, uint8_t* chi_out) {
  memset(mag_out, 0, sizeof(int32_t) * w * h);
  memset(chi_out, 0, sizeof(uint8_t) * w * h);
  if (numbps <= 0 || npasses <= 0) return numbps > 0 ? numbps : 0;
  MQDec mq;
  mq.init(data, len);
  const bool hl = band == 1;
  const int hh_tbl = band == 3 ? 1 : 0;
  T1State st;
  st.init(w, h);
  uint8_t* sig = st.sig.data();
  uint8_t* chi = st.chi.data();
  uint8_t* pi = st.pi.data();
  uint8_t* ref = st.ref.data();
  const int W = st.W;

  auto sign_decode = [&](int p) -> int {
    int hsum = sig[p - 1] * (1 - 2 * chi[p - 1]) +
               sig[p + 1] * (1 - 2 * chi[p + 1]);
    int vsum = sig[p - W] * (1 - 2 * chi[p - W]) +
               sig[p + W] * (1 - 2 * chi[p + W]);
    hsum = clamp1(hsum);
    vsum = clamp1(vsum);
    return mq.decode(kScCtx[hsum + 1][vsum + 1]) ^
           kScXor[hsum + 1][vsum + 1];
  };
  auto zc = [&](int p) -> int {
    int hn = sig[p - 1] + sig[p + 1];
    int vn = sig[p - W] + sig[p + W];
    int dn = sig[p - W - 1] + sig[p - W + 1] + sig[p + W - 1] +
             sig[p + W + 1];
    if (hl) {
      int t = hn;
      hn = vn;
      vn = t;
    }
    return kZc.t[hh_tbl][hn][vn][dn];
  };

  int passes_left = npasses;
  int plane = numbps - 1;
  bool first = true;
  while (passes_left > 0 && plane >= 0) {
    const int32_t bit = 1 << plane;
    const int order0 = first ? 2 : 0;  // 0 spp, 1 mrp, 2 cup
    first = false;
    for (int kind = order0; kind <= 2; ++kind) {
      if (passes_left <= 0) break;
      passes_left -= 1;
      for (int y0 = 0; y0 < h; y0 += 4) {
        const int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          const int col = (y0 + 1) * W + (x + 1);
          if (kind == 0) {  // significance propagation
            int p = col;
            for (int y = y0; y < ylim; ++y, p += W) {
              if (!sig[p]) {
                int cxt = zc(p);
                if (cxt != 0) {
                  pi[p] = 1;
                  if (mq.decode(cxt)) {
                    sig[p] = 1;
                    chi[p] = static_cast<uint8_t>(sign_decode(p));
                    mag_out[y * w + x] = bit;
                  }
                }
              }
            }
          } else if (kind == 1) {  // magnitude refinement
            int p = col;
            for (int y = y0; y < ylim; ++y, p += W) {
              if (sig[p] && !pi[p]) {
                int cxt;
                if (ref[p]) {
                  cxt = 16;
                } else {
                  bool any_n = sig[p - 1] || sig[p + 1] || sig[p - W] ||
                               sig[p + W] || sig[p - W - 1] ||
                               sig[p - W + 1] || sig[p + W - 1] ||
                               sig[p + W + 1];
                  cxt = any_n ? 15 : 14;
                }
                if (mq.decode(cxt)) mag_out[y * w + x] |= bit;
                ref[p] = 1;
              }
            }
          } else {  // cleanup
            int y = y0;
            if (ylim - y0 == 4) {
              bool rl = true;
              int p = col;
              for (int k = 0; k < 4; ++k, p += W) {
                if (sig[p] || pi[p] || zc(p) != 0) {
                  rl = false;
                  break;
                }
              }
              if (rl) {
                if (!mq.decode(kCtxRL)) continue;  // next column
                int k = (mq.decode(kCtxUNI) << 1) | mq.decode(kCtxUNI);
                y = y0 + k;
                p = y * W + W + (x + 1);
                sig[p] = 1;
                chi[p] = static_cast<uint8_t>(sign_decode(p));
                mag_out[y * w + x] = bit;
                y += 1;
              }
            }
            int p = y * W + W + (x + 1);
            for (; y < ylim; ++y, p += W) {
              if (!sig[p] && !pi[p]) {
                if (mq.decode(zc(p))) {
                  sig[p] = 1;
                  chi[p] = static_cast<uint8_t>(sign_decode(p));
                  mag_out[y * w + x] = bit;
                }
              }
            }
          }
        }
      }
      if (kind == 2) memset(pi, 0, st.pi.size());
    }
    plane -= 1;
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      chi_out[y * w + x] = chi[(y + 1) * W + (x + 1)];
  return plane + 1;
}

// Encode one codeblock (all passes down to plane 0, one MQ segment).
//   out_cap must be >= the worst-case MQ size; returns bytes written
//   (>= 0) and *npasses_out, or -1 if out_cap is too small.
int mies_j2k_t1_encode(const int32_t* mag, const uint8_t* chi_in, int w,
                       int h, int band, int numbps, uint8_t* out,
                       size_t out_cap, int* npasses_out) {
  MQEnc mq;
  mq.init();
  const bool hl = band == 1;
  const int hh_tbl = band == 3 ? 1 : 0;
  T1State st;
  st.init(w, h);
  uint8_t* sig = st.sig.data();
  uint8_t* chi = st.chi.data();
  uint8_t* pi = st.pi.data();
  uint8_t* ref = st.ref.data();
  const int W = st.W;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      chi[(y + 1) * W + (x + 1)] = chi_in[y * w + x];

  auto sign_encode = [&](int p) {
    int hsum = sig[p - 1] * (1 - 2 * chi[p - 1]) +
               sig[p + 1] * (1 - 2 * chi[p + 1]);
    int vsum = sig[p - W] * (1 - 2 * chi[p - W]) +
               sig[p + W] * (1 - 2 * chi[p + W]);
    hsum = clamp1(hsum);
    vsum = clamp1(vsum);
    mq.encode(kScCtx[hsum + 1][vsum + 1],
              chi[p] ^ kScXor[hsum + 1][vsum + 1]);
  };
  auto zc = [&](int p) -> int {
    int hn = sig[p - 1] + sig[p + 1];
    int vn = sig[p - W] + sig[p + W];
    int dn = sig[p - W - 1] + sig[p - W + 1] + sig[p + W - 1] +
             sig[p + W + 1];
    if (hl) {
      int t = hn;
      hn = vn;
      vn = t;
    }
    return kZc.t[hh_tbl][hn][vn][dn];
  };

  int npasses = 0;
  int plane = numbps - 1;
  bool first = true;
  while (plane >= 0) {
    const int32_t bit = 1 << plane;
    const int order0 = first ? 2 : 0;
    first = false;
    for (int kind = order0; kind <= 2; ++kind) {
      npasses += 1;
      for (int y0 = 0; y0 < h; y0 += 4) {
        const int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          const int col = (y0 + 1) * W + (x + 1);
          if (kind == 0) {
            int p = col;
            for (int y = y0; y < ylim; ++y, p += W) {
              if (!sig[p]) {
                int cxt = zc(p);
                if (cxt != 0) {
                  pi[p] = 1;
                  int b = (mag[y * w + x] & bit) ? 1 : 0;
                  mq.encode(cxt, b);
                  if (b) {
                    sig[p] = 1;
                    sign_encode(p);
                  }
                }
              }
            }
          } else if (kind == 1) {
            int p = col;
            for (int y = y0; y < ylim; ++y, p += W) {
              if (sig[p] && !pi[p]) {
                int cxt;
                if (ref[p]) {
                  cxt = 16;
                } else {
                  bool any_n = sig[p - 1] || sig[p + 1] || sig[p - W] ||
                               sig[p + W] || sig[p - W - 1] ||
                               sig[p - W + 1] || sig[p + W - 1] ||
                               sig[p + W + 1];
                  cxt = any_n ? 15 : 14;
                }
                mq.encode(cxt, (mag[y * w + x] & bit) ? 1 : 0);
                ref[p] = 1;
              }
            }
          } else {
            int y = y0;
            if (ylim - y0 == 4) {
              bool rl = true;
              int p = col;
              for (int k = 0; k < 4; ++k, p += W) {
                if (sig[p] || pi[p] || zc(p) != 0) {
                  rl = false;
                  break;
                }
              }
              if (rl) {
                int k = -1;
                for (int kk = 0; kk < 4; ++kk) {
                  if (mag[(y0 + kk) * w + x] & bit) {
                    k = kk;
                    break;
                  }
                }
                if (k < 0) {
                  mq.encode(kCtxRL, 0);
                  continue;  // next column
                }
                mq.encode(kCtxRL, 1);
                mq.encode(kCtxUNI, (k >> 1) & 1);
                mq.encode(kCtxUNI, k & 1);
                y = y0 + k;
                p = y * W + W + (x + 1);
                sig[p] = 1;
                sign_encode(p);
                y += 1;
              }
            }
            int p = y * W + W + (x + 1);
            for (; y < ylim; ++y, p += W) {
              if (!sig[p] && !pi[p]) {
                int b = (mag[y * w + x] & bit) ? 1 : 0;
                mq.encode(zc(p), b);
                if (b) {
                  sig[p] = 1;
                  sign_encode(p);
                }
              }
            }
          }
        }
      }
      if (kind == 2) memset(pi, 0, st.pi.size());
    }
    plane -= 1;
  }
  size_t n = mq.flush();
  if (n > out_cap) return -1;
  memcpy(out, mq.buf.data() + 1, n);
  *npasses_out = npasses;
  return static_cast<int>(n);
}

}  // extern "C"
