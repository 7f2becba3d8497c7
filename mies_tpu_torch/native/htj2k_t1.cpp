// HTJ2K (ITU-T T.814) HT cleanup-pass coder — C++ twin of
// mies_tpu_torch/io/htj2k.py (the Python module defines the semantics; this
// twin must be BIT-EQUAL, tests pin it).  Covers the hot block-level
// work: cleanup decode and lossless cleanup-only encode.  The CxtVLC
// decode tables are passed in from Python (single source of truth:
// io/htj2k_tables.py, extracted+validated from the open-source
// reference — see tools/extract_htj2k_tables.py).
//
// Error taxonomy (mirrors the module's HTError sites):
//   -1 bad segment length / Scup
//   -2 VLC over-read
//   -3 U_q exceeds zero bitplanes + 1
//   -4 significance outside the codeblock area
//   -5 encoder: no valid CxtVLC entry
//   -6 encoder: magnitude unencodable / exponent overflow
//   -7 output buffer too small
//   -8 UVLC value out of range

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

static const int MEL_E[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

// UVLC prefix decode table (T.814 7.3.5): {consumed, suffix, base}
static const int UVLC_PFX[8][3] = {
    {3, 5, 5}, {1, 0, 1}, {2, 0, 2}, {1, 0, 1},
    {3, 1, 3}, {1, 0, 1}, {2, 0, 2}, {1, 0, 1},
};

// ------------------------------------------------------------------
// decoder bit-streams (twins of _MelDec/_RevDec/_FwdDec)
// ------------------------------------------------------------------

struct MelDec {
  const uint8_t* data;
  int pos, size;
  unsigned __int128 acc;  // MSB-first queue (spill-OR preserved)
  int nbits;
  bool unstuff;
  int k;
  int runs[16];
  int nruns, rhead;

  void init(const uint8_t* d, int lcup, int scup) {
    data = d; pos = lcup - scup; size = scup - 1;
    acc = 0; nbits = 0; unstuff = false; k = 0; nruns = 0; rhead = 0;
  }
  void feed() {
    int v;
    if (size > 0) {
      v = data[pos++]; size--;
      if (size == 0) v |= 0x0F;
    } else {
      v = 0xFF;
    }
    int nb = unstuff ? 7 : 8;
    unstuff = (v == 0xFF);
    acc = (acc << nb) | (unsigned)v;  // deliberate 1-bit spill OR
    nbits += nb;
  }
  int bit() {
    if (nbits == 0) feed();
    nbits--;
    int b = (int)((acc >> nbits) & 1);
    acc &= ((unsigned __int128)1 << nbits) - 1;
    return b;
  }
  void decode_one() {
    int e = MEL_E[k];
    if (bit()) {
      runs[nruns++] = ((1 << e) - 1) * 2;
      k = (k < 11 ? k : 11) + 1;
    } else {
      int v = 0;
      for (int i = 0; i < e; i++) v = (v << 1) | bit();
      runs[nruns++] = 2 * v + 1;
      k = (k > 1 ? k : 1) - 1;
    }
  }
  int get_run() {
    if (rhead == nruns) { rhead = nruns = 0; decode_one(); }
    return runs[rhead++];
  }
};

struct RevDec {
  const uint8_t* data;
  int pos, size;
  uint64_t tmp;
  int bits;
  bool unstuff;
  bool overread;

  void init(const uint8_t* d, int lcup, int scup) {
    data = d; pos = lcup - 3; size = scup - 2; overread = false;
    int b0 = d[lcup - 2];
    tmp = (uint64_t)(b0 >> 4);
    bits = ((tmp & 7) == 7) ? 3 : 4;
    unstuff = (b0 | 0x0F) > 0x8F;
  }
  void feed() {
    int v = 0;
    if (size > 0) { v = data[pos--]; size--; }
    int nb = (unstuff && (v & 0x7F) == 0x7F) ? 7 : 8;
    tmp |= (uint64_t)v << bits;
    bits += nb;
    unstuff = v > 0x8F;
  }
  uint32_t fetch() {
    while (bits < 32) feed();
    return (uint32_t)tmp;
  }
  void advance(int n) {
    if (n > bits) { overread = true; n = bits; }
    tmp >>= n;
    bits -= n;
  }
};

struct FwdDec {
  const uint8_t* data;
  int pos, size, fill;
  uint64_t tmp;
  int bits;
  bool unstuff;

  void init(const uint8_t* d, int n, int f) {
    data = d; pos = 0; size = n; fill = f;
    tmp = 0; bits = 0; unstuff = false;
  }
  void feed() {
    int v;
    if (size > 0) { v = data[pos++]; size--; } else v = fill;
    int nb = unstuff ? 7 : 8;
    unstuff = (v == 0xFF);
    tmp |= (uint64_t)v << bits;
    bits += nb;
  }
  uint32_t fetch() {
    while (bits < 32) feed();
    return (uint32_t)tmp;
  }
  void advance(int n) {
    while (n > bits) feed();
    tmp >>= n;
    bits -= n;
  }
};

// ------------------------------------------------------------------
// encoder bit-streams (twins of _MelEnc/_RevEnc/_FwdEnc)
// ------------------------------------------------------------------

struct BitVec {
  std::vector<uint8_t> b;
  void push(int v) { b.push_back((uint8_t)v); }
  void put(uint64_t value, int n) {  // LSB first
    for (int i = 0; i < n; i++) b.push_back((value >> i) & 1);
  }
};

struct MelEnc {
  int k = 0, run = 0;
  BitVec bits;

  void encode(int event) {
    if (event) {
      int e = MEL_E[k];
      bits.push(0);
      for (int i = e - 1; i >= 0; i--) bits.push((run >> i) & 1);
      run = 0;
      k = (k > 1 ? k : 1) - 1;
    } else {
      run++;
      if (run == (1 << MEL_E[k])) {
        bits.push(1);
        run = 0;
        k = (k < 11 ? k : 11) + 1;
      }
    }
  }
  std::vector<uint8_t> flush() {
    if (run > 0) bits.push(1);
    std::vector<uint8_t> out;
    size_t i = 0, n = bits.b.size();
    int n_meaningful_last = 0, width = 8;
    while (i < n) {
      width = (!out.empty() && out.back() == 0xFF) ? 7 : 8;
      int avail = (int)(n - i);
      n_meaningful_last = avail < width ? avail : width;
      int v = 0;
      for (int j = 0; j < width; j++) {
        int b = (i + j < n) ? bits.b[i + j] : 1;
        v = (v << 1) | b;
      }
      out.push_back((uint8_t)v);
      i += width;
    }
    if (!out.empty() &&
        (((out.back() & 0xF0) == 0xF0) ||
         (n_meaningful_last > width - 4 &&
          (out.back() & 0x0F) != 0x0F))) {
      out.push_back(0x00);
    }
    return out;
  }
};

struct RevEnc {
  BitVec bits;
  // returns (nibble, bytes in read order)
  int flush(std::vector<uint8_t>& out) {
    const auto& v = bits.b;
    size_t n = v.size(), i;
    int nib;
    int f0 = n > 0 ? v[0] : 0, f1 = n > 1 ? v[1] : 0,
        f2 = n > 2 ? v[2] : 0;
    if (f0 == 1 && f1 == 1 && f2 == 1) {
      nib = 0x7;
      i = 3;
    } else {
      nib = 0;
      for (int j = 0; j < 4; j++)
        nib |= ((size_t)j < n ? v[j] : 0) << j;
      i = 4;
    }
    int prev = (nib << 4) | 0x0F;
    while (i < n) {
      bool stuffed = prev > 0x8F;
      bool all7 = (n - i) >= 7;
      for (int j = 0; all7 && j < 7; j++) all7 = v[i + j] != 0;
      int byte;
      if (stuffed && all7) {
        byte = 0x7F;
        i += 7;
      } else {
        byte = 0;
        for (int j = 0; j < 8; j++)
          byte |= (i + (size_t)j < n ? v[i + j] : 0) << j;
        i += 8;
      }
      out.push_back((uint8_t)byte);
      prev = byte;
    }
    return nib;
  }
};

struct FwdEnc {
  BitVec bits;
  std::vector<uint8_t> flush() {
    std::vector<uint8_t> out;
    size_t i = 0, n = bits.b.size();
    while (i < n) {
      int width = (!out.empty() && out.back() == 0xFF) ? 7 : 8;
      int v = 0;
      for (int j = 0; j < width; j++)
        v |= (i + (size_t)j < n ? bits.b[i + j] : 0) << j;
      out.push_back((uint8_t)v);
      i += width;
    }
    if (!out.empty() && out.back() == 0xFF) out.push_back(0x00);
    return out;
  }
};

// ------------------------------------------------------------------
// UVLC
// ------------------------------------------------------------------

struct UvlcDec {
  int u0, u1, consumed;
};

static UvlcDec dec_uvlc_pair(uint32_t v, int mode, bool initial) {
  UvlcDec r{1, 1, 0};
  if (mode == 0) return r;
  auto pfx = [&](uint32_t& val, int& ln, int& sfx, int& base) {
    const int* e = UVLC_PFX[val & 7];
    ln = e[0]; sfx = e[1]; base = e[2];
    val >>= ln;
  };
  int ln0, sfx0, b0, ln1, sfx1, b1;
  if (mode == 1 || mode == 2) {
    pfx(v, ln0, sfx0, b0);
    int u = b0 + (int)(v & ((1u << sfx0) - 1)) + 1;
    if (mode == 1) r.u0 = u; else r.u1 = u;
    r.consumed = ln0 + sfx0;
    return r;
  }
  if (mode == 3) {
    if (!initial) {
      pfx(v, ln0, sfx0, b0);
      pfx(v, ln1, sfx1, b1);
      r.u0 = b0 + (int)(v & ((1u << sfx0) - 1)) + 1;
      v >>= sfx0;
      r.u1 = b1 + (int)(v & ((1u << sfx1) - 1)) + 1;
      r.consumed = ln0 + ln1 + sfx0 + sfx1;
      return r;
    }
    pfx(v, ln0, sfx0, b0);
    if (ln0 > 2) {
      r.u1 = 2 + (int)(v & 1);
      v >>= 1;
      r.u0 = b0 + (int)(v & ((1u << sfx0) - 1)) + 1;
      r.consumed = ln0 + 1 + sfx0;
      return r;
    }
    pfx(v, ln1, sfx1, b1);
    r.u0 = b0 + (int)(v & ((1u << sfx0) - 1)) + 1;
    v >>= sfx0;
    r.u1 = b1 + (int)(v & ((1u << sfx1) - 1)) + 1;
    r.consumed = ln0 + ln1 + sfx0 + sfx1;
    return r;
  }
  // mode 4
  pfx(v, ln0, sfx0, b0);
  pfx(v, ln1, sfx1, b1);
  r.u0 = b0 + (int)(v & ((1u << sfx0) - 1)) + 3;
  v >>= sfx0;
  r.u1 = b1 + (int)(v & ((1u << sfx1) - 1)) + 3;
  r.consumed = ln0 + ln1 + sfx0 + sfx1;
  return r;
}

// raw UVLC value >= 1 -> (bits LSB-first, nbits); -1 on overflow
static int enc_uvlc_val(int val, uint32_t* out_bits) {
  if (val == 1) { *out_bits = 0b1; return 1; }
  if (val == 2) { *out_bits = 0b10; return 2; }
  if (val <= 4) { *out_bits = 0b100u | ((uint32_t)(val - 3) << 3);
                  return 4; }
  if (val > 36) return -1;
  *out_bits = ((uint32_t)(val - 5) << 3);
  return 8;
}

// emit the pair's UVLC pieces in decoder-read order; 0 ok / -8 range
static int enc_uvlc_pair(RevEnc& vlc, int u0, int u1, int mode,
                         bool initial) {
  if (mode == 0) return 0;
  uint32_t b0, b1;
  int n0, n1;
  if (mode == 1 || mode == 2) {
    n0 = enc_uvlc_val((mode == 1 ? u0 : u1) - 1, &b0);
    if (n0 < 0) return -8;
    vlc.bits.put(b0, n0);
    return 0;
  }
  if (mode == 3) {
    if (!initial) {
      n0 = enc_uvlc_val(u0 - 1, &b0);
      n1 = enc_uvlc_val(u1 - 1, &b1);
      if (n0 < 0 || n1 < 0) return -8;
      int p0 = n0 < 3 ? n0 : 3, p1 = n1 < 3 ? n1 : 3;
      vlc.bits.put(b0 & ((1u << p0) - 1), p0);
      vlc.bits.put(b1 & ((1u << p1) - 1), p1);
      if (n0 > 3) vlc.bits.put(b0 >> 3, n0 - 3);
      if (n1 > 3) vlc.bits.put(b1 >> 3, n1 - 3);
      return 0;
    }
    n0 = enc_uvlc_val(u0 - 1, &b0);
    if (n0 < 0) return -8;
    int p0 = n0 < 3 ? n0 : 3;
    vlc.bits.put(b0 & ((1u << p0) - 1), p0);
    if (u0 >= 4) {
      if (u1 != 2 && u1 != 3) return -8;
      vlc.bits.put((uint32_t)(u1 - 2), 1);
      if (n0 > 3) vlc.bits.put(b0 >> 3, n0 - 3);
      return 0;
    }
    n1 = enc_uvlc_val(u1 - 1, &b1);
    if (n1 < 0) return -8;
    int p1 = n1 < 3 ? n1 : 3;
    vlc.bits.put(b1 & ((1u << p1) - 1), p1);
    if (n0 > 3) vlc.bits.put(b0 >> 3, n0 - 3);
    if (n1 > 3) vlc.bits.put(b1 >> 3, n1 - 3);
    return 0;
  }
  // mode 4
  n0 = enc_uvlc_val(u0 - 3, &b0);
  n1 = enc_uvlc_val(u1 - 3, &b1);
  if (n0 < 0 || n1 < 0) return -8;
  int p0 = n0 < 3 ? n0 : 3, p1 = n1 < 3 ? n1 : 3;
  vlc.bits.put(b0 & ((1u << p0) - 1), p0);
  vlc.bits.put(b1 & ((1u << p1) - 1), p1);
  if (n0 > 3) vlc.bits.put(b0 >> 3, n0 - 3);
  if (n1 > 3) vlc.bits.put(b1 >> 3, n1 - 3);
  return 0;
}

static inline int bitlen64(uint64_t x) {
  return x ? 64 - __builtin_clzll(x) : 0;
}

struct EByte { int sig; int e; };

}  // namespace

// ------------------------------------------------------------------
// decode: cleanup pass of one codeblock
// ------------------------------------------------------------------

extern "C" int mies_ht_decode(
    const uint8_t* data, size_t len, int w, int h, int zbp,
    const uint16_t* tbl0, const uint16_t* tbl1,
    int32_t* mag_out, uint8_t* sgn_out) {
  if (len < 2) return -1;
  int lcup = (int)len;
  int scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0x0F);
  if (scup < 2 || scup > lcup || scup > 4079) return -1;

  MelDec mel; mel.init(data, lcup, scup);
  RevDec vlc; vlc.init(data, lcup, scup);
  FwdDec ms; ms.init(data, lcup - scup, 0xFF);

  std::memset(mag_out, 0, sizeof(int32_t) * (size_t)w * h);
  std::memset(sgn_out, 0, sizeof(uint8_t) * (size_t)w * h);

  const int limit = zbp + 1;
  const int nq = (w + 1) / 2;
  std::vector<EByte> e_prev(nq + 2, {0, 0}), e_cur(nq + 2, {0, 0});

  int mel_run = mel.get_run();

  for (int y = 0; y < h; y += 2) {
    bool initial = (y == 0);
    const uint16_t* tbl = initial ? tbl0 : tbl1;
    for (auto& e : e_cur) e = {0, 0};
    int cq_w = 0;
    uint32_t vlcval = vlc.fetch();

    for (int q = 0; q < w; q += 4) {
      int j = q / 2;
      int qinf[2] = {0, 0};
      int us[2] = {1, 1};

      auto dec_quad = [&](int idx, int ctx) {
        int e = tbl[(ctx << 7) | (vlcval & 0x7F)];
        if (ctx == 0) {
          mel_run -= 2;
          if (mel_run != -1) e = 0;
          if (mel_run < 0) mel_run = mel.get_run();
        }
        qinf[idx] = e;
        vlc.advance(e & 7);
        vlcval = vlc.fetch();
        return e;
      };

      if (initial) {
        int e0 = dec_quad(0, cq_w);
        cq_w = ((e0 >> 4) & 1) | ((e0 >> 5) & 7);
        if (q + 2 < w) {
          int e1 = dec_quad(1, cq_w);
          cq_w = ((e1 >> 4) & 1) | ((e1 >> 5) & 7);
        }
      } else {
        int ctx0 = cq_w | e_prev[j].sig | (e_prev[j + 1].sig << 2);
        int e0 = dec_quad(0, ctx0);
        cq_w = ((e0 >> 5) | (e0 >> 6)) & 2;
        if (q + 2 < w) {
          int ctx1 =
              cq_w | e_prev[j + 1].sig | (e_prev[j + 2].sig << 2);
          int e1 = dec_quad(1, ctx1);
          cq_w = ((e1 >> 5) | (e1 >> 6)) & 2;
        }
      }
      if (vlc.overread) return -2;

      int q0 = qinf[0], q1 = qinf[1];
      int mode = ((q0 >> 3) & 1) | ((q1 >> 2) & 2);
      if (initial && mode == 3) {
        mel_run -= 2;
        if (mel_run == -1) mode = 4;
        if (mel_run < 0) mel_run = mel.get_run();
      }
      UvlcDec uv = dec_uvlc_pair(vlcval, mode, initial);
      vlc.advance(uv.consumed);
      vlcval = vlc.fetch();
      if (vlc.overread) return -2;
      int u0 = uv.u0, u1 = uv.u1;
      if (!initial) {
        int r0 = q0 & 0xF0, r1 = q1 & 0xF0;
        if (r0 & (r0 - 1)) {
          int emax = e_prev[j].e > e_prev[j + 1].e ? e_prev[j].e
                                                  : e_prev[j + 1].e;
          u0 += (emax > 2 ? emax : 2) - 2;
        }
        if (r1 & (r1 - 1)) {
          int emax = e_prev[j + 1].e > e_prev[j + 2].e
                         ? e_prev[j + 1].e : e_prev[j + 2].e;
          u1 += (emax > 2 ? emax : 2) - 2;
        }
      }
      if (u0 > limit || u1 > limit) return -3;
      us[0] = u0; us[1] = u1;

      int mask = 0xFF;
      if (q + 3 >= w) mask >>= 2 * (q + 4 - w);
      if (h <= 1 || y + 1 >= h) mask &= 0x55;
      int rho_pair = ((q0 >> 4) & 0xF) | (q1 & 0xF0);
      if (rho_pair & ~mask) return -4;

      for (int slot = 0; slot < 8; slot++) {
        int quad = slot >> 2, n = slot & 3;
        int col = q + 2 * quad + (n >> 1);
        int row = y + (n & 1);
        int e = qinf[quad];
        if ((e >> 4) & (1 << n)) {
          int m = us[quad] - ((e >> (12 + n)) & 1);
          uint32_t msval =
              ms.fetch() & (m >= 32 ? 0xFFFFFFFFu
                                    : ((1u << m) - 1));
          ms.advance(m);
          int i_n = (e >> (8 + n)) & 1;
          uint64_t x = (uint64_t)(msval | 1) + ((uint64_t)i_n << m);
          mag_out[(size_t)row * w + col] = (int32_t)((x + 1) >> 1);
          sgn_out[(size_t)row * w + col] =
              m ? (uint8_t)(msval & 1) : 0;
          if (n & 1) {
            int jj = j + quad + (n >> 1);
            EByte& eb = e_cur[jj];
            int el = bitlen64(x);
            eb.sig = 1;
            if (el > eb.e) eb.e = el;
          }
        }
      }
    }
    e_prev.swap(e_cur);
  }
  return 0;
}

// ------------------------------------------------------------------
// encode: lossless cleanup-only codeblock; returns segment length
// (>0) or a negative error.  zbp_out receives the WORKING P (= B).
// ------------------------------------------------------------------

extern "C" int mies_ht_encode(
    const int32_t* coeffs, int w, int h, int B,
    const uint16_t* tbl0, const uint16_t* tbl1,
    uint8_t* out, size_t out_cap, int* zbp_out) {
  if (B > 30) return -6;
  const int zbp = B;
  const int limit = zbp + 1;
  const int nq = (w + 1) / 2;

  // encoder-side candidate lists, mirroring _build_enc_tables: per
  // (ctx, rho, u_off) the unique (len, cwd, e_k, e_1) sorted ascending
  struct Cand { uint8_t ln, e_k, e_1; uint8_t cwd; };
  auto build = [](const uint16_t* tbl,
                  std::vector<std::vector<Cand>>& m) {
    m.assign(8 * 16 * 2, {});
    for (int ctx = 0; ctx < 8; ctx++) {
      for (int wv = 0; wv < 128; wv++) {
        int e = tbl[(ctx << 7) | wv];
        int ln = e & 7;
        int cwd = wv & ((1 << ln) - 1);
        // dedupe on (entry, cwd) via linear scan (<= 128 entries)
        int rho = (e >> 4) & 0xF, u_off = (e >> 3) & 1;
        auto& v = m[(ctx * 16 + rho) * 2 + u_off];
        bool dup = false;
        for (auto& c : v)
          if (c.ln == ln && c.cwd == cwd &&
              c.e_k == ((e >> 12) & 0xF) && c.e_1 == ((e >> 8) & 0xF))
            dup = true;
        if (!dup)
          v.push_back({(uint8_t)ln, (uint8_t)((e >> 12) & 0xF),
                       (uint8_t)((e >> 8) & 0xF), (uint8_t)cwd});
      }
    }
    for (auto& v : m) {
      // sort by (ln, cwd, e_k, e_1) — the Python tuple order
      for (size_t a = 1; a < v.size(); a++)
        for (size_t b = a; b > 0; b--) {
          auto &x = v[b - 1], &y = v[b];
          bool gt = (x.ln > y.ln) ||
                    (x.ln == y.ln && (x.cwd > y.cwd ||
                     (x.cwd == y.cwd && (x.e_k > y.e_k ||
                      (x.e_k == y.e_k && x.e_1 > y.e_1)))));
          if (gt) { Cand t = x; x = y; y = t; } else break;
        }
    }
  };
  static thread_local std::vector<std::vector<Cand>> enc0, enc1;
  static thread_local const uint16_t *cached0 = nullptr,
                                     *cached1 = nullptr;
  if (cached0 != tbl0) { build(tbl0, enc0); cached0 = tbl0; }
  if (cached1 != tbl1) { build(tbl1, enc1); cached1 = tbl1; }

  MelEnc mel;
  RevEnc vlc;
  FwdEnc ms;
  std::vector<EByte> e_prev(nq + 2, {0, 0}), e_cur(nq + 2, {0, 0});

  for (int y = 0; y < h; y += 2) {
    bool initial = (y == 0);
    auto& enc = initial ? enc0 : enc1;
    for (auto& e : e_cur) e = {0, 0};
    int cq_w = 0;
    for (int q = 0; q < w; q += 4) {
      int j = q / 2;
      bool have[2] = {true, q + 2 < w};
      int rho[2] = {0, 0}, exps[2][4] = {{0}};
      for (int quad = 0; quad < 2; quad++) {
        if (!have[quad]) continue;
        for (int n = 0; n < 4; n++) {
          int col = q + 2 * quad + (n >> 1), row = y + (n & 1);
          if (row < h && col < w) {
            int64_t mu = coeffs[(size_t)row * w + col];
            if (mu < 0) mu = -mu;
            if (mu) {
              rho[quad] |= 1 << n;
              exps[quad][n] = bitlen64(2 * (uint64_t)mu - 1);
            }
          }
        }
      }
      int ctxs[2] = {0, 0}, kappas[2] = {1, 1};
      for (int quad = 0; quad < 2; quad++) {
        if (!have[quad]) continue;
        if (initial) {
          ctxs[quad] = cq_w;
        } else {
          int jj = j + quad;
          ctxs[quad] =
              cq_w | e_prev[jj].sig | (e_prev[jj + 1].sig << 2);
        }
        int r = rho[quad];
        if (!initial && (r & (r - 1))) {
          int jj = j + quad;
          int emax = e_prev[jj].e > e_prev[jj + 1].e
                         ? e_prev[jj].e : e_prev[jj + 1].e;
          kappas[quad] = (emax - 1) > 1 ? (emax - 1) : 1;
        }
        if (initial)
          cq_w = (r & 1) | ((r >> 1) & 7);
        else
          cq_w = (r & 0xC) ? 2 : 0;
      }
      int U[2] = {1, 1}, u_off[2] = {0, 0};
      for (int quad = 0; quad < 2; quad++) {
        if (!have[quad]) continue;
        int emaxq = 0;
        for (int n = 0; n < 4; n++)
          if (exps[quad][n] > emaxq) emaxq = exps[quad][n];
        U[quad] = kappas[quad] > emaxq ? kappas[quad] : emaxq;
        if (!rho[quad]) U[quad] = kappas[quad];
        u_off[quad] = (U[quad] - kappas[quad]) > 0;
        if (U[quad] > limit) return -6;
      }
      int mode = u_off[0] | (u_off[1] << 1);
      int melbit = -1;
      if (initial && mode == 3)
        melbit = (U[0] > 3 && U[1] > 3) ? 1 : 0;

      int picked[2][2] = {{0, 0}, {0, 0}};  // e_k, e_1
      for (int quad = 0; quad < 2; quad++) {
        if (!have[quad]) continue;
        if (ctxs[quad] == 0) {
          mel.encode(rho[quad] ? 1 : 0);
          if (!rho[quad]) continue;
        }
        int eps = 0;
        for (int n = 0; n < 4; n++)
          if ((rho[quad] >> n) & 1 && exps[quad][n] == U[quad])
            eps |= 1 << n;
        auto& cands =
            enc[(ctxs[quad] * 16 + rho[quad]) * 2 + u_off[quad]];
        bool found = false;
        for (auto& c : cands) {
          if (c.e_1 != (c.e_k & eps)) continue;
          if (U[quad] <= 1 && c.e_k) continue;
          picked[quad][0] = c.e_k;
          picked[quad][1] = c.e_1;
          vlc.bits.put(c.cwd, c.ln);
          found = true;
          break;
        }
        if (!found) return -5;
      }
      if (melbit >= 0) {
        mel.encode(melbit);
        if (melbit) mode = 4;
      }
      int uv0, uv1;
      if (initial) {
        uv0 = u_off[0] ? U[0] : 1;
        uv1 = u_off[1] ? U[1] : 1;
      } else {
        uv0 = u_off[0] ? U[0] - kappas[0] + 1 : 1;
        uv1 = u_off[1] ? U[1] - kappas[1] + 1 : 1;
      }
      int rc = enc_uvlc_pair(vlc, uv0, uv1, mode, initial);
      if (rc) return rc;

      for (int quad = 0; quad < 2; quad++) {
        if (!have[quad] || !rho[quad]) continue;
        int e_k = picked[quad][0], e_1 = picked[quad][1];
        for (int n = 0; n < 4; n++) {
          if (!((rho[quad] >> n) & 1)) continue;
          int col = q + 2 * quad + (n >> 1), row = y + (n & 1);
          int m = U[quad] - ((e_k >> n) & 1);
          int i_n = (e_1 >> n) & 1;
          int64_t cv = coeffs[(size_t)row * w + col];
          int64_t muv = cv < 0 ? -cv : cv;
          int64_t v = m ? muv - 1 - ((int64_t)i_n << (m - 1)) : 0;
          if (v < 0 || (m && v >= ((int64_t)1 << (m - 1 > 0
                                                  ? m - 1 : 0))))
            return -6;
          uint64_t word = ((uint64_t)v << 1) | (cv < 0 ? 1 : 0);
          ms.bits.put(word, m);
          if (n & 1) {
            uint64_t x = 2 * (uint64_t)muv - 1;
            int jj = j + quad + (n >> 1);
            EByte& eb = e_cur[jj];
            int el = bitlen64(x);
            eb.sig = 1;
            if (el > eb.e) eb.e = el;
          }
        }
      }
    }
    e_prev.swap(e_cur);
  }

  std::vector<uint8_t> magsgn = ms.flush();
  std::vector<uint8_t> melb = mel.flush();
  std::vector<uint8_t> vlcb;
  int nib = vlc.flush(vlcb);
  int scup = (int)(melb.size() + vlcb.size() + 2);
  if (scup > 4079) return -6;
  size_t total = magsgn.size() + (size_t)scup;
  if (total > out_cap) return -7;
  uint8_t* p = out;
  std::memcpy(p, magsgn.data(), magsgn.size());
  p += magsgn.size();
  std::memcpy(p, melb.data(), melb.size());
  p += melb.size();
  for (size_t i = vlcb.size(); i > 0; i--) *p++ = vlcb[i - 1];
  *p++ = (uint8_t)((nib << 4) | (scup & 0xF));
  *p++ = (uint8_t)(scup >> 4);
  *zbp_out = zbp;
  return (int)total;
}
