// jpegdct_scan — native T.81 sequential-DCT entropy scan decoder.
//
// Role: io/jpegdct.py's Huffman scan loop is bit-serial pure Python at
// ~0.8 s (gray) / ~1.5 s (color) per 512² q90 frame — the dominant
// cost of ultrasound/endoscopy cine ingest (.4.50 archives). This is
// the C++ twin of `_decode_scan` / `_decode_color_scan`'s entropy
// loops ONLY: it emits the exact int32 zigzag coefficients the Python
// reader produces (bit-equal by construction — the numeric layer,
// dequant + IDCT + upsample, stays in numpy). One MCU loop serves
// both forms: the grayscale non-interleaved scan is the ncomp=1,
// h=v=1 special case whose MCU raster equals the block raster.
//
// Built into _dicomfast.so next to dicomfast.cpp / jpeg2k_t1.cpp.

#include <cstdint>
#include <cstring>

namespace {

// MSB-first bit reader with T.81 byte stuffing (FF 00 -> literal FF);
// restart/EOI/DNL markers stop the feed (1-pad, F.2.2.5).
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int marker = -1;   // marker byte seen mid-scan
  bool bad = false;  // unexpected marker (corrupt stream)

  void fill() {
    while (nbits <= 48) {
      if (pos >= n) {
        acc = (acc << 8) | 0xFF;
        nbits += 8;
        continue;
      }
      uint8_t b = d[pos];
      if (b == 0xFF) {
        uint8_t nxt = pos + 1 < n ? d[pos + 1] : 0xD9;
        if (nxt == 0x00) {
          pos += 2;
        } else if ((nxt >= 0xD0 && nxt <= 0xD7) || nxt == 0xD9 ||
                   nxt == 0xDC) {
          marker = nxt;
          acc = (acc << 8) | 0xFF;
          nbits += 8;
          continue;
        } else {
          bad = true;
          acc = (acc << 8) | 0xFF;
          nbits += 8;
          continue;
        }
      } else {
        pos += 1;
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  uint32_t bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    nbits -= k;
    uint32_t v = static_cast<uint32_t>((acc >> nbits) &
                                       ((1u << k) - 1));
    acc &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
    return v;
  }

  // discard pad bits, scan forward to the next RSTn, return its index
  int align_restart() {
    acc = 0;
    nbits = 0;
    size_t p = pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] >= 0xD0 &&
                          d[p + 1] <= 0xD7))
      p += 1;
    if (p + 1 >= n) return -1;
    pos = p + 2;
    marker = -1;
    return d[p + 1] - 0xD0;
  }
};

// Canonical Huffman (T.81 C.2) in the spec's DECODE form.
struct HuffTable {
  int mincode[17], maxcode[17], valptr[17];
  uint8_t symbols[256];
  int nsym = 0;

  // counts[16] + symbols; returns bytes consumed or -1
  int load(const uint8_t* p, size_t avail) {
    if (avail < 18) return -1;
    int code = 0, k = 0;
    nsym = p[16] | (p[17] << 8);
    if (nsym > 256 || avail < 18 + static_cast<size_t>(nsym)) return -1;
    for (int ln = 1; ln <= 16; ++ln) {
      int cnt = p[ln - 1];
      valptr[ln] = k;
      mincode[ln] = code;
      code += cnt;
      k += cnt;
      maxcode[ln] = cnt ? code - 1 : -1;
      code <<= 1;
    }
    if (k != nsym) return -1;
    memcpy(symbols, p + 18, nsym);
    return 18 + nsym;
  }

  int decode(BitReader& br) const {
    int code = br.bits(1);
    int ln = 1;
    while (code > maxcode[ln]) {
      if (ln >= 16) return -1;
      code = (code << 1) | static_cast<int>(br.bits(1));
      ln += 1;
    }
    int idx = valptr[ln] + code - mincode[ln];
    if (idx < 0 || idx >= nsym) return -1;
    return symbols[idx];
  }
};

inline int32_t extend(uint32_t v, int s) {
  if (s == 0) return 0;
  return static_cast<int32_t>(v) < (1 << (s - 1))
             ? static_cast<int32_t>(v) - (1 << s) + 1
             : static_cast<int32_t>(v);
}

}  // namespace

extern "C" {

// Decode one sequential-DCT entropy scan.
//   comp_geom: per component [h, v, bw, bh] (block grid incl. MCU
//   padding); tables: per component DC then AC, each
//   counts[16] + nsym(u16 LE) + symbols[nsym].
//   out: int32, concatenated per component bh*bw*64 ZIGZAG coeffs.
// Returns 0, or: -1 truncated/corrupt entropy data, -2 bad Huffman /
// AC run, -3 restart marker out of order, -4 bad table blob.
int mies_jpeg_scan_decode(const uint8_t* data, size_t len, size_t start,
                          int ncomp, const int32_t* comp_geom,
                          const uint8_t* tables, size_t tables_len,
                          int mcux, int mcuy, int ri, int32_t* out) {
  if (ncomp < 1 || ncomp > 4) return -4;
  HuffTable dc[4], ac[4];
  size_t tp = 0;
  int32_t* comp_out[4];
  int64_t off = 0;
  for (int c = 0; c < ncomp; ++c) {
    int used = dc[c].load(tables + tp, tables_len - tp);
    if (used < 0) return -4;
    tp += used;
    used = ac[c].load(tables + tp, tables_len - tp);
    if (used < 0) return -4;
    tp += used;
    comp_out[c] = out + off;
    off += static_cast<int64_t>(comp_geom[4 * c + 2]) *
           comp_geom[4 * c + 3] * 64;
  }
  BitReader br{data, len, start};
  int32_t pred[4] = {0, 0, 0, 0};
  int next_rst = 0;
  const int64_t n_mcu = static_cast<int64_t>(mcux) * mcuy;
  int64_t i = 0;
  while (i < n_mcu) {
    int64_t stop = ri ? (i + ri < n_mcu ? i + ri : n_mcu) : n_mcu;
    for (; i < stop; ++i) {
      int64_t my = i / mcux, mx = i % mcux;
      for (int c = 0; c < ncomp; ++c) {
        const int h = comp_geom[4 * c + 0];
        const int v = comp_geom[4 * c + 1];
        const int bw = comp_geom[4 * c + 2];
        for (int iv = 0; iv < v; ++iv) {
          for (int ih = 0; ih < h; ++ih) {
            int64_t bi = (my * v + iv) * bw + mx * h + ih;
            int32_t* row = comp_out[c] + bi * 64;
            int s = dc[c].decode(br);
            if (s < 0 || s > 15) return -2;
            pred[c] += extend(br.bits(s), s);
            row[0] = pred[c];
            int k = 1;
            while (k < 64) {
              int rs = ac[c].decode(br);
              if (rs < 0) return -2;
              int r = rs >> 4, size = rs & 0x0F;
              if (size == 0) {
                if (rs == 0x00) break;  // EOB
                if (rs == 0xF0) {       // ZRL
                  k += 16;
                  continue;
                }
                return -2;
              }
              k += r;
              if (k > 63) return -2;
              row[k] = extend(br.bits(size), size);
              k += 1;
            }
            if (br.bad) return -1;
          }
        }
      }
    }
    if (ri && i < n_mcu) {
      int got = br.align_restart();
      if (got < 0) return -1;
      if (got != next_rst) return -3;
      next_rst = (next_rst + 1) & 7;
      for (int c = 0; c < ncomp; ++c) pred[c] = 0;
    }
  }
  return 0;
}

}  // extern "C"
