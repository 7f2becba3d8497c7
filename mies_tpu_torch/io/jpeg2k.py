"""JPEG 2000 Part-1 (ISO/IEC 15444-1) decoder — pure Python, from spec.

Closes the last clinical DICOM transfer-syntax family (SURVEY.md §2b D9:
compressed DICOM; J2K Lossless / J2K follow the RLE/JPEG/JPEG-LS
codecs).  Scope is the profile clinical encoders (OpenJPEG, Kakadu
defaults) actually emit for monochrome medical frames:

* raw codestreams and JP2 containers (the ``jp2c`` box is located and
  the codestream decoded from it);
* single-component (grayscale) images, 1-16 bits, signed or unsigned,
  arbitrary image/tile offsets and tile grids; 3-component color with
  the reversible RCT (5/3) or irreversible ICT (9/7) multiple-
  component transform, incl. per-component QCC (color ultrasound /
  secondary-capture archives);
* reversible 5/3 (lossless, .4.90) and irreversible 9/7 (.4.91) with
  style-0/1/2 quantization (none / scalar derived / scalar expounded);
* LRCP / RLCP / RPCL progressions generally, PCRL / CPRL when every
  resolution has one precinct (they collapse to RPCL order then);
* full EBCOT Tier-1 (MQ coder, significance / refinement / cleanup
  passes with run-length mode) and Tier-2 (tag trees, packet headers,
  Lblock, SOP / EPH markers), multiple layers, multiple tile-parts,
  truncated (rate-limited) codestreams via per-coefficient half-bin
  reconstruction.

Unsupported (refused with the feature NAMED): component counts other
than 1/3, subsampled or mixed-depth components, codeblock-style bits
(arithmetic bypass / reset / termination / vertically-causal /
segmentation symbols), POC / PPM / PPT / RGN markers.  None are
emitted by the default OpenJPEG/Kakadu lossless paths that dominate
PACS archives.

Goldens: Pillow's OpenJPEG binding encodes in this environment, so —
unlike the CharLS/kornia pins — the golden source lives in-tree and the
parity tests run everywhere: reversible streams must decode BIT-EXACTLY
to Pillow's decode, irreversible within ±1 code value (float order).

Layout follows io/jpegls.py: stdlib + numpy only, codestream in ->
one 2-D numpy frame out, guidance-bearing errors naming the feature.
"""

from __future__ import annotations

import math
import struct

import numpy as np

# ---------------------------------------------------------------------------
# MQ arithmetic decoder (ISO 15444-1 Annex C, software conventions)
# ---------------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH) — Table C.2.
_QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# T1 context indices (D.3): 0-8 zero coding, 9-13 sign, 14-16 magnitude
# refinement, 17 run-length, 18 uniform.
_CTX_RL = 17
_CTX_UNI = 18
_N_CTX = 19


class _MQDecoder:
    """Annex C decoder.  Bytes past the end read as 0xFF (the marker-
    found path feeds 1-bits forever, C.2.5) so truncated segments decode
    the way every conformant implementation handles them."""

    __slots__ = ("data", "bp", "c", "a", "ct", "idx", "mps")

    def __init__(self, data: bytes):
        self.data = data
        # per-context (state index, MPS); C.2.4 table: all (0,0) except
        # ZC context 0 -> 4, run-length -> 3, uniform -> 46.
        self.idx = [0] * _N_CTX
        self.mps = [0] * _N_CTX
        self.idx[0] = 4
        self.idx[_CTX_RL] = 3
        self.idx[_CTX_UNI] = 46
        # INITDEC
        self.bp = 0
        self.c = self._b() << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _b(self, off: int = 0) -> int:
        i = self.bp + off
        return self.data[i] if i < len(self.data) else 0xFF

    def _bytein(self) -> None:
        if self._b() == 0xFF:
            if self._b(1) > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._b() << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._b() << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        qe, nmps, nlps, switch = _QE[self.idx[cx]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange (C-17)
            if self.a < qe:
                d = self.mps[cx]
                self.idx[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                self.idx[cx] = nlps
            self.a = qe
        else:
            self.c = (self.c - (qe << 16)) & 0xFFFFFFFF
            if self.a & 0x8000:
                return self.mps[cx]
            # MPS exchange (C-16)
            if self.a < qe:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                self.idx[cx] = nlps
            else:
                d = self.mps[cx]
                self.idx[cx] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ---------------------------------------------------------------------------
# Packet-header bit reader (B.10.1 bit stuffing) and tag trees (B.10.2)
# ---------------------------------------------------------------------------


class _Truncated(ValueError):
    """A packet header or body runs past the end of the tile data —
    the file was cut mid-packet. ``_decode_tile`` catches this and
    keeps every packet already decoded (the same decode-what-is-
    present contract ``_collect_tileparts`` applies to a truncated
    last tile-part); it only escapes as an error for callers parsing
    packets outside a tile walk."""


class _HdrBits:
    """MSB-first reader over packet-header bytes: a byte following 0xFF
    carries only 7 payload bits (its MSB is the stuffed 0)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self._bits = 0  # bits remaining in _cur
        self._cur = 0
        self._prev_ff = False

    def bit(self) -> int:
        if self._bits == 0:
            if self.pos >= len(self.data):
                raise _Truncated("packet header overruns tile data")
            byte = self.data[self.pos]
            self.pos += 1
            if self._prev_ff:
                self._bits = 7  # stuffed byte: MSB is not payload
            else:
                self._bits = 8
            self._cur = byte
            self._prev_ff = byte == 0xFF
        self._bits -= 1
        return (self._cur >> self._bits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """End of packet header: discard the partial byte and return
        the byte offset of the packet body.  When the last header byte
        read was 0xFF, the byte after it is a stuffed byte that BELONGS
        to the header (B.10.1 — headers never end on 0xFF; the writer's
        flush emits the extra byte, OpenJPEG's ``opj_bio_inalign`` skips
        it the same way)."""
        if self._prev_ff:
            self.pos += 1
        self._bits = 0
        self._prev_ff = False
        return self.pos


class _TagTree:
    """B.10.2 tag tree over a w x h leaf grid; node state persists
    across layers (decoding is incremental in the threshold)."""

    def __init__(self, w: int, h: int):
        self.w, self.h = max(w, 1), max(h, 1)
        sizes = []
        ww, hh = self.w, self.h
        while True:
            sizes.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww, hh = (ww + 1) // 2, (hh + 1) // 2
        self.sizes = sizes
        self.low = [np.zeros(s[0] * s[1], np.int32) for s in sizes]
        self.known = [np.zeros(s[0] * s[1], bool) for s in sizes]

    def _path(self, i: int, j: int):
        out = []
        for lvl, (ww, _hh) in enumerate(self.sizes):
            out.append((lvl, j * ww + i))
            i, j = i // 2, j // 2
        return reversed(out)  # root first

    def decode(self, i: int, j: int, threshold: int, rd: _HdrBits) -> bool:
        """True iff leaf value is known and < threshold."""
        low = 0
        for lvl, k in self._path(i, j):
            if self.low[lvl][k] < low:
                self.low[lvl][k] = low
            while not self.known[lvl][k] and self.low[lvl][k] < threshold:
                if rd.bit():
                    self.known[lvl][k] = True
                else:
                    self.low[lvl][k] += 1
            low = self.low[lvl][k]
            if low >= threshold:
                return False
        return True

    def value(self, i: int, j: int, rd: _HdrBits) -> int:
        """Fully resolve the leaf (zero-bitplane trees, B.10.5)."""
        lvl = 0
        k = j * self.w + i
        t = int(self.low[lvl][k]) + 1
        while not self.decode(i, j, t, rd):
            t += 1
        return int(self.low[lvl][k])


# ---------------------------------------------------------------------------
# Tier-1 context formation (Annex D) and the EBCOT block decoder
# ---------------------------------------------------------------------------


def _zc_ctx(h: int, v: int, d: int, hh: bool) -> int:
    """Zero-coding context (Table D.1).  Callers pre-swap h/v for HL."""
    if not hh:
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else (1 if hv == 1 else 0)


# [hh][h][v][d] -> context; h,v in 0..2, d in 0..4
_ZC_LUT = tuple(
    tuple(
        tuple(tuple(_zc_ctx(h, v, d, bool(hh)) for d in range(5))
              for v in range(3))
        for h in range(3)
    )
    for hh in range(2)
)

# (H+1, V+1) -> (sign context, xor bit) — Table D.2.  H/V are the
# clamped sums of the horizontal / vertical neighbour sign
# contributions (+1 significant-positive, -1 significant-negative).
_SC_LUT = (
    ((13, 1), (12, 1), (11, 1)),  # H = -1 : V = -1, 0, +1
    ((10, 1), (9, 0), (10, 0)),   # H =  0
    ((11, 0), (12, 0), (13, 0)),  # H = +1
)


def _t1_decode_block(
    w: int,
    h: int,
    band: str,
    data: bytes,
    npasses: int,
    numbps: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode one codeblock's concatenated MQ segments.

    Returns ``(mag int32 [h, w], chi uint8 [h, w] (1 = negative),
    undecoded_planes)`` — the last is > 0 only for truncated
    (rate-limited) codestreams and drives half-bin reconstruction.
    No codeblock-style flags are supported (the caller refuses them),
    so passes share one MQ segment and contexts persist across passes.
    """
    if numbps <= 0 or npasses <= 0:
        return (
            np.zeros((h, w), np.int32),
            np.zeros((h, w), np.uint8),
            max(numbps, 0),
        )
    mq = _MQDecoder(data)
    dec = mq.decode
    hl = band == "HL"
    hh_lut = _ZC_LUT[1 if band == "HH" else 0]
    # 1-padded planes: neighbour reads never branch on bounds.
    W = w + 2
    sig = bytearray(W * (h + 2))
    chi = bytearray(W * (h + 2))
    pi = bytearray(W * (h + 2))  # visited in the current SPP
    ref = bytearray(W * (h + 2))  # refined at least once
    mag = np.zeros((h, w), np.int32)

    def sign_decode(p: int) -> int:
        """Decode the sign for padded index p; returns chi (1 = neg)."""
        hsum = (sig[p - 1] * (1 - 2 * chi[p - 1])
                + sig[p + 1] * (1 - 2 * chi[p + 1]))
        vsum = (sig[p - W] * (1 - 2 * chi[p - W])
                + sig[p + W] * (1 - 2 * chi[p + W]))
        hsum = -1 if hsum < -1 else (1 if hsum > 1 else hsum)
        vsum = -1 if vsum < -1 else (1 if vsum > 1 else vsum)
        ctx, xor = _SC_LUT[hsum + 1][vsum + 1]
        return dec(ctx) ^ xor

    def zc(p: int) -> int:
        hn = sig[p - 1] + sig[p + 1]
        vn = sig[p - W] + sig[p + W]
        dn = (sig[p - W - 1] + sig[p - W + 1]
              + sig[p + W - 1] + sig[p + W + 1])
        if hl:
            hn, vn = vn, hn
        return hh_lut[hn][vn][dn]

    passes_left = npasses
    plane = numbps - 1
    first = True
    while passes_left > 0 and plane >= 0:
        bit = 1 << plane
        order = ("cup",) if first else ("spp", "mrp", "cup")
        first = False
        for kind in order:
            if passes_left <= 0:
                break
            passes_left -= 1
            for y0 in range(0, h, 4):
                ylim = min(y0 + 4, h)
                for x in range(w):
                    col = (y0 + 1) * W + (x + 1)
                    if kind == "spp":
                        p = col
                        for _y in range(y0, ylim):
                            if not sig[p]:
                                c = zc(p)
                                if c != 0:
                                    pi[p] = 1
                                    if dec(c):
                                        sig[p] = 1
                                        chi[p] = sign_decode(p)
                                        mag[_y, x] = bit
                            p += W
                    elif kind == "mrp":
                        p = col
                        for _y in range(y0, ylim):
                            if sig[p] and not pi[p]:
                                if ref[p]:
                                    c = 16
                                else:
                                    any_n = (
                                        sig[p - 1] or sig[p + 1]
                                        or sig[p - W] or sig[p + W]
                                        or sig[p - W - 1] or sig[p - W + 1]
                                        or sig[p + W - 1] or sig[p + W + 1]
                                    )
                                    c = 15 if any_n else 14
                                if dec(c):
                                    mag[_y, x] |= bit
                                ref[p] = 1
                            p += W
                    else:  # cleanup
                        y = y0
                        if ylim - y0 == 4:
                            # run-length eligibility: whole column
                            # uncoded, insignificant, zero contexts
                            rl = True
                            p = col
                            for _ in range(4):
                                if sig[p] or pi[p] or zc(p) != 0:
                                    rl = False
                                    break
                                p += W
                            if rl:
                                if not dec(_CTX_RL):
                                    continue  # next column
                                k = (dec(_CTX_UNI) << 1) | dec(_CTX_UNI)
                                y = y0 + k
                                p = y * W + W + (x + 1)
                                sig[p] = 1
                                chi[p] = sign_decode(p)
                                mag[y, x] = bit
                                y += 1
                        p = y * W + W + (x + 1)
                        for _y in range(y, ylim):
                            if not sig[p] and not pi[p]:
                                if dec(zc(p)):
                                    sig[p] = 1
                                    chi[p] = sign_decode(p)
                                    mag[_y, x] = bit
                            p += W
            if kind == "cup":
                pi[:] = bytes(len(pi))
        plane -= 1
    undecoded = plane + 1
    out_chi = (
        np.frombuffer(bytes(chi), np.uint8)
        .reshape(h + 2, W)[1:-1, 1:-1]
        .copy()
    )
    return mag, out_chi, undecoded


def _native_t1() -> bool:
    """The C++ Tier-1 twin (native/jpeg2k_t1.cpp) is the default hot
    path (~100x the bit-serial Python loops, measured at 2.7 s per
    512² 12-bit frame); ``MIES_TPU_J2K_NATIVE=0`` pins pure Python.
    Both are bit-equal — tests compare them block- and stream-level."""
    import os

    if os.environ.get("MIES_TPU_J2K_NATIVE", "1") == "0":
        return False
    from mies_tpu_torch import native

    return native.available()


def _t1_decode(w, h, band, data, npasses, numbps):
    if _native_t1():
        from mies_tpu_torch import native

        return native.t1_decode(data, w, h, band, npasses, numbps)
    return _t1_decode_block(w, h, band, data, npasses, numbps)


def _t1_encode(mag, chi, band, numbps):
    if _native_t1():
        from mies_tpu_torch import native

        return native.t1_encode(mag, chi, band, numbps)
    return _t1_encode_block(mag, chi, band, numbps)


# ---------------------------------------------------------------------------
# Codestream structures (Annex A markers, Annex B geometry)
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


_REFUSED_MARKERS = {
    0x5E: "RGN (ROI shift)",
    0x5F: "POC (progression order change)",
    0x60: "PPM (packed packet headers, main)",
    0x61: "PPT (packed packet headers, tile)",
}
# markers that are pure metadata: skip their segment
_SKIPPED_MARKERS = {0x55, 0x57, 0x58, 0x63, 0x64}  # TLM PLM PLT CRG COM

_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


class _Cb:
    """One codeblock: band-coordinate rect + Tier-2 decode state."""

    __slots__ = ("x0", "y0", "x1", "y1", "lblock", "zbp", "npasses",
                 "segs", "ht_ref")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.lblock = 3
        self.zbp = -1  # -1: never included
        self.npasses = 0
        self.segs: list[bytes] = []
        self.ht_ref = 0  # bytes of the HT refinement segment


class _Precinct:
    __slots__ = ("cbs", "ncw", "nch", "incl", "zbps")

    def __init__(self, cbs, ncw, nch):
        self.cbs = cbs  # row-major list of _Cb (may be empty)
        self.ncw, self.nch = ncw, nch
        self.incl = _TagTree(ncw, nch)
        self.zbps = _TagTree(ncw, nch)


class _Band:
    __slots__ = ("kind", "x0", "y0", "x1", "y1", "precincts", "eps", "mu")

    def __init__(self, kind, x0, y0, x1, y1, eps, mu):
        self.kind = kind
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.precincts: list[_Precinct] = []
        self.eps, self.mu = eps, mu


class _Res:
    __slots__ = ("r", "x0", "y0", "x1", "y1", "bands", "nprec", "npw", "nph")

    def __init__(self, r, x0, y0, x1, y1):
        self.r = r
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.bands: list[_Band] = []
        self.nprec = self.npw = self.nph = 0


def _band_lo(u: int, off: int) -> int:
    """Resolution-grid coordinate -> subband coordinate (B-15)."""
    return _cdiv(u - off, 2)


def _build_tile(tx0, ty0, tx1, ty1, cod, qcd, ctx) -> list[_Res]:
    """Annex B geometry for one tile-component (no subsampling)."""
    nl = cod["nl"]
    reses = []
    for r in range(nl + 1):
        den = 1 << (nl - r)
        trx0, try0 = _cdiv(tx0, den), _cdiv(ty0, den)
        trx1, try1 = _cdiv(tx1, den), _cdiv(ty1, den)
        res = _Res(r, trx0, try0, trx1, try1)
        ppx, ppy = cod["prec"][r]
        if trx1 > trx0 and try1 > try0:
            res.npw = _cdiv(trx1, 1 << ppx) - (trx0 >> ppx)
            res.nph = _cdiv(try1, 1 << ppy) - (try0 >> ppy)
        res.nprec = res.npw * res.nph
        if r == 0:
            kinds = (("LL", 0, 0),)
            cb_x = min(cod["xcb"], ppx)
            cb_y = min(cod["ycb"], ppy)
            # precinct window -> band coords is identity at r = 0
            bppx, bppy = ppx, ppy
        else:
            kinds = (("HL", 1, 0), ("LH", 0, 1), ("HH", 1, 1))
            cb_x = min(cod["xcb"], ppx - 1)
            cb_y = min(cod["ycb"], ppy - 1)
            bppx, bppy = ppx - 1, ppy - 1
        for kind, xob, yob in kinds:
            if r == 0:
                bx0, by0, bx1, by1 = trx0, try0, trx1, try1
            else:
                bx0, by0 = _band_lo(trx0, xob), _band_lo(try0, yob)
                bx1, by1 = _band_lo(trx1, xob), _band_lo(try1, yob)
            eps, mu = _band_quant(qcd, nl, r, kind, ctx)
            band = _Band(kind, bx0, by0, bx1, by1, eps, mu)
            p0x, p0y = trx0 >> ppx, try0 >> ppy
            for pj in range(res.nph):
                for pi in range(res.npw):
                    # precinct window on the resolution grid
                    ux0 = max(trx0, (p0x + pi) << ppx)
                    ux1 = min(trx1, (p0x + pi + 1) << ppx)
                    uy0 = max(try0, (p0y + pj) << ppy)
                    uy1 = min(try1, (p0y + pj + 1) << ppy)
                    if r == 0:
                        pbx0, pby0, pbx1, pby1 = ux0, uy0, ux1, uy1
                    else:
                        pbx0, pby0 = _band_lo(ux0, xob), _band_lo(uy0, yob)
                        pbx1, pby1 = _band_lo(ux1, xob), _band_lo(uy1, yob)
                    if pbx1 <= pbx0 or pby1 <= pby0:
                        prec = _Precinct([], 0, 0)
                    else:
                        s_x, s_y = 1 << cb_x, 1 << cb_y
                        c0x, c0y = pbx0 >> cb_x, pby0 >> cb_y
                        ncw = _cdiv(pbx1, s_x) - c0x
                        nch = _cdiv(pby1, s_y) - c0y
                        cbs = []
                        for cj in range(nch):
                            for ci in range(ncw):
                                gx, gy = c0x + ci, c0y + cj
                                cbs.append(_Cb(
                                    max(pbx0, gx * s_x),
                                    max(pby0, gy * s_y),
                                    min(pbx1, (gx + 1) * s_x),
                                    min(pby1, (gy + 1) * s_y),
                                ))
                        prec = _Precinct(cbs, ncw, nch)
                    band.precincts.append(prec)
            res.bands.append(band)
        reses.append(res)
    return reses


def _band_quant(qcd, nl, r, kind, ctx) -> tuple[int, int]:
    """(exponent, mantissa) for a band — E.1.1 incl. the derived rule."""
    idx = 0 if kind == "LL" else 3 * (r - 1) + {
        "HL": 1, "LH": 2, "HH": 3,
    }[kind] - 1 + 1  # LL, then HL/LH/HH per level
    style = qcd["style"]
    if style == 1:  # scalar derived from the single LL value (E-5)
        eps0, mu0 = qcd["vals"][0]
        nb = nl if kind == "LL" else nl - r + 1
        return eps0 - nl + nb, mu0
    vals = qcd["vals"]
    if idx >= len(vals):
        raise ValueError(
            f"{ctx}: QCD lists {len(vals)} subband value(s) but band "
            f"index {idx} is needed (NL={nl})"
        )
    return vals[idx]


def _parse_num_passes(rd: _HdrBits) -> int:
    """B.10.6 codeword for the number of coding passes."""
    if not rd.bit():
        return 1
    if not rd.bit():
        return 2
    v = rd.bits(2)
    if v < 3:
        return 3 + v
    w = rd.bits(5)
    if w < 31:
        return 6 + w
    return 37 + rd.bits(7)


def _decode_packet(data, pos, res, p, layer, cod, ctx):
    """One packet's header + bodies for (resolution, precinct, layer).

    Returns the new byte position.  Codeblock contributions append to
    ``cb.segs`` / ``cb.npasses``; geometry stays untouched.
    """
    if cod["sop"]:
        # SOP segments are optional per packet; skip when present
        if data[pos:pos + 2] == b"\xff\x91":
            pos += 6
    rd = _HdrBits(data, pos)
    contrib = []
    if rd.bit():
        for band in res.bands:
            prec = band.precincts[p]
            for cj in range(prec.nch):
                for ci in range(prec.ncw):
                    cb = prec.cbs[cj * prec.ncw + ci]
                    if cb.x1 <= cb.x0 or cb.y1 <= cb.y0:
                        continue
                    if cb.zbp < 0:
                        included = prec.incl.decode(ci, cj, layer + 1, rd)
                    else:
                        included = bool(rd.bit())
                    if not included:
                        continue
                    if cb.zbp < 0:
                        cb.zbp = prec.zbps.value(ci, cj, rd)
                        cb.lblock = 3
                    np_ = _parse_num_passes(rd)
                    while rd.bit():
                        cb.lblock += 1
                    if cod.get("ht", False) and cb.npasses > 0:
                        # a later layer's HT passes: the cleanup came
                        # before, so these are SigProp/MagRef, all in
                        # the second codeword segment — one length
                        # (B.10.7.2, bits = Lblock + floor(log2(k)))
                        n2 = rd.bits(cb.lblock + np_.bit_length() - 1)
                        cb.npasses += np_
                        cb.ht_ref += n2
                        contrib.append((cb, n2))
                    elif cod.get("ht", False) and np_ > 1:
                        # T.814: the HT cleanup pass terminates its
                        # codeword segment; SigProp/MagRef share a
                        # second one — each signals its own length
                        # (B.10.7.2, bits = Lblock + floor(log2(k)))
                        n1 = rd.bits(cb.lblock)
                        n2 = rd.bits(
                            cb.lblock + (np_ - 1).bit_length() - 1
                        )
                        cb.npasses += np_
                        cb.ht_ref += n2
                        contrib.append((cb, n1 + n2))
                    else:
                        nbits = cb.lblock + np_.bit_length() - 1
                        nbytes = rd.bits(nbits)
                        cb.npasses += np_
                        contrib.append((cb, nbytes))
    pos = rd.align()
    if cod["eph"]:
        if data[pos:pos + 2] == b"\xff\x92":
            pos += 2
        else:
            raise ValueError(f"{ctx}: EPH marker missing after header")
    for cb, nbytes in contrib:
        if pos + nbytes > len(data):
            raise _Truncated(f"{ctx}: packet body overruns tile data")
        cb.segs.append(data[pos:pos + nbytes])
        pos += nbytes
    return pos


def _packet_sequence(reses, nlayers, prog, ctx):
    """Single-component order (kept for the encoder): (res, p, layer)."""
    for _c, res, p, l in _packet_sequence_mc([reses], nlayers, prog,
                                             ctx):
        yield res, p, l


def _packet_sequence_mc(reses_by_comp, nlayers, prog, ctx):
    """Yield (comp, res, precinct, layer) in codestream order (B.12)
    across every component (components share the COD geometry here —
    no subsampling, same resolution count)."""
    ncomp = len(reses_by_comp)
    nres = len(reses_by_comp[0])
    if prog in (4, 3):  # CPRL / PCRL
        if any(r.nprec > 1 for rs in reses_by_comp for r in rs):
            raise ValueError(
                f"{ctx}: PCRL/CPRL progression with multiple precincts "
                "per resolution is not supported (single-precinct "
                "streams reduce to component/resolution loops and "
                "decode fine)"
            )
    if prog == 0:  # LRCP
        for l in range(nlayers):
            for ri in range(nres):
                for c in range(ncomp):
                    res = reses_by_comp[c][ri]
                    for p in range(res.nprec):
                        yield c, res, p, l
    elif prog == 1:  # RLCP
        for ri in range(nres):
            for l in range(nlayers):
                for c in range(ncomp):
                    res = reses_by_comp[c][ri]
                    for p in range(res.nprec):
                        yield c, res, p, l
    elif prog == 2:  # RPCL
        for ri in range(nres):
            for p in range(max(rs[ri].nprec for rs in reses_by_comp)):
                for c in range(ncomp):
                    if p < reses_by_comp[c][ri].nprec:
                        for l in range(nlayers):
                            yield c, reses_by_comp[c][ri], p, l
    elif prog in (3, 4):  # PCRL / CPRL — identical under the single-
        # precinct guard above (one position: both orders reduce to
        # component -> resolution -> layer)
        for c in range(ncomp):
            for ri in range(nres):
                res = reses_by_comp[c][ri]
                for p in range(res.nprec):
                    for l in range(nlayers):
                        yield c, res, p, l
    else:
        raise ValueError(f"{ctx}: unknown progression order {prog}")


# ---------------------------------------------------------------------------
# Inverse DWT (Annex F): reversible 5/3 and irreversible 9/7
# ---------------------------------------------------------------------------

_K97 = 1.230174104914001
_ALPHA = -1.586134342059924
_BETA = -0.052980118572961
_GAMMA = 0.882911075530934
_DELTA = 0.443506852043971
# Inverse scaling step (F.4.8.2): lowpass (even) samples scale by K,
# highpass (odd) by 1/K — verified against OpenJPEG decodes of 9/7
# streams in the golden tests.
_K_EVEN = _K97
_K_ODD = 1.0 / _K97


def _mirror_idx(n: int, m: int) -> np.ndarray:
    """Whole-sample symmetric extension: absolute offsets -m .. n+m-1
    mapped into [0, n) (period 2(n-1); a length-1 signal repeats)."""
    idx = np.arange(-m, n + m)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _sr1d_53(y: np.ndarray, i0: int) -> np.ndarray:
    """Inverse 5/3 along axis 0 (batched over axis 1).  ``y`` is the
    interleaved signal whose first row has absolute coordinate i0."""
    n = y.shape[0]
    if n == 1:
        return y >> 1 if (i0 & 1) else y
    m = 2
    ext = y[_mirror_idx(n, m)]
    # absolute coordinate of ext row k is i0 - m + k
    par = (i0 - m) & 1  # parity of ext row 0
    ev = np.arange(par, n + 2 * m, 2)  # rows at even absolute coords
    od = np.arange(1 - par, n + 2 * m, 2)
    x = ext.copy()
    # STEP 1 (F-5): evens from odd neighbours
    ev_in = ev[(ev > 0) & (ev < n + 2 * m - 1)]
    x[ev_in] = ext[ev_in] - ((ext[ev_in - 1] + ext[ev_in + 1] + 2) >> 2)
    # STEP 2 (F-6): odds from reconstructed evens
    od_in = od[(od > 0) & (od < n + 2 * m - 1)]
    x[od_in] = ext[od_in] + ((x[od_in - 1] + x[od_in + 1]) >> 1)
    return x[m:m + n]


def _sr1d_97(y: np.ndarray, i0: int) -> np.ndarray:
    """Inverse 9/7 along axis 0 (float64 in/out)."""
    n = y.shape[0]
    if n == 1:
        return y / 2.0 if (i0 & 1) else y
    m = 4
    ext = y[_mirror_idx(n, m)]
    par = (i0 - m) & 1
    ev = np.arange(par, n + 2 * m, 2)  # rows at even absolute coords
    od = np.arange(1 - par, n + 2 * m, 2)
    x = ext.copy()
    x[ev] = ext[ev] * _K_EVEN
    x[od] = ext[od] * _K_ODD
    for coef, rows in ((_DELTA, ev), (_GAMMA, od), (_BETA, ev),
                       (_ALPHA, od)):
        r = rows[(rows > 0) & (rows < n + 2 * m - 1)]
        x[r] -= coef * (x[r - 1] + x[r + 1])
    return x[m:m + n]


def _interleave(ll, hl, lh, hh, x0, y0, x1, y1):
    """2D_INTERLEAVE (F.3.2) on absolute resolution-grid coords."""
    a = np.zeros((y1 - y0, x1 - x0), ll.dtype)
    ex, ox = _cdiv(x0, 2) * 2 - x0, (x0 | 1) - x0  # first even/odd col
    ey, oy = _cdiv(y0, 2) * 2 - y0, (y0 | 1) - y0
    a[ey::2, ex::2] = ll
    a[ey::2, ox::2] = hl
    a[oy::2, ex::2] = lh
    a[oy::2, ox::2] = hh
    return a


def _sr2d(ll, hl, lh, hh, x0, y0, x1, y1, reversible: bool):
    """One 2D_SR level: interleave, then horizontal + vertical 1D_SR."""
    a = _interleave(ll, hl, lh, hh, x0, y0, x1, y1)
    f = _sr1d_53 if reversible else _sr1d_97
    a = f(a.T, x0).T  # horizontal pass (rows)
    a = f(a, y0)  # vertical pass (columns)
    return a


# ---------------------------------------------------------------------------
# Marker segments (Annex A) and the top-level decode
# ---------------------------------------------------------------------------


def _u16(b, p):
    return struct.unpack_from(">H", b, p)[0]


def _u32(b, p):
    return struct.unpack_from(">I", b, p)[0]


def _parse_siz(seg, ctx) -> dict:
    (rsiz, xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz,
     csiz) = struct.unpack_from(">H8IH", seg, 0)
    del rsiz
    if csiz not in (1, 3):
        raise NotImplementedError(
            f"{ctx}: {csiz}-component JPEG 2000 codestream — "
            "grayscale (1) and color (3) are supported"
        )
    depths = set()
    signs = set()
    for c in range(csiz):
        ssiz, xr, yr = seg[36 + 3 * c], seg[37 + 3 * c], seg[38 + 3 * c]
        if xr != 1 or yr != 1:
            raise NotImplementedError(
                f"{ctx}: subsampled component {c} (XRsiz={xr}, "
                f"YRsiz={yr})"
            )
        depths.add((ssiz & 0x7F) + 1)
        signs.add(bool(ssiz >> 7))
    if len(depths) > 1 or len(signs) > 1:
        raise NotImplementedError(
            f"{ctx}: mixed component depths/signedness {sorted(depths)}"
        )
    depth = depths.pop()
    if depth > 16:
        raise NotImplementedError(f"{ctx}: {depth}-bit samples")
    # geometry sanity (fuzz finding: a corrupted Xsiz allocated 687
    # GiB): offsets inside the grid, nonzero tiles, a plausible total
    if not (xosiz < xsiz and yosiz < ysiz and xtsiz > 0 and ytsiz > 0
            and xtosiz <= xosiz and ytosiz <= yosiz):
        raise ValueError(
            f"{ctx}: inconsistent SIZ geometry (image {xsiz}x{ysiz} "
            f"offset {xosiz},{yosiz}; tiles {xtsiz}x{ytsiz} offset "
            f"{xtosiz},{ytosiz})"
        )
    if (xsiz - xosiz) * (ysiz - yosiz) > (1 << 28):
        raise ValueError(
            f"{ctx}: SIZ declares a {xsiz - xosiz}x{ysiz - yosiz} "
            "image (> 2^28 samples) — refusing the allocation"
        )
    return {
        "xsiz": xsiz, "ysiz": ysiz, "xosiz": xosiz, "yosiz": yosiz,
        "xtsiz": xtsiz, "ytsiz": ytsiz, "xtosiz": xtosiz,
        "ytosiz": ytosiz, "depth": depth, "signed": signs.pop(),
        "csiz": csiz,
    }


def _parse_cod_body(seg, off, scod, ctx, sg=None) -> dict:
    """SPcod/SPcoc (+ SGcod when ``sg`` is None it must be supplied)."""
    nl = seg[off]
    if nl > 32:
        raise ValueError(f"{ctx}: {nl} decomposition levels")
    xcb = (seg[off + 1] & 0x0F) + 2
    ycb = (seg[off + 2] & 0x0F) + 2
    cbstyle = seg[off + 3]
    ht = bool(cbstyle & 0x40)  # T.814: HT cleanup-pass codeblocks
    if cbstyle & 0x80:
        raise NotImplementedError(
            f"{ctx}: HT MIXED codestreams (both HT and classic "
            "codeblocks) are not supported"
        )
    if cbstyle & ~0x40:
        names = []
        for bit, nm in ((1, "selective arithmetic bypass"),
                        (2, "context reset"), (4, "termination per pass"),
                        (8, "vertically causal contexts"),
                        (16, "predictable termination"),
                        (32, "segmentation symbols")):
            if cbstyle & bit:
                names.append(nm)
        raise NotImplementedError(
            f"{ctx}: codeblock style flags not supported: "
            + ", ".join(names)
        )
    wavelet = seg[off + 4]
    if wavelet not in (0, 1):
        raise ValueError(f"{ctx}: unknown wavelet transform {wavelet}")
    if scod & 1:
        prec = []
        for r in range(nl + 1):
            b = seg[off + 5 + r]
            prec.append((b & 0x0F, b >> 4))
    else:
        prec = [(15, 15)] * (nl + 1)
    out = {
        "nl": nl, "xcb": xcb, "ycb": ycb, "wavelet": wavelet,
        "prec": prec, "sop": bool(scod & 2), "eph": bool(scod & 4),
        "ht": ht,
    }
    if sg is not None:
        out.update(sg)
    return out


def _parse_cod(seg, ctx) -> dict:
    scod = seg[0]
    prog = seg[1]
    layers = _u16(seg, 2)
    mct = seg[4]
    if mct not in (0, 1):
        raise ValueError(f"{ctx}: unknown MCT value {mct}")
    if layers == 0:
        raise ValueError(f"{ctx}: COD declares zero layers")
    sg = {"prog": prog, "layers": layers, "mct": mct}
    return _parse_cod_body(seg, 5, scod, ctx, sg)


def _parse_coc(seg, cod, ctx, csiz=1) -> dict:
    """Component-0 coding-style override (single component: Ccoc is
    one byte).  Progression/layers/SOP/EPH stay from COD."""
    if cod is None:
        raise ValueError(f"{ctx}: COC before COD")
    if csiz != 1:
        raise NotImplementedError(
            f"{ctx}: per-component COC override on a {csiz}-component "
            "stream (components share the COD style here)"
        )
    scoc = seg[1]
    scod_equiv = (scoc & 1) | (2 if cod["sop"] else 0) | (
        4 if cod["eph"] else 0)
    out = _parse_cod_body(seg, 2, scod_equiv, ctx,
                          {"prog": cod["prog"], "layers": cod["layers"],
                           "mct": cod.get("mct", 0)})
    return out


def _parse_qcd_body(seg, off, ctx) -> dict:
    sq = seg[off]
    style, guard = sq & 0x1F, sq >> 5
    body = seg[off + 1:]
    if style == 0:  # no quantization (reversible): 8-bit exponents
        vals = [(b >> 3, 0) for b in body]
    elif style == 1:  # scalar derived: one 16-bit value
        v = _u16(body, 0)
        vals = [(v >> 11, v & 0x7FF)]
    elif style == 2:  # scalar expounded: 16 bits per subband
        vals = [
            (_u16(body, 2 * i) >> 11, _u16(body, 2 * i) & 0x7FF)
            for i in range(len(body) // 2)
        ]
    else:
        raise ValueError(f"{ctx}: unknown quantization style {style}")
    return {"style": style, "guard": guard, "vals": vals}


def _collect_tileparts(buf, pos, ctx):
    """SOT..EOC walk: per-tile concatenated bitstream data."""
    tiles: dict[int, list[tuple[int, bytes]]] = {}
    n = len(buf)
    while pos < n:
        if buf[pos:pos + 2] == b"\xff\xd9":  # EOC
            break
        if buf[pos:pos + 2] != b"\xff\x90":
            raise ValueError(
                f"{ctx}: expected SOT at byte {pos}, found "
                f"{buf[pos:pos + 2]!r}"
            )
        isot = _u16(buf, pos + 4)
        psot = _u32(buf, pos + 6)
        tpsot = buf[pos + 10]
        q = pos + 2 + _u16(buf, pos + 2)
        while True:
            if q + 2 > n:
                raise ValueError(f"{ctx}: tile-part header overruns file")
            if buf[q:q + 2] == b"\xff\x93":  # SOD
                q += 2
                break
            mk = buf[q + 1]
            if mk in _REFUSED_MARKERS:
                raise NotImplementedError(
                    f"{ctx}: {_REFUSED_MARKERS[mk]} marker"
                )
            if mk in (0x52, 0x53, 0x5C, 0x5D):
                raise NotImplementedError(
                    f"{ctx}: tile-part COD/COC/QCD/QCC overrides"
                )
            q += 2 + _u16(buf, q + 2)
        if psot:
            end = pos + psot
        else:  # last tile-part: runs to EOC (or EOF on truncation)
            e = buf.rfind(b"\xff\xd9")
            end = e if e > q else n
        if end > n:
            end = n  # truncated file: decode what is present
        tiles.setdefault(isot, []).append((tpsot, bytes(buf[q:end])))
        pos = end
    return tiles


def _band_coeffs(band, guard, depth, reversible, ctx, ht=False):
    """Tier-1 decode every codeblock of a band -> coefficient array."""
    bw, bh = band.x1 - band.x0, band.y1 - band.y0
    arr = np.zeros((bh, bw), np.int32 if reversible else np.float64)
    if bw <= 0 or bh <= 0:
        return arr
    mb = guard + band.eps - 1
    if mb > 31:
        raise ValueError(
            f"QCD/QCC declares Mb = guard bits ({guard}) + exponent "
            f"({band.eps}) - 1 = {mb} magnitude bitplanes for the "
            f"{band.kind} band; int32 Tier-1 magnitudes support "
            f"Mb <= 31 (no real <= 16-bit stream comes close)"
        )
    if not reversible:
        rb = depth + _GAIN[band.kind]
        delta = 2.0 ** (rb - band.eps) * (1.0 + band.mu / 2048.0)
    for prec in band.precincts:
        for cb in prec.cbs:
            if cb.npasses == 0 or cb.zbp < 0:
                continue
            w, h = cb.x1 - cb.x0, cb.y1 - cb.y0
            if w <= 0 or h <= 0:
                continue
            if ht:
                from mies_tpu_torch.io.htj2k import decode_ht_block_parts

                if cb.npasses > 3:
                    raise ValueError(
                        f"{ctx}: HT codeblock with {cb.npasses} "
                        "coding passes (max 3: cleanup, SigProp, "
                        "MagRef)"
                    )
                # the HT zero-bitplane field signals P - 1 (see the
                # encoder note); the working bound is field + 1
                mag, chi, und = decode_ht_block_parts(
                    b"".join(cb.segs), w, h, cb.zbp + 1, cb.npasses,
                    mb, seg2_len=cb.ht_ref,
                )
            else:
                mag, chi, und = _t1_decode(
                    w, h, band.kind, b"".join(cb.segs), cb.npasses,
                    mb - cb.zbp,
                )
            sgn = 1 - 2 * chi.astype(np.int32)
            if reversible:
                if und > 0:  # truncated stream: half-bin midpoint
                    vals = np.where(
                        mag > 0, (mag << und) + (1 << (und - 1)), 0
                    )
                else:
                    vals = mag
                coeff = sgn * vals
            else:
                # deadzone midpoint: nonzero bins reconstruct at
                # (q + 1/2)·Δ of the (possibly widened) bin (E.1.1.2)
                vals = np.where(
                    mag > 0,
                    (mag.astype(np.float64) + 0.5) * float(1 << und),
                    0.0,
                )
                coeff = sgn * vals * delta
            arr[cb.y0 - band.y0:cb.y1 - band.y0,
                cb.x0 - band.x0:cb.x1 - band.x0] = coeff
    return arr


def _decode_tile(tdata, bounds, siz, cod, qcds, ctx):
    """One tile's packets + wavelet for EVERY component; returns the
    per-component sample planes.  ``qcds`` maps component index -> QCD
    (QCC overrides), with the plain QCD under every non-overridden
    index."""
    tx0, ty0, tx1, ty1 = bounds
    ncomp = siz.get("csiz", 1)
    reses_by_comp = [
        _build_tile(tx0, ty0, tx1, ty1, cod, qcds[c], ctx)
        for c in range(ncomp)
    ]
    pos = 0
    for _c, res, p, layer in _packet_sequence_mc(
        reses_by_comp, cod["layers"], cod["prog"], ctx
    ):
        if pos >= len(tdata):
            break  # rate-limited stream: later packets absent
        try:
            pos = _decode_packet(tdata, pos, res, p, layer, cod, ctx)
        except _Truncated:
            # file cut mid-packet: keep everything already decoded
            # (the MQ decoder reads past-end bytes as 0xFF, so a
            # block whose later segments are missing reconstructs
            # its decoded planes and stops — T.800 truncation
            # behavior, consistent with _collect_tileparts's clamp)
            break
    reversible = cod["wavelet"] == 1
    depth = siz["depth"]
    planes = []
    for c, reses in enumerate(reses_by_comp):
        guard = qcds[c]["guard"]
        ll = _band_coeffs(reses[0].bands[0], guard, depth, reversible,
                          ctx, cod.get("ht", False))
        for res in reses[1:]:
            hl, lh, hh = (
                _band_coeffs(b, guard, depth, reversible, ctx,
                             cod.get("ht", False))
                for b in res.bands
            )
            ll = _sr2d(ll, hl, lh, hh, res.x0, res.y0, res.x1, res.y1,
                       reversible)
        planes.append(ll)
    return planes


def _decode_codestream(buf: bytes, ctx: str) -> np.ndarray:
    if buf[:2] != b"\xff\x4f":
        raise ValueError(f"{ctx}: no SOC marker — not a J2K codestream")
    pos = 2
    siz = cod = qcd = None
    qccs: dict[int, dict] = {}
    n = len(buf)
    while True:
        if pos + 4 > n:
            raise ValueError(f"{ctx}: main header truncated")
        if buf[pos] != 0xFF:
            raise ValueError(f"{ctx}: bad marker at byte {pos}")
        mk = buf[pos + 1]
        if mk == 0x90:  # SOT: tile-parts begin
            break
        seglen = _u16(buf, pos + 2)
        seg = buf[pos + 4:pos + 2 + seglen]
        if mk == 0x51:
            siz = _parse_siz(seg, ctx)
        elif mk == 0x52:
            cod = _parse_cod(seg, ctx)
        elif mk == 0x53:
            cod = _parse_coc(seg, cod, ctx,
                             siz.get("csiz", 1) if siz else 1)
        elif mk == 0x5C:
            qcd = _parse_qcd_body(seg, 0, ctx)
        elif mk == 0x5D:  # QCC (1-byte component index for csiz < 257)
            qccs[seg[0]] = _parse_qcd_body(seg, 1, ctx)
        elif mk in _REFUSED_MARKERS:
            raise NotImplementedError(
                f"{ctx}: {_REFUSED_MARKERS[mk]} marker"
            )
        # anything else (COM, TLM, PLM, CRG, ...) is skippable metadata
        pos += 2 + seglen
    if siz is None or cod is None or qcd is None:
        missing = [nm for nm, v in
                   (("SIZ", siz), ("COD", cod), ("QCD", qcd)) if v is None]
        raise ValueError(f"{ctx}: main header missing {'/'.join(missing)}")
    ncomp = siz.get("csiz", 1)
    qcds = {c: qccs.get(c, qcd) for c in range(ncomp)}
    reversible = cod["wavelet"] == 1
    for c in range(ncomp):
        if reversible and qcds[c]["style"] != 0:
            raise ValueError(
                f"{ctx}: 5/3 transform with quantization style "
                f"{qcds[c]['style']} (reversible streams use style 0)"
            )
    mct = cod.get("mct", 0)
    if mct and ncomp != 3:
        raise ValueError(
            f"{ctx}: MCT declared on a {ncomp}-component stream")
    tiles = _collect_tileparts(buf, pos, ctx)
    xo, yo = siz["xosiz"], siz["yosiz"]
    oshape = (siz["ysiz"] - yo, siz["xsiz"] - xo)
    if ncomp == 3:
        oshape = oshape + (3,)
    out = np.zeros(oshape, np.int32 if reversible else np.float64)
    ntw = _cdiv(siz["xsiz"] - siz["xtosiz"], siz["xtsiz"])
    nth = _cdiv(siz["ysiz"] - siz["ytosiz"], siz["ytsiz"])
    for isot, parts in sorted(tiles.items()):
        if isot >= ntw * nth:
            raise ValueError(f"{ctx}: tile index {isot} out of range")
        parts.sort(key=lambda t: t[0])
        tdata = b"".join(d for _, d in parts)
        pi, pj = isot % ntw, isot // ntw
        tx0 = max(siz["xtosiz"] + pi * siz["xtsiz"], xo)
        tx1 = min(siz["xtosiz"] + (pi + 1) * siz["xtsiz"], siz["xsiz"])
        ty0 = max(siz["ytosiz"] + pj * siz["ytsiz"], yo)
        ty1 = min(siz["ytosiz"] + (pj + 1) * siz["ytsiz"], siz["ysiz"])
        if tx1 <= tx0 or ty1 <= ty0:
            continue
        planes = _decode_tile(tdata, (tx0, ty0, tx1, ty1), siz, cod,
                              qcds, ctx)
        if mct:  # inverse component transform, per tile (G.2/G.3)
            y_, cb, cr = planes
            if reversible:  # RCT
                g = y_ - ((cb + cr) >> 2)
                planes = [cr + g, g, cb + g]
            else:  # ICT (YCbCr, float)
                planes = [
                    y_ + 1.402 * cr,
                    y_ - 0.344136 * cb - 0.714136 * cr,
                    y_ + 1.772 * cb,
                ]
        win = (slice(ty0 - yo, ty1 - yo), slice(tx0 - xo, tx1 - xo))
        if ncomp == 3:
            for c in range(3):
                out[win[0], win[1], c] = planes[c]
        else:
            out[win] = planes[0]
    depth, signed = siz["depth"], siz["signed"]
    if not reversible:
        out = np.floor(out + 0.5)
    if signed:
        lo, hi = -(1 << (depth - 1)), (1 << (depth - 1)) - 1
        dt = np.int8 if depth <= 8 else np.int16
    else:
        out = out + (1 << (depth - 1))  # DC level shift (G.1.2)
        lo, hi = 0, (1 << depth) - 1
        dt = np.uint8 if depth <= 8 else np.uint16
    return np.clip(out, lo, hi).astype(dt)


_JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def _unwrap_jp2(blob: bytes, ctx: str) -> bytes:
    """Raw codestream passthrough, or locate the jp2c box (I.5.4)."""
    if blob[:2] == b"\xff\x4f":
        return blob
    if not blob.startswith(_JP2_SIG):
        raise ValueError(
            f"{ctx}: neither a J2K codestream (SOC) nor a JP2 file "
            "(signature box)"
        )
    pos, n = 0, len(blob)
    while pos + 8 <= n:
        lbox = _u32(blob, pos)
        tbox = blob[pos + 4:pos + 8]
        if lbox == 1:
            size = struct.unpack_from(">Q", blob, pos + 8)[0]
            hdr = 16
        elif lbox == 0:
            size = n - pos
            hdr = 8
        else:
            size = lbox
            hdr = 8
        if size < hdr or (pos + size > n and tbox != b"jp2c"):
            raise ValueError(f"{ctx}: malformed JP2 box {tbox!r}")
        if tbox == b"jp2c":
            # a file cut inside the codestream box clamps to what is
            # present (the tile walk then decodes the packets it has)
            return blob[pos + hdr:min(pos + size, n)]
        pos += size
    raise ValueError(f"{ctx}: JP2 file has no jp2c codestream box")


# ---------------------------------------------------------------------------
# Encoder: reversible 5/3, single tile, single
# quality layer, LRCP — the clinical lossless-archive profile
# (DICOM .4.90).  Reuses the decoder's geometry (_build_tile),
# progression (_packet_sequence) and context machinery (_ZC_LUT /
# _SC_LUT / _QE) so encoder and decoder walk the SAME structures;
# decode(encode(x)) is bit-exact by construction and cross-checked
# against Pillow/OpenJPEG in the golden tests.  Pure Python like the
# decoder (~seconds per 512² frame: coverage first, transcode
# J2K-heavy archives once).
# ---------------------------------------------------------------------------


class _MQEncoder:
    """Annex C.3 encoder (software conventions).  ``buf[0]`` is the
    spec's B-before-BPST sentinel; output is ``buf[1:]`` with a
    trailing 0xFF dropped (the decoder reads past-end bytes as 0xFF)."""

    __slots__ = ("buf", "c", "a", "ct", "idx", "mps")

    def __init__(self):
        self.idx = [0] * _N_CTX
        self.mps = [0] * _N_CTX
        self.idx[0] = 4
        self.idx[_CTX_RL] = 3
        self.idx[_CTX_UNI] = 46
        self.buf = bytearray(1)  # sentinel byte (never emitted)
        self.a = 0x8000
        self.c = 0
        self.ct = 12

    def _byteout(self) -> None:
        # the byte stores are 8-bit truncations (the spec's fixed-width
        # B register): after a 0xFF byte, bit 27 of C lands in the
        # stuffed byte's MSB slot; in the carry branch it was already
        # added to the previous byte and the truncation drops it
        buf = self.buf
        if buf[-1] == 0xFF:
            buf.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            buf.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            buf[-1] += 1  # carry
            if buf[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                buf.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                buf.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, cx: int, d: int) -> None:
        qe, nmps, nlps, switch = _QE[self.idx[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:  # no renorm (C.3.2 CODEMPS fast path)
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.idx[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.mps[cx] = 1 - self.mps[cx]
            self.idx[cx] = nlps
        while True:  # RENORME
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> bytes:
        # SETBITS (C.3.4)
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        out = self.buf
        if out[-1] == 0xFF:  # discard a trailing 0xFF
            del out[-1]
        return bytes(out[1:])


class _HdrWriter:
    """Packet-header bit writer — the exact mirror of ``_HdrBits``:
    MSB-first, a byte written after 0xFF carries only 7 payload bits
    (MSB stuffed 0), and a header whose last byte is 0xFF gets the
    stuffed byte appended so it never ends on 0xFF (B.10.1)."""

    def __init__(self):
        self.out = bytearray()
        self._cur = 0
        self._n = 0
        self._cap = 8

    def bit(self, b: int) -> None:
        self._cur = (self._cur << 1) | (b & 1)
        self._n += 1
        if self._n == self._cap:
            self.out.append(self._cur)
            self._cap = 7 if self._cur == 0xFF else 8
            self._cur = 0
            self._n = 0

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self) -> bytes:
        if self._n:
            self.out.append(self._cur << (self._cap - self._n))
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)  # the stuffed byte _HdrBits.align skips
        done = bytes(self.out)
        self.out = bytearray()
        self._cur = self._n = 0
        self._cap = 8
        return done


class _TagTreeEnc:
    """B.10.2 tag-tree encoder over precomputed leaf values — runs the
    SAME low/known state machine as the decoding ``_TagTree`` so the
    bit streams match call for call."""

    def __init__(self, w: int, h: int, leaves: np.ndarray):
        self.w, self.h = max(w, 1), max(h, 1)
        sizes = []
        ww, hh = self.w, self.h
        while True:
            sizes.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww, hh = (ww + 1) // 2, (hh + 1) // 2
        self.sizes = sizes
        vals = [np.asarray(leaves, np.int32).reshape(self.h, self.w)]
        for (ww, hh) in sizes[1:]:
            prev = vals[-1]
            ph, pw = prev.shape
            pad = np.full((2 * hh, 2 * ww), np.iinfo(np.int32).max,
                          np.int32)
            pad[:ph, :pw] = prev
            vals.append(
                np.minimum.reduce([pad[0::2, 0::2], pad[0::2, 1::2],
                                   pad[1::2, 0::2], pad[1::2, 1::2]])
            )
        self.vals = [v.reshape(-1) for v in vals]
        self.low = [np.zeros(s[0] * s[1], np.int32) for s in sizes]
        self.known = [np.zeros(s[0] * s[1], bool) for s in sizes]

    def _path(self, i: int, j: int):
        out = []
        for lvl, (ww, _hh) in enumerate(self.sizes):
            out.append((lvl, j * ww + i))
            i, j = i // 2, j // 2
        return reversed(out)  # root first

    def encode(self, i: int, j: int, threshold: int, wr: _HdrWriter):
        low = 0
        for lvl, k in self._path(i, j):
            if self.low[lvl][k] < low:
                self.low[lvl][k] = low
            while not self.known[lvl][k] and self.low[lvl][k] < threshold:
                if self.low[lvl][k] < self.vals[lvl][k]:
                    wr.bit(0)
                    self.low[lvl][k] += 1
                else:
                    wr.bit(1)
                    self.known[lvl][k] = True
            low = self.low[lvl][k]
            if low >= threshold:
                return

    def encode_value(self, i: int, j: int, wr: _HdrWriter):
        """Drive until the leaf is fully resolved — the mirror of the
        decoder's ``_TagTree.value`` threshold walk (stop is checked
        against the SAME threshold the decoder's decode() call used,
        else a leaf value equal to the threshold desynchronizes)."""
        k = j * self.w + i
        t = int(self.low[0][k]) + 1
        while True:
            self.encode(i, j, t, wr)
            if self.known[0][k] and self.low[0][k] < t:
                return
            t += 1


# --- forward 5/3 DWT (the exact inverse of _sr1d_53 / _sr2d) ---------------


def _sd1d_53(x: np.ndarray, i0: int) -> np.ndarray:
    """Forward 5/3 along axis 0 (batched over axis 1); ``x`` holds the
    spatial samples whose first row has absolute coordinate i0.  The
    output interleaves lowpass (even abs coords) and highpass (odd)."""
    n = x.shape[0]
    if n == 1:
        return x * 2 if (i0 & 1) else x
    m = 2
    ext = x[_mirror_idx(n, m)]
    par = (i0 - m) & 1  # parity of ext row 0
    ev = np.arange(par, n + 2 * m, 2)  # rows at even absolute coords
    od = np.arange(1 - par, n + 2 * m, 2)
    y = ext.copy()
    # highpass first (F-4): odds from spatial even neighbours
    od_in = od[(od > 0) & (od < n + 2 * m - 1)]
    y[od_in] = ext[od_in] - ((ext[od_in - 1] + ext[od_in + 1]) >> 1)
    # lowpass (F-3): evens from the freshly computed odd coefficients
    ev_in = ev[(ev > 0) & (ev < n + 2 * m - 1)]
    y[ev_in] = ext[ev_in] + ((y[ev_in - 1] + y[ev_in + 1] + 2) >> 2)
    return y[m:m + n]


def _sd2d_53(a: np.ndarray, x0: int, y0: int):
    """One forward 2D_SD level: vertical then horizontal 1D_SD (the
    reverse of _sr2d's horizontal-then-vertical), then deinterleave."""
    a = _sd1d_53(a, y0)  # vertical pass (columns)
    a = _sd1d_53(a.T, x0).T  # horizontal pass (rows)
    x1, y1 = x0 + a.shape[1], y0 + a.shape[0]
    ex, ox = _cdiv(x0, 2) * 2 - x0, (x0 | 1) - x0
    ey, oy = _cdiv(y0, 2) * 2 - y0, (y0 | 1) - y0
    return (a[ey::2, ex::2], a[ey::2, ox::2],
            a[oy::2, ex::2], a[oy::2, ox::2])  # ll, hl, lh, hh


# --- Tier-1 block encoder (the mirror of _t1_decode_block) -----------------


def _t1_encode_block(
    mag: np.ndarray, chi_in: np.ndarray, band: str, numbps: int
) -> tuple[bytes, int]:
    """Encode one codeblock; returns ``(segment bytes, npasses)``.
    Same scan pattern, contexts and pass structure as the decoder —
    all passes down to plane 0 (lossless), one MQ segment."""
    h, w = mag.shape
    mq = _MQEncoder()
    enc = mq.encode
    hl = band == "HL"
    hh_lut = _ZC_LUT[1 if band == "HH" else 0]
    W = w + 2
    sig = bytearray(W * (h + 2))
    pi = bytearray(W * (h + 2))
    ref = bytearray(W * (h + 2))
    chi = bytearray(W * (h + 2))
    cpad = np.zeros((h + 2, W), np.uint8)
    cpad[1:-1, 1:-1] = chi_in
    chi[:] = cpad.reshape(-1).tobytes()
    magl = mag.tolist()  # python ints: fast plane tests

    def sign_encode(p: int, y: int, x: int) -> None:
        hsum = (sig[p - 1] * (1 - 2 * chi[p - 1])
                + sig[p + 1] * (1 - 2 * chi[p + 1]))
        vsum = (sig[p - W] * (1 - 2 * chi[p - W])
                + sig[p + W] * (1 - 2 * chi[p + W]))
        hsum = -1 if hsum < -1 else (1 if hsum > 1 else hsum)
        vsum = -1 if vsum < -1 else (1 if vsum > 1 else vsum)
        ctx, xor = _SC_LUT[hsum + 1][vsum + 1]
        enc(ctx, chi[p] ^ xor)

    def zc(p: int) -> int:
        hn = sig[p - 1] + sig[p + 1]
        vn = sig[p - W] + sig[p + W]
        dn = (sig[p - W - 1] + sig[p - W + 1]
              + sig[p + W - 1] + sig[p + W + 1])
        if hl:
            hn, vn = vn, hn
        return hh_lut[hn][vn][dn]

    npasses = 0
    plane = numbps - 1
    first = True
    while plane >= 0:
        bit = 1 << plane
        order = ("cup",) if first else ("spp", "mrp", "cup")
        first = False
        for kind in order:
            npasses += 1
            for y0 in range(0, h, 4):
                ylim = min(y0 + 4, h)
                for x in range(w):
                    col = (y0 + 1) * W + (x + 1)
                    if kind == "spp":
                        p = col
                        for _y in range(y0, ylim):
                            if not sig[p]:
                                c = zc(p)
                                if c != 0:
                                    pi[p] = 1
                                    b = 1 if magl[_y][x] & bit else 0
                                    enc(c, b)
                                    if b:
                                        sig[p] = 1
                                        sign_encode(p, _y, x)
                            p += W
                    elif kind == "mrp":
                        p = col
                        for _y in range(y0, ylim):
                            if sig[p] and not pi[p]:
                                if ref[p]:
                                    c = 16
                                else:
                                    any_n = (
                                        sig[p - 1] or sig[p + 1]
                                        or sig[p - W] or sig[p + W]
                                        or sig[p - W - 1] or sig[p - W + 1]
                                        or sig[p + W - 1] or sig[p + W + 1]
                                    )
                                    c = 15 if any_n else 14
                                enc(c, 1 if magl[_y][x] & bit else 0)
                                ref[p] = 1
                            p += W
                    else:  # cleanup
                        y = y0
                        if ylim - y0 == 4:
                            rl = True
                            p = col
                            for _ in range(4):
                                if sig[p] or pi[p] or zc(p) != 0:
                                    rl = False
                                    break
                                p += W
                            if rl:
                                k = -1
                                for kk in range(4):
                                    if magl[y0 + kk][x] & bit:
                                        k = kk
                                        break
                                if k < 0:
                                    enc(_CTX_RL, 0)
                                    continue  # next column
                                enc(_CTX_RL, 1)
                                enc(_CTX_UNI, (k >> 1) & 1)
                                enc(_CTX_UNI, k & 1)
                                y = y0 + k
                                p = y * W + W + (x + 1)
                                sig[p] = 1
                                sign_encode(p, y, x)
                                y += 1
                        p = y * W + W + (x + 1)
                        for _y in range(y, ylim):
                            if not sig[p] and not pi[p]:
                                b = 1 if magl[_y][x] & bit else 0
                                enc(zc(p), b)
                                if b:
                                    sig[p] = 1
                                    sign_encode(p, _y, x)
                            p += W
            if kind == "cup":
                pi[:] = bytes(len(pi))
        plane -= 1
    return mq.flush(), npasses


# --- packets, markers, top-level encode -------------------------------------


def _encode_packet(res, p: int, enc_state: dict, wr: _HdrWriter) -> bytes:
    """One packet (single layer): header via the tag trees + bodies."""
    contrib = []
    for band in res.bands:
        prec = band.precincts[p]
        for cb in prec.cbs:
            if cb.x1 <= cb.x0 or cb.y1 <= cb.y0:
                continue
            st = enc_state.get(id(cb))
            if st is not None:
                contrib.append(st)
    if not any(st["inc"] for st in contrib):
        wr.bit(0)
        return wr.flush()
    wr.bit(1)
    for band in res.bands:
        prec = band.precincts[p]
        if not prec.cbs:
            continue
        key = id(prec)
        trees = enc_state.get(key)
        if trees is None:
            incl = np.ones((prec.nch, prec.ncw), np.int32)
            zbps = np.zeros((prec.nch, prec.ncw), np.int32)
            for cj in range(prec.nch):
                for ci in range(prec.ncw):
                    cb = prec.cbs[cj * prec.ncw + ci]
                    st = enc_state.get(id(cb))
                    if st is not None and st["inc"]:
                        incl[cj, ci] = 0  # included in layer 0
                        zbps[cj, ci] = st["zbp"]
            trees = (_TagTreeEnc(prec.ncw, prec.nch, incl),
                     _TagTreeEnc(prec.ncw, prec.nch, zbps))
            enc_state[key] = trees
        inc_tree, zbp_tree = trees
        for cj in range(prec.nch):
            for ci in range(prec.ncw):
                cb = prec.cbs[cj * prec.ncw + ci]
                if cb.x1 <= cb.x0 or cb.y1 <= cb.y0:
                    continue
                st = enc_state[id(cb)]
                inc_tree.encode(ci, cj, 1, wr)  # layer + 1 == 1
                if not st["inc"]:
                    continue
                zbp_tree.encode_value(ci, cj, wr)
                np_ = st["npasses"]
                # B.10.6 codeword for the number of coding passes
                if np_ == 1:
                    wr.bit(0)
                elif np_ == 2:
                    wr.bit(1)
                    wr.bit(0)
                elif np_ <= 5:
                    wr.bits(0b11, 2)
                    wr.bits(np_ - 3, 2)
                elif np_ <= 36:
                    wr.bits(0b1111, 4)
                    wr.bits(np_ - 6, 5)
                else:
                    wr.bits(0b111111111, 9)
                    wr.bits(np_ - 37, 7)
                lblock = 3
                if "ht_ref" in st:
                    # HT two-segment form: cleanup (1 pass, Lblock
                    # bits) then refinement (np-1 passes, Lblock +
                    # floor(log2(np-1)) bits)
                    n1 = len(st["data"]) - st["ht_ref"]
                    n2 = st["ht_ref"]
                    extra = max(
                        0,
                        n1.bit_length() - lblock,
                        n2.bit_length()
                        - (lblock + (np_ - 1).bit_length() - 1),
                    )
                    for _ in range(extra):
                        wr.bit(1)
                    wr.bit(0)
                    lblock += extra
                    wr.bits(n1, lblock)
                    wr.bits(n2,
                            lblock + (np_ - 1).bit_length() - 1)
                else:
                    nbytes = len(st["data"])
                    nbits = lblock + np_.bit_length() - 1
                    extra = max(0, nbytes.bit_length() - nbits)
                    for _ in range(extra):
                        wr.bit(1)
                    wr.bit(0)
                    nbits += extra
                    wr.bits(nbytes, nbits)
    hdr = wr.flush()
    bodies = b"".join(
        enc_state[id(cb)]["data"]
        for band in res.bands
        for cb in band.precincts[p].cbs
        if cb.x1 > cb.x0 and cb.y1 > cb.y0
        and enc_state[id(cb)]["inc"]
    )
    return hdr + bodies


def encode_jpeg2k(
    frame: np.ndarray,
    depth: int | None = None,
    levels: int = 5,
    ctx: str = "jpeg2k",
    ht: bool = False,
    prog: int = 0,
    ht_passes: int = 1,
) -> bytes:
    """One 2-D frame -> a reversible-5/3 J2K codestream (DICOM .4.90
    profile: single component, single tile, one quality layer, LRCP,
    64x64 codeblocks, default precincts, no SOP/EPH).

    ``ht=True`` emits an HTJ2K (Part 15 / T.814) codestream instead
    (DICOM .4.201 profile): every codeblock is a cleanup-only HT
    codeword segment (lossless, ``p = 1``), signalled via
    Rsiz bit 14 + the CAP marker + COD codeblock-style 0x40.

    ``decode_jpeg2k(encode_jpeg2k(x))`` is bit-exact (same geometry and
    context machinery on both sides), and the golden tests additionally
    decode through Pillow/OpenJPEG.  ``depth`` defaults to the dtype's
    full width; pass BitsStored for tighter DICOM streams."""
    frame = np.asarray(frame)
    color = frame.ndim == 3 and frame.shape[-1] == 3
    if (frame.ndim != 2 and not color) or frame.size == 0:
        raise ValueError(
            f"{ctx}: encoder needs a non-empty 2-D frame (or [H, W, 3] "
            f"RGB), got shape {frame.shape}"
        )
    if color and frame.dtype != np.uint8:
        raise ValueError(
            f"{ctx}: color frames must be uint8 RGB, got {frame.dtype}"
        )
    kinds = {"uint8": (8, False), "uint16": (16, False),
             "int8": (8, True), "int16": (16, True)}
    if frame.dtype.name not in kinds:
        raise ValueError(
            f"{ctx}: dtype {frame.dtype} not encodable (uint8/uint16/"
            "int8/int16)"
        )
    native_depth, signed = kinds[frame.dtype.name]
    if depth is None:
        depth = native_depth
    if not 1 <= depth <= 16:
        raise ValueError(f"{ctx}: depth {depth} out of range 1..16")
    if signed:
        lo, hi = -(1 << (depth - 1)), (1 << (depth - 1)) - 1
    else:
        lo, hi = 0, (1 << depth) - 1
    fmin, fmax = int(frame.min()), int(frame.max())
    if fmin < lo or fmax > hi:
        raise ValueError(
            f"{ctx}: frame values [{fmin}, {fmax}] exceed the "
            f"{depth}-bit {'signed' if signed else 'unsigned'} range"
        )
    h, w = frame.shape[:2]
    if not isinstance(levels, int) or not 0 <= levels <= 32:
        raise ValueError(f"{ctx}: levels must be an int in 0..32")
    nl = max(0, min(levels, min(h, w).bit_length() - 1))
    guard = 2
    ncomp = 3 if color else 1
    if prog not in (0, 1, 2, 3, 4):
        raise ValueError(f"{ctx}: progression order {prog} unknown")
    if ht_passes not in (1, 3):
        raise ValueError(
            f"{ctx}: ht_passes must be 1 (lossless cleanup-only) or "
            f"3 (cleanup + SigProp + MagRef), got {ht_passes}"
        )
    cod = {"nl": nl, "xcb": 6, "ycb": 6, "wavelet": 1,
           "prec": [(15, 15)] * (nl + 1), "sop": False, "eph": False,
           "prog": prog, "layers": 1, "mct": 1 if color else 0}

    def _qvals(d):
        vals = [(d + _GAIN["LL"], 0)]
        for _r in range(1, nl + 1):
            vals += [(d + _GAIN["HL"], 0), (d + _GAIN["LH"], 0),
                     (d + _GAIN["HH"], 0)]
        return vals

    # color: the RCT chroma planes span [-255, 255] — one extra
    # bitplane, declared via QCC for components 1/2 (G.2)
    qcd_y = {"style": 0, "guard": guard, "vals": _qvals(depth)}
    qcd_c = {"style": 0, "guard": guard, "vals": _qvals(depth + 1)}
    qcds = [qcd_y] + [qcd_c] * (ncomp - 1)
    # DC level shift (G.1.2), then the forward RCT for color (G.2)
    if color:
        r_ = frame[..., 0].astype(np.int32) - 128
        g_ = frame[..., 1].astype(np.int32) - 128
        b_ = frame[..., 2].astype(np.int32) - 128
        planes = [(r_ + 2 * g_ + b_) >> 2, b_ - g_, r_ - g_]
    else:
        cur = frame.astype(np.int32)
        if not signed:
            cur = cur - (1 << (depth - 1))
        planes = [cur]
    reses_by_comp = []
    enc_state: dict = {}
    for ci in range(ncomp):
        reses = _build_tile(0, 0, w, h, cod, qcds[ci], ctx)
        reses_by_comp.append(reses)
        cur = planes[ci]
        coeffs = {}
        for r in range(nl, 0, -1):
            res = reses[r]
            ll, hl, lh, hh = _sd2d_53(cur, res.x0, res.y0)
            coeffs[(r, "HL")], coeffs[(r, "LH")], coeffs[(r, "HH")] = (
                hl, lh, hh)
            cur = ll
        coeffs[(0, "LL")] = cur
        # Tier-1 encode every codeblock of this component
        for r, res in enumerate(reses):
            for band in res.bands:
                arr = coeffs.get((r, band.kind) if r else (0, "LL"))
                if arr is None:
                    continue
                mb = guard + band.eps - 1
                for prec in band.precincts:
                    for cb in prec.cbs:
                        if cb.x1 <= cb.x0 or cb.y1 <= cb.y0:
                            continue
                        sub = arr[cb.y0 - band.y0:cb.y1 - band.y0,
                                  cb.x0 - band.x0:cb.x1 - band.x0]
                        mag = np.abs(sub).astype(np.int32)
                        numbps = int(mag.max()).bit_length()
                        if numbps > mb:
                            raise ValueError(
                                f"{ctx}: {band.kind} coefficients need "
                                f"{numbps} magnitude bitplanes > "
                                f"Mb={mb}"
                            )
                        if numbps == 0:
                            enc_state[id(cb)] = {"inc": False}
                            continue
                        if ht:
                            from mies_tpu_torch.io.htj2k import (
                                encode_ht_block,
                                encode_ht_block_3pass,
                            )

                            if ht_passes == 3:
                                cu, ref, zbp_sig = (
                                    encode_ht_block_3pass(
                                        sub.astype(np.int64), mb))
                                enc_state[id(cb)] = {
                                    "inc": True, "zbp": zbp_sig - 1,
                                    "npasses": 3, "data": cu + ref,
                                    "ht_ref": len(ref),
                                }
                                continue
                            data, zbp_sig = encode_ht_block(
                                sub.astype(np.int64), mb)
                            # T.814 packet headers signal P - 1: the
                            # reference decoder reconstructs its
                            # working zero-bitplane count as the
                            # tag-tree value + 1 (verified against
                            # libopenjp2 — signaling P itself is
                            # rejected as "P+1 zero bitplanes in Mb
                            # bitplanes")
                            enc_state[id(cb)] = {
                                "inc": True, "zbp": zbp_sig - 1,
                                "npasses": 1, "data": data,
                            }
                            continue
                        data, np_ = _t1_encode(
                            mag, (sub < 0).astype(np.uint8), band.kind,
                            numbps)
                        enc_state[id(cb)] = {
                            "inc": True, "zbp": mb - numbps,
                            "npasses": np_, "data": data,
                        }
    wr = _HdrWriter()
    body = b"".join(
        _encode_packet(res, p, enc_state, wr)
        for _c, res, p, _layer in _packet_sequence_mc(
            reses_by_comp, 1, prog, ctx)
    )
    # markers
    out = bytearray(b"\xff\x4f")  # SOC
    ssiz = (depth - 1) | (0x80 if signed else 0)
    rsiz = 0x4000 if ht else 0  # Part-15 capability bit
    out += b"\xff\x51" + struct.pack(
        ">HH8IH", 38 + 3 * ncomp, rsiz, w, h, 0, 0, w, h, 0, 0, ncomp)
    out += bytes((ssiz, 1, 1)) * ncomp
    if ht:
        # CAP (A.2 of T.814): Pcap declares Part 15; Ccap15's low bits
        # carry MAGB = max band bitplanes, offset by 8
        magb = max(0, guard + depth + 2 - 1 - 8)
        out += b"\xff\x50" + struct.pack(
            ">HIH", 8, 1 << (32 - 15), magb)
    out += b"\xff\x52" + struct.pack(
        ">HBBHBBBBBB", 12, 0, prog, 1, cod["mct"], nl, 4, 4,
        0x40 if ht else 0, 1)
    out += b"\xff\x5c" + struct.pack(
        ">HB", 3 + len(qcd_y["vals"]), (guard << 5) | 0)
    out += bytes((eps << 3) for eps, _mu in qcd_y["vals"])
    if color:
        for ci in (1, 2):  # QCC: chroma's extra bitplane
            out += b"\xff\x5d" + struct.pack(
                ">HBB", 4 + len(qcd_c["vals"]), ci, (guard << 5) | 0)
            out += bytes((eps << 3) for eps, _mu in qcd_c["vals"])
    psot = 12 + 2 + len(body)
    out += b"\xff\x90" + struct.pack(">HHIBB", 10, 0, psot, 0, 1)
    out += b"\xff\x93" + body
    out += b"\xff\xd9"  # EOC
    return bytes(out)


def decode_jpeg2k(blob: bytes, ctx: str = "jpeg2k") -> np.ndarray:
    """One J2K/JP2 blob -> a 2-D numpy frame in the stored dtype.

    The DICOM glue (io/dicom.py `_decode_jpegll_pixeldata`) treats this
    exactly like the JPEG-LS / JPEG-lossless codecs: shape must match
    Rows/Columns, signedness reinterpretation stays with the caller.
    """
    if len(blob) < 4:
        raise ValueError(f"{ctx}: {len(blob)}-byte blob is not JPEG 2000")
    try:
        return _decode_codestream(_unwrap_jp2(bytes(blob), ctx), ctx)
    except (struct.error, IndexError) as e:
        # fuzz finding: a marker segment cut mid-field escaped as a
        # bare struct.error — surface truncation uniformly
        raise ValueError(f"{ctx}: truncated JPEG 2000 codestream") from e
