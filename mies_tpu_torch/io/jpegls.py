"""JPEG-LS codec (ITU-T T.87 / ISO 14495-1, LOCO-I) — decode AND encode,
for the DICOM transfer syntaxes

  * 1.2.840.10008.1.2.4.80 — JPEG-LS Lossless (NEAR = 0), and
  * 1.2.840.10008.1.2.4.81 — JPEG-LS Lossy (Near-Lossless), NEAR > 0.

JPEG-LS is the dominant modern lossless PACS syntax next to J2K (CharLS
is what pydicom/GDCM ship); after RLE, JPEG Lossless SOF3 and
the sequential-DCT family, this closes the last widely-deployed
Huffman-era gap in the DICOM reader. Implemented from the T.87 spec
with zero new dependencies (the io/jpegll.py precedent; SURVEY
section 2b D9's DICOM north star).

Scope (the framework's grayscale pixel model):
  * single-component scans, 2 <= precision <= 16, NEAR >= 0;
  * default and LSE-overridden (MAXVAL / T1 T2 T3 / RESET) parameters;
  * both regular (context-modelled Golomb) and run (RLE + interruption)
    modes, bit-stuffed per T.87 (a 0 bit follows every 0xFF byte —
    NOT T.81's 0x00 byte stuffing);
  * encode: NEAR selectable (0 = lossless), default parameters, no
    restart markers; decode: DRI/RSTn refused by name.

The coder is inherently sample-sequential (each sample's context
depends on the previous reconstruction), so both directions run
host-side over numpy state arrays — same strategy as the jpegll scan
loop. Round-trip, mode-coverage and knife-edge tests:
tests/test_io.py::TestJpegLs. No JPEG-LS library exists in this
environment to pin against; tools/verify_jpegls_golden.py replays a
CharLS-encoded golden when one is available (the skimage-pin pattern).
"""

from __future__ import annotations

import struct

import numpy as np

_SOI = 0xD8
_EOI = 0xD9
_SOS = 0xDA
_SOF55 = 0xF7  # JPEG-LS frame
_LSE = 0xF8  # JPEG-LS preset parameters
_DRI = 0xDD
_SOF_FAMILY = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}

# T.87 A.2.1 run-length code order table
_J = [
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
]
_RESET_DEFAULT = 64
_MIN_C, _MAX_C = -128, 127


def _default_thresholds(maxval: int, near: int) -> tuple[int, int, int]:
    """T.87 C.2.4.1.1.1 default T1/T2/T3 from MAXVAL and NEAR."""

    def clamp(v: int, lo: int) -> int:
        return max(lo, min(v, maxval))

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _Params:
    """Derived coding parameters (T.87 C.2.4.1)."""

    __slots__ = (
        "maxval", "near", "t1", "t2", "t3", "reset",
        "range_", "qbpp", "bpp", "limit",
    )

    def __init__(self, maxval, near, t1, t2, t3, reset):
        self.maxval = maxval
        self.near = near
        self.t1, self.t2, self.t3 = t1, t2, t3
        self.reset = reset
        self.range_ = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range_ - 1).bit_length())
        self.bpp = max(2, (maxval).bit_length())
        self.limit = 2 * (self.bpp + max(8, self.bpp))


class _State:
    """Context-model state arrays (365 regular + 2 run-interruption)."""

    __slots__ = ("A", "B", "C", "N", "Nn", "run_index")

    def __init__(self, p: _Params):
        a0 = max(2, (p.range_ + 32) // 64)
        self.A = np.full(367, a0, np.int64)
        self.B = np.zeros(367, np.int64)
        self.C = np.zeros(367, np.int64)
        self.N = np.ones(367, np.int64)
        self.Nn = np.zeros(367, np.int64)
        self.run_index = 0


def _quantize_gradient(d: int, p: _Params) -> int:
    if d <= -p.t3:
        return -4
    if d <= -p.t2:
        return -3
    if d <= -p.t1:
        return -2
    if d < -p.near:
        return -1
    if d <= p.near:
        return 0
    if d < p.t1:
        return 1
    if d < p.t2:
        return 2
    if d < p.t3:
        return 3
    return 4


def _med(a: int, b: int, c: int) -> int:
    if c >= max(a, b):
        return min(a, b)
    if c <= min(a, b):
        return max(a, b)
    return a + b - c


def _golomb_k(n: int, a: int) -> int:
    k = 0
    while (n << k) < a:
        k += 1
    return k


def _update_regular(st: _State, p: _Params, q: int, errval: int) -> None:
    """T.87 C.2.4.6 variables update + C.2.4.7 bias computation."""
    st.B[q] += errval * (2 * p.near + 1)
    st.A[q] += abs(errval)
    if st.N[q] == p.reset:
        st.A[q] >>= 1
        b = int(st.B[q])
        st.B[q] = b >> 1 if b >= 0 else -((1 - b) >> 1)
        st.N[q] >>= 1
    st.N[q] += 1
    if st.B[q] <= -st.N[q]:
        st.B[q] += st.N[q]
        if st.C[q] > _MIN_C:
            st.C[q] -= 1
        if st.B[q] <= -st.N[q]:
            st.B[q] = -st.N[q] + 1
    elif st.B[q] > 0:
        st.B[q] -= st.N[q]
        if st.C[q] < _MAX_C:
            st.C[q] += 1
        if st.B[q] > 0:
            st.B[q] = 0


# ---------------------------------------------------------------------------
# Bit IO — T.87 bit stuffing (a 0 bit after every 0xFF byte)
# ---------------------------------------------------------------------------


class _LsBitWriter:
    __slots__ = ("out", "acc", "nfree")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nfree = 8  # free bit positions in the current byte

    def bits(self, v: int, n: int) -> None:
        while n > 0:
            take = min(n, self.nfree)
            self.acc |= ((v >> (n - take)) & ((1 << take) - 1)) << (
                self.nfree - take
            )
            self.nfree -= take
            n -= take
            v &= (1 << n) - 1
            if self.nfree == 0:
                self.out.append(self.acc)
                # after a 0xFF byte only 7 bits fit (MSB is a stuffed 0)
                self.nfree = 7 if self.acc == 0xFF else 8
                self.acc = 0

    def close(self) -> bytes:
        if self.nfree < 8:
            # pad the tail with 0 bits (never forms a marker: a partial
            # byte after 0xFF carries the stuffed-0 MSB already)
            self.out.append(self.acc)
        return bytes(self.out)


class _LsBitReader:
    __slots__ = ("data", "pos", "acc", "nbits", "prev_ff")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False

    def _fill(self) -> None:
        d = self.data
        while self.nbits <= 24:
            if self.pos >= len(d):
                # past the scan: feed 0s (sample-count check catches
                # genuine truncation)
                self.acc <<= 8
                self.nbits += 8
                self.prev_ff = False
                continue
            b = d[self.pos]
            if self.prev_ff and b & 0x80:
                # marker — stop feeding real data
                self.acc <<= 8
                self.nbits += 8
                continue
            self.pos += 1
            if self.prev_ff:
                # stuffed byte: MSB is a forced 0, only 7 bits payload
                self.acc = (self.acc << 7) | (b & 0x7F)
                self.nbits += 7
            else:
                self.acc = (self.acc << 8) | b
                self.nbits += 8
            self.prev_ff = b == 0xFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def bit(self) -> int:
        return self.bits(1)


# ---------------------------------------------------------------------------
# Golomb-limited value coding (T.87 A.5.3)
# ---------------------------------------------------------------------------


def _encode_lg(bw: _LsBitWriter, val: int, k: int, glimit: int,
               qbpp: int) -> None:
    hi = val >> k
    if hi < glimit - qbpp - 1:
        bw.bits(0, hi)  # hi zeros
        bw.bits(1, 1)
        bw.bits(val & ((1 << k) - 1), k)
    else:
        bw.bits(0, glimit - qbpp - 1)
        bw.bits(1, 1)
        bw.bits(val - 1, qbpp)


def _decode_lg(br: _LsBitReader, k: int, glimit: int, qbpp: int) -> int:
    hi = 0
    while br.bit() == 0:
        hi += 1
        if hi > glimit:
            raise ValueError("corrupt JPEG-LS stream (unary overrun)")
    if hi < glimit - qbpp - 1:
        return (hi << k) | br.bits(k)
    return br.bits(qbpp) + 1


# ---------------------------------------------------------------------------
# Core codec — one scan line pair at a time, shared by encode/decode
# ---------------------------------------------------------------------------


def _modulo_range(errval: int, p: _Params) -> int:
    if errval < 0:
        errval += p.range_
    if errval >= (p.range_ + 1) // 2:
        errval -= p.range_
    return errval


def _encode_scan(img: np.ndarray, p: _Params) -> bytes:
    rows, cols = img.shape
    st = _State(p)
    bw = _LsBitWriter()
    prev = np.zeros(cols, np.int64)  # reconstructed previous line
    cur = np.zeros(cols, np.int64)
    c0 = 0  # Rc for x=0: Rb of the previous line's first sample
    t = 2 * p.near + 1
    for y in range(rows):
        src = img[y].astype(np.int64)
        x = 0
        while x < cols:
            b = int(prev[x])
            c = int(prev[x - 1]) if x > 0 else c0
            d = int(prev[x + 1]) if x + 1 < cols else int(prev[cols - 1])
            a = int(cur[x - 1]) if x > 0 else int(prev[0])
            q1 = _quantize_gradient(d - b, p)
            q2 = _quantize_gradient(b - c, p)
            q3 = _quantize_gradient(c - a, p)
            q = 81 * q1 + 9 * q2 + q3
            if q == 0:
                x = _encode_run(src, cur, prev, x, a, p, st, bw)
                continue
            if q < 0:
                sign = -1
                q = -q
            else:
                sign = 1
            px = _med(a, b, c) + sign * int(st.C[q])
            px = 0 if px < 0 else (p.maxval if px > p.maxval else px)
            ix = int(src[x])
            errval = (ix - px) * sign
            if p.near:
                if errval > 0:
                    errval = (p.near + errval) // t
                else:
                    errval = -((p.near - errval) // t)
                rx = px + sign * errval * t
                rx = 0 if rx < 0 else (p.maxval if rx > p.maxval else rx)
                cur[x] = rx
            else:
                cur[x] = ix
            errval = _modulo_range(errval, p)
            k = _golomb_k(int(st.N[q]), int(st.A[q]))
            if p.near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                # inverted mapping: e >= 0 -> 2e+1 (odd), e < 0 -> -2(e+1)
                merr = (
                    2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
                )
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _encode_lg(bw, merr, k, p.limit, p.qbpp)
            _update_regular(st, p, q, errval)
            x += 1
        c0 = int(prev[0])
        prev, cur = cur, prev
    return bw.close()


def _encode_run(src, cur, prev, x, a, p: _Params, st: _State,
                bw: _LsBitWriter) -> int:
    """Run mode from position x with RUNval = a. Returns the next x."""
    cols = src.size
    runval = a
    runcnt = 0
    while x < cols and abs(int(src[x]) - runval) <= p.near:
        runcnt += 1
        cur[x] = runval
        x += 1
    hit_eol = x == cols
    while runcnt >= (1 << _J[st.run_index]):
        bw.bits(1, 1)
        runcnt -= 1 << _J[st.run_index]
        if st.run_index < 31:
            st.run_index += 1
    if hit_eol:
        if runcnt > 0:
            bw.bits(1, 1)
        return x
    bw.bits(0, 1)
    bw.bits(runcnt, _J[st.run_index])
    # run interruption sample (T.87 A.7.2); RUNindex decremented AFTER
    b = int(prev[x])
    ix = int(src[x])
    _code_run_interruption(
        bw, None, runval, b, p, st, ix=ix, out=cur, x=x
    )
    if st.run_index > 0:
        st.run_index -= 1
    return x + 1


def _code_run_interruption(
    bw, br, ra: int, rb: int, p: _Params, st: _State,
    ix: int | None = None, out=None, x: int = 0,
) -> int:
    """Encode (bw set) or decode (br set) the run-interruption sample.

    Shared so the two directions cannot drift. Returns the
    reconstructed sample value."""
    t = 2 * p.near + 1
    ritype = 1 if abs(ra - rb) <= p.near else 0
    if ritype:
        px = ra
        sign = 1
    else:
        px = rb
        sign = -1 if rb < ra else 1
    q = 365 + ritype
    temp = int(st.A[q]) + ((int(st.N[q]) >> 1) if ritype else 0)
    k = _golomb_k(int(st.N[q]), temp)
    glimit = p.limit - _J[st.run_index] - 1

    if bw is not None:
        errval = (ix - px) * sign
        if p.near:
            if errval > 0:
                errval = (p.near + errval) // t
            else:
                errval = -((p.near - errval) // t)
            rx = px + sign * errval * t
            rx = 0 if rx < 0 else (p.maxval if rx > p.maxval else rx)
        else:
            rx = ix
        errval = _modulo_range(errval, p)
        if errval == 0:
            mapv = 0
        elif k == 0 and errval > 0 and 2 * st.Nn[q - 365] < st.N[q]:
            mapv = 1
        elif errval < 0 and 2 * st.Nn[q - 365] >= st.N[q]:
            mapv = 1
        elif errval < 0 and k != 0:
            mapv = 1
        else:
            mapv = 0
        emerr = 2 * abs(errval) - ritype - mapv
        _encode_lg(bw, emerr, k, glimit, p.qbpp)
        out[x] = rx
    else:
        emerr = _decode_lg(br, k, glimit, p.qbpp)
        # invert the error mapping: T.87 F-series decode
        tmp = emerr + ritype
        if tmp == 0:
            errval = 0
            mapv = 0
        else:
            # candidate magnitudes: tmp even -> |e| = tmp/2 with map 0,
            # tmp odd -> |e| = (tmp+1)/2 with map 1
            if tmp & 1:
                mag = (tmp + 1) // 2
                mapv = 1
            else:
                mag = tmp // 2
                mapv = 0
            # decide the sign from the map definition
            if mapv:
                # map == 1: either (k==0, e>0, 2Nn<N) or (e<0, 2Nn>=N)
                # or (e<0, k!=0)
                if k == 0 and 2 * st.Nn[q - 365] < st.N[q]:
                    errval = mag
                else:
                    errval = -mag
            else:
                # map == 0: e == 0 handled; else e>0 in the non-special
                # branch or e<0 impossible... e > 0 unless the special
                # k==0 branch claimed it
                if k == 0 and 2 * st.Nn[q - 365] < st.N[q]:
                    errval = -mag
                else:
                    errval = mag
        rx = px + sign * errval * t
        if rx < -p.near:
            rx += p.range_ * t
        elif rx > p.maxval + p.near:
            rx -= p.range_ * t
        rx = 0 if rx < 0 else (p.maxval if rx > p.maxval else rx)
        out[x] = rx

    if errval < 0:
        st.Nn[q - 365] += 1
    st.A[q] += (emerr + 1 - ritype) >> 1
    if st.N[q] == p.reset:
        st.A[q] >>= 1
        st.N[q] >>= 1
        st.Nn[q - 365] >>= 1
    st.N[q] += 1
    return int(out[x])


def _decode_scan(
    data: bytes, start: int, rows: int, cols: int, p: _Params
) -> np.ndarray:
    st = _State(p)
    br = _LsBitReader(data, start)
    out = np.empty((rows, cols), np.int64)
    prev = np.zeros(cols, np.int64)
    cur = np.zeros(cols, np.int64)
    c0 = 0
    t = 2 * p.near + 1
    for y in range(rows):
        x = 0
        while x < cols:
            b = int(prev[x])
            c = int(prev[x - 1]) if x > 0 else c0
            d = int(prev[x + 1]) if x + 1 < cols else int(prev[cols - 1])
            a = int(cur[x - 1]) if x > 0 else int(prev[0])
            q1 = _quantize_gradient(d - b, p)
            q2 = _quantize_gradient(b - c, p)
            q3 = _quantize_gradient(c - a, p)
            q = 81 * q1 + 9 * q2 + q3
            if q == 0:
                # run mode
                runval = a
                while True:
                    if br.bit() == 1:
                        n = min(1 << _J[st.run_index], cols - x)
                        cur[x : x + n] = runval
                        x += n
                        if n == (1 << _J[st.run_index]) and (
                            st.run_index < 31
                        ):
                            st.run_index += 1
                        if x == cols:
                            break
                    else:
                        nbits = _J[st.run_index]
                        n = br.bits(nbits) if nbits else 0
                        if n > cols - x:
                            raise ValueError(
                                "corrupt JPEG-LS stream (run past EOL)"
                            )
                        cur[x : x + n] = runval
                        x += n
                        rb = int(prev[x])
                        _code_run_interruption(
                            None, br, runval, rb, p, st, out=cur, x=x
                        )
                        if st.run_index > 0:
                            st.run_index -= 1
                        x += 1
                        break
                continue
            if q < 0:
                sign = -1
                q = -q
            else:
                sign = 1
            px = _med(a, b, c) + sign * int(st.C[q])
            px = 0 if px < 0 else (p.maxval if px > p.maxval else px)
            k = _golomb_k(int(st.N[q]), int(st.A[q]))
            merr = _decode_lg(br, k, p.limit, p.qbpp)
            if p.near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                # inverse of: e >= 0 -> 2e+1 (odd), e < 0 -> -2(e+1) (even)
                errval = (merr - 1) // 2 if merr & 1 else -(merr // 2) - 1
            else:
                errval = (merr + 1) // 2 if merr & 1 else merr // 2
                if merr & 1:
                    errval = -errval
            # undo modulo-RANGE reduction
            rx = px + sign * errval * t
            if rx < -p.near:
                rx += p.range_ * t
            elif rx > p.maxval + p.near:
                rx -= p.range_ * t
            rx = 0 if rx < 0 else (p.maxval if rx > p.maxval else rx)
            cur[x] = rx
            _update_regular(st, p, q, errval)
            x += 1
        out[y] = cur
        c0 = int(prev[0])
        prev, cur = cur, prev
    return out


# ---------------------------------------------------------------------------
# Marker-level encode / decode
# ---------------------------------------------------------------------------


def encode_jpegls(
    frame: np.ndarray, near: int = 0, precision: int | None = None
) -> bytes:
    """[H, W] uint8/uint16/int16 -> a JPEG-LS (SOF55) codestream.

    ``near=0`` is lossless (DICOM .4.80); ``near>0`` bounds every
    sample's reconstruction error by ``near`` (.4.81). int16 encodes
    bit-preservingly as its uint16 twin (the jpegll convention)."""
    frame = np.asarray(frame)
    if frame.ndim != 2:
        raise ValueError(f"frame must be [H, W], got {frame.shape}")
    if frame.dtype == np.int16:
        frame = frame.view(np.uint16)
    if frame.dtype == np.uint8:
        precision = precision or 8
    elif frame.dtype == np.uint16:
        precision = precision or 16
    else:
        raise TypeError(f"unsupported dtype {frame.dtype}")
    if not (2 <= precision <= 16):
        raise ValueError(f"precision {precision}")
    if near < 0:
        raise ValueError(f"near must be >= 0, got {near}")
    maxval = (1 << precision) - 1
    if int(frame.max(initial=0)) > maxval:
        raise ValueError(
            f"samples exceed {precision}-bit range (max {frame.max()})"
        )
    t1, t2, t3 = _default_thresholds(maxval, near)
    p = _Params(maxval, near, t1, t2, t3, _RESET_DEFAULT)
    rows, cols = frame.shape
    scan = _encode_scan(frame, p)

    out = bytearray()
    out += bytes([0xFF, _SOI])
    sof = struct.pack(">BHHB", precision, rows, cols, 1)
    sof += bytes([1, 0x11, 0])  # component 1, H=V=1, Tq=0
    out += bytes([0xFF, _SOF55]) + struct.pack(">H", len(sof) + 2) + sof
    sos = bytes([1, 1, 0x00, near, 0, 0x00])  # Ns, Cs, Tm, NEAR, ILV, Al
    out += bytes([0xFF, _SOS]) + struct.pack(">H", len(sos) + 2) + sos
    out += scan
    out += bytes([0xFF, _EOI])
    return bytes(out)


def decode_jpegls(blob: bytes, ctx: str = "jpegls") -> np.ndarray:
    """One JPEG-LS (SOF55) codestream -> [rows, cols] uint8/uint16."""
    if len(blob) < 4 or blob[0] != 0xFF or blob[1] != _SOI:
        raise ValueError(f"{ctx}: not a JPEG-LS codestream (missing SOI)")
    try:
        return _decode_markers(blob, ctx)
    except (IndexError, struct.error) as e:
        raise ValueError(f"{ctx}: truncated JPEG-LS codestream") from e


def _decode_markers(blob: bytes, ctx: str) -> np.ndarray:
    pos = 2
    precision = rows = cols = None
    maxval = t1 = t2 = t3 = None
    reset = _RESET_DEFAULT
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF:
            raise ValueError(f"{ctx}: expected marker at byte {pos}")
        m = blob[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        pos += 2
        if m == _EOI:
            raise ValueError(f"{ctx}: EOI before any scan data")
        (seglen,) = struct.unpack_from(">H", blob, pos)
        seg = blob[pos + 2 : pos + seglen]
        if m in _SOF_FAMILY and m != _SOF55:
            raise ValueError(
                f"{ctx}: SOF{m - 0xC0} is not JPEG-LS (needs SOF55) — "
                "use the sequential-DCT or lossless codec"
            )
        if m == _SOF55:
            precision, rows, cols, ncomp = struct.unpack_from(
                ">BHHB", seg, 0
            )
            if ncomp != 1:
                raise NotImplementedError(
                    f"{ctx}: {ncomp}-component JPEG-LS scan; the "
                    "grayscale pixel model supports 1"
                )
            if not (2 <= precision <= 16):
                raise ValueError(f"{ctx}: precision {precision}")
        elif m == _LSE:
            if seg[0] == 1:
                maxval, t1, t2, t3, reset = struct.unpack_from(
                    ">HHHHH", seg, 1
                )
            else:
                raise NotImplementedError(
                    f"{ctx}: LSE ID={seg[0]} (mapping tables / extended "
                    "dimensions are not used by DICOM encoders)"
                )
        elif m == _DRI:
            (ri,) = struct.unpack_from(">H", seg, 0)
            if ri:
                raise NotImplementedError(
                    f"{ctx}: restart markers (DRI={ri}) — re-encode "
                    "without restarts"
                )
        elif m == _SOS:
            if precision is None:
                raise ValueError(f"{ctx}: SOS before SOF55")
            ns = seg[0]
            if ns != 1:
                raise NotImplementedError(
                    f"{ctx}: interleaved {ns}-component scan"
                )
            near = seg[1 + 2 * ns]
            ilv = seg[2 + 2 * ns]
            al = seg[3 + 2 * ns] & 0x0F
            if ilv != 0:
                raise NotImplementedError(f"{ctx}: ILV={ilv}")
            if al != 0:
                raise NotImplementedError(f"{ctx}: point transform {al}")
            mv = maxval if maxval else (1 << precision) - 1
            if t1 is None or (t1 == 0 and t2 == 0 and t3 == 0):
                th1, th2, th3 = _default_thresholds(mv, near)
            else:
                th1, th2, th3 = t1, t2, t3
            p = _Params(mv, near, th1, th2, th3, reset or _RESET_DEFAULT)
            out = _decode_scan(blob, pos + seglen, rows, cols, p)
            if precision <= 8 and mv <= 255:
                return out.astype(np.uint8)
            return out.astype(np.uint16)
        pos += seglen
    raise ValueError(f"{ctx}: no SOS marker — truncated codestream")
