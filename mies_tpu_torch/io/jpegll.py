"""JPEG Lossless (ITU-T T.81 process 14, SOF3) codec — decode AND encode.

Clinical archives encode predominantly compressed transfer syntaxes;
after RLE Lossless, the most common lossless pair is

  * 1.2.840.10008.1.2.4.70 — JPEG Lossless, Non-Hierarchical, First-Order
    Prediction (process 14, selection value 1) — the DICOM default
    lossless syntax, and
  * 1.2.840.10008.1.2.4.57 — JPEG Lossless, Non-Hierarchical (process
    14), any predictor 1-7.

Both are the same bitstream format: a baseline-JPEG marker structure
whose frame is SOF3 and whose entropy-coded scan is Huffman-coded
first-difference categories (T.81 Annex H). No DCT, no quantization —
exactly reversible, which is why PACS use it for primary archives.
This module implements that format from the spec with zero new
dependencies (the RLE precedent; DICOM is the SURVEY §2b D9
north-star addition).

Scope (the framework's grayscale pixel model):
  * single-component scans, 2 <= precision <= 16, point transform 0;
  * predictors 1-7 (decode), restart intervals, byte stuffing, DNL;
  * encode: predictor selectable (default 1 == SV1), per-image optimal
    canonical Huffman table, restart-free single scan.

Decode strategy: the Huffman scan is inherently bit-serial, so the
symbol loop runs host-side over a little bit-buffer (the C twin in
native/dicomfast.cpp covers the hot series-streaming path); the
RECONSTRUCTION pass is numpy-vectorized for the linear predictors
(1, 2, 4 are prefix sums; 3 is pure indexing) and falls back to the
literal per-sample recurrence for the shift predictors (5, 6, 7 —
rare in the wild; encoders overwhelmingly emit SV1).

Round-trip and knife-edge tests: tests/test_io.py (16-bit SSSS=16
diffs, 0xFF stuffing, restart markers, every predictor, first-row /
first-column prediction, truncation errors).
"""

from __future__ import annotations

import struct

import numpy as np

# markers
_SOI = 0xD8
_EOI = 0xD9
_SOS = 0xDA
_DHT = 0xC4
_DRI = 0xDD
_DNL = 0xDC
_SOF3 = 0xC3
_SOF_FAMILY = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}  # SOFn markers
_RST0 = 0xD0  # .. 0xD7


class _BitReader:
    """MSB-first bit reader over entropy-coded data with JPEG byte
    stuffing (0xFF 0x00 -> literal 0xFF) and marker detection."""

    __slots__ = ("data", "pos", "acc", "nbits", "marker")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker = None  # marker byte encountered mid-scan

    def _fill(self) -> None:
        d = self.data
        while self.nbits <= 24:
            if self.pos >= len(d):
                # T.81 F.2.2.5: pad with 1s past the end (truncation is
                # caught by the sample count check)
                self.acc = (self.acc << 8) | 0xFF
                self.nbits += 8
                continue
            b = d[self.pos]
            if b == 0xFF:
                nxt = d[self.pos + 1] if self.pos + 1 < len(d) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7 or nxt in (0xD9, 0xDC):
                    # restart / EOI / DNL: stop feeding, record it
                    self.marker = nxt
                    self.acc = (self.acc << 8) | 0xFF
                    self.nbits += 8
                    continue
                else:
                    raise ValueError(
                        f"unexpected marker 0xFF{nxt:02X} inside "
                        "entropy-coded data"
                    )
            else:
                self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def align_restart(self) -> int:
        """Discard pad bits, consume the next restart marker (scanning
        forward — the pad may not have pulled it into the buffer yet),
        resync, and return its index 0-7."""
        self.acc = 0
        self.nbits = 0
        d = self.data
        p = self.pos
        while p + 1 < len(d) and not (
            d[p] == 0xFF and 0xD0 <= d[p + 1] <= 0xD7
        ):
            p += 1
        if p + 1 >= len(d):
            raise ValueError("expected restart marker, hit end of scan")
        self.pos = p + 2
        self.marker = None
        return d[p + 1] - 0xD0


def _build_decode_table(counts: list[int], symbols: list[int]):
    """Canonical Huffman (T.81 C.2) -> dict code->(symbol) keyed by
    (length, code). Returned as (maxcode, valptr, mincode, symbols) for
    the spec's DECODE procedure."""
    code = 0
    k = 0
    mincode = [0] * 17
    maxcode = [-1] * 17
    valptr = [0] * 17
    for ln in range(1, 17):
        n = counts[ln - 1]
        valptr[ln] = k
        mincode[ln] = code
        code += n
        k += n
        maxcode[ln] = code - 1 if n else -1
        code <<= 1
    return mincode, maxcode, valptr, list(symbols)


def _decode_symbol(br: _BitReader, tbl) -> int:
    mincode, maxcode, valptr, symbols = tbl
    code = br.bits(1)
    ln = 1
    while code > maxcode[ln]:
        if ln >= 16:
            raise ValueError("corrupt Huffman stream (code > 16 bits)")
        code = (code << 1) | br.bits(1)
        ln += 1
    return symbols[valptr[ln] + code - mincode[ln]]


def _extend(v: int, s: int) -> int:
    """T.81 F.2.2.1 EXTEND: map s low bits to the signed difference."""
    if s == 0:
        return 0
    if s == 16:
        return 32768  # lossless special: no extra bits read
    if v < (1 << (s - 1)):
        return v - (1 << s) + 1
    return v


def decode_jpeg_lossless(blob: bytes, ctx: str = "jpeg") -> np.ndarray:
    """One JPEG Lossless (SOF3) codestream -> [rows, cols] uint8/uint16.

    Single grayscale component, predictors 1-7, restart intervals and
    DNL supported; point transform must be 0 (clinical encoders never
    use it for lossless primaries).
    """
    if len(blob) < 4 or blob[0] != 0xFF or blob[1] != _SOI:
        raise ValueError(f"{ctx}: not a JPEG codestream (missing SOI)")
    try:
        return _decode_markers(blob, ctx)
    except (IndexError, struct.error) as e:
        raise ValueError(f"{ctx}: truncated JPEG codestream") from e


def _decode_markers(blob: bytes, ctx: str) -> np.ndarray:
    pos = 2
    tables: dict[int, tuple] = {}
    precision = rows = cols = None
    restart_interval = 0
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF:
            raise ValueError(f"{ctx}: expected marker at byte {pos}")
        m = blob[pos + 1]
        if m == 0xFF:  # fill byte
            pos += 1
            continue
        pos += 2
        if m == _EOI:
            raise ValueError(f"{ctx}: EOI before any scan data")
        (seglen,) = struct.unpack_from(">H", blob, pos)
        seg = blob[pos + 2 : pos + seglen]
        if m in _SOF_FAMILY and m != _SOF3:
            raise ValueError(
                f"{ctx}: SOF{m - 0xC0} is not lossless (process 14 "
                "needs SOF3) — a lossy/progressive JPEG cannot be "
                "decoded by the lossless codec"
            )
        if m == _SOF3:
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp != 1:
                raise NotImplementedError(
                    f"{ctx}: {ncomp}-component lossless scan; the "
                    "grayscale pixel model supports 1"
                )
            if not (2 <= precision <= 16):
                raise ValueError(f"{ctx}: precision {precision}")
        elif m == _DHT:
            o = 0
            while o < len(seg):
                tc_th = seg[o]
                counts = list(seg[o + 1 : o + 17])
                nsym = sum(counts)
                symbols = list(seg[o + 17 : o + 17 + nsym])
                tables[tc_th & 0x0F] = _build_decode_table(counts, symbols)
                o += 17 + nsym
        elif m == _DRI:
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif m == _SOS:
            if precision is None:
                raise ValueError(f"{ctx}: SOS before SOF3")
            ns = seg[0]
            if ns != 1:
                raise NotImplementedError(
                    f"{ctx}: interleaved {ns}-component scan"
                )
            td = seg[2] >> 4
            predictor = seg[1 + 2 * ns]  # Ss
            pt = seg[3 + 2 * ns] & 0x0F  # Al = point transform
            if td not in tables:
                raise ValueError(f"{ctx}: scan uses undefined DC table {td}")
            if not (1 <= predictor <= 7):
                raise ValueError(f"{ctx}: lossless predictor {predictor}")
            if pt != 0:
                raise NotImplementedError(
                    f"{ctx}: point transform Pt={pt} (lossless archives "
                    "use 0)"
                )
            if rows == 0:
                raise NotImplementedError(
                    f"{ctx}: DNL-terminated scan (SOF3 Y=0) — re-encode "
                    "with the frame height in SOF3"
                )
            if restart_interval and restart_interval % cols != 0:
                raise NotImplementedError(
                    f"{ctx}: restart interval {restart_interval} is not "
                    f"a whole number of rows ({cols} samples) — mid-row "
                    "restart prediction resets are unsupported"
                )
            diffs = _decode_scan(
                blob, pos + seglen, tables[td], rows, cols,
                restart_interval, ctx,
            )
            rpr = restart_interval // cols if restart_interval else rows
            return _reconstruct(
                diffs, rows, cols, predictor, precision, rpr,
            )
        pos += seglen
    raise ValueError(f"{ctx}: no SOS marker — truncated codestream")


def _decode_scan(blob, start, tbl, rows, cols, ri, ctx) -> np.ndarray:
    """Entropy-coded scan -> int32 diff array [rows*cols]."""
    br = _BitReader(blob, start)
    n = rows * cols
    diffs = np.empty(n, np.int32)
    i = 0
    next_rst = 0
    while i < n:
        stop = min(n, i + ri) if ri else n
        while i < stop:
            s = _decode_symbol(br, tbl)
            if s == 16:
                diffs[i] = 32768
            else:
                diffs[i] = _extend(br.bits(s), s)
            i += 1
        if ri and i < n:
            got = br.align_restart()
            if got != next_rst:
                raise ValueError(
                    f"{ctx}: restart marker out of order "
                    f"(RST{got}, expected RST{next_rst})"
                )
            next_rst = (next_rst + 1) % 8
    return diffs


def _reconstruct(
    diffs: np.ndarray, rows: int, cols: int, predictor: int,
    precision: int, rows_per_restart: int,
) -> np.ndarray:
    """Inverse DPCM (T.81 H.1.2): samples = predictor + diff, mod 2^16.

    Boundary rules: sample (0,0) predicts 2^(P-1); the rest of row 0
    uses Ra; the first sample of every other row uses Rb; interior
    samples use the scan's predictor. A restart interval resets the
    prediction completely (its first row behaves like a scan's first
    row), so each row-aligned restart segment reconstructs
    independently. Predictors 1/2/4 vectorize as prefix sums (uint16
    wrap == mod-65536 arithmetic); 5/6/7 keep the literal recurrence.
    """
    full = diffs.reshape(rows, cols)
    if rows_per_restart < rows:
        return np.concatenate(
            [
                _reconstruct(
                    full[y0 : y0 + rows_per_restart].ravel(),
                    min(rows_per_restart, rows - y0), cols, predictor,
                    precision, rows,
                )
                for y0 in range(0, rows, rows_per_restart)
            ],
            axis=0,
        )
    d = full.astype(np.uint16)  # mod-2^16 ring
    out = np.empty((rows, cols), np.uint16)
    half = np.uint16(1 << (precision - 1))
    # uint16 wrap-around IS the spec's mod-65536 arithmetic — numpy's
    # overflow warning is the intended behavior inside this block
    with np.errstate(over="ignore"):
        # row 0 is Ra-predicted for EVERY predictor: a plain cumsum
        out[0] = np.cumsum(d[0], dtype=np.uint16) + half
        if predictor == 1:
            body = np.cumsum(d[1:], axis=1, dtype=np.uint16)
            # first column chains Rb down the rows
            col0 = np.cumsum(d[1:, 0], dtype=np.uint16) + out[0, 0]
            out[1:] = body + (col0 - d[1:, 0])[:, None]
        elif predictor == 2:
            out[1:] = np.cumsum(d[1:], axis=0, dtype=np.uint16) + out[0][None]
            # (first sample of each row is Rb-predicted anyway — same rule)
        elif predictor == 3:
            for y in range(1, rows):
                out[y, 0] = out[y - 1, 0] + d[y, 0]  # Rb for the first col
                out[y, 1:] = out[y - 1, :-1] + d[y, 1:]
        elif predictor == 4:
            # s[x] = s[x-1] + (Rb[x] - Rb[x-1]) + d[x]  ->  prefix sum
            # (s[x] - Rb[x] telescopes to the plain cumsum of d)
            for y in range(1, rows):
                prev = out[y - 1]
                t = d[y].copy()
                t[0] += prev[0]  # Rb rule for the first column
                t[1:] += prev[1:] - prev[:-1]
                out[y] = np.cumsum(t, dtype=np.uint16)
        else:  # 5, 6, 7: the >>1 makes the recurrence non-linear
            for y in range(1, rows):
                prev = out[y - 1]
                row = out[y]
                row[0] = (int(prev[0]) + int(d[y, 0])) & 0xFFFF
                dy = d[y]
                if predictor == 5:
                    for x in range(1, cols):
                        rb, rc = int(prev[x]), int(prev[x - 1])
                        row[x] = (int(row[x - 1]) + ((rb - rc) >> 1)
                                  + int(dy[x])) & 0xFFFF
                elif predictor == 6:
                    for x in range(1, cols):
                        ra, rc = int(row[x - 1]), int(prev[x - 1])
                        row[x] = (int(prev[x]) + ((ra - rc) >> 1)
                                  + int(dy[x])) & 0xFFFF
                else:  # 7
                    for x in range(1, cols):
                        row[x] = (((int(row[x - 1]) + int(prev[x])) >> 1)
                                  + int(dy[x])) & 0xFFFF
    if precision <= 8:
        return (out & 0xFF).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _predict(px: np.ndarray, predictor: int, precision: int) -> np.ndarray:
    """Forward DPCM: diffs = sample - prediction (mod 2^16), int32 in
    [-32768, 32767] with +32768 folded to the SSSS=16 special."""
    p = px.astype(np.int32)
    rows, cols = p.shape
    pred = np.empty_like(p)
    pred[0, 0] = 1 << (precision - 1)
    pred[0, 1:] = p[0, :-1]  # row 0: Ra
    pred[1:, 0] = p[:-1, 0]  # col 0: Rb
    ra = p[1:, :-1]
    rb = p[:-1, 1:]
    rc = p[:-1, :-1]
    if predictor == 1:
        pred[1:, 1:] = ra
    elif predictor == 2:
        pred[1:, 1:] = rb
    elif predictor == 3:
        pred[1:, 1:] = rc
    elif predictor == 4:
        pred[1:, 1:] = ra + rb - rc
    elif predictor == 5:
        pred[1:, 1:] = ra + ((rb - rc) >> 1)
    elif predictor == 6:
        pred[1:, 1:] = rb + ((ra - rc) >> 1)
    elif predictor == 7:
        pred[1:, 1:] = (ra + rb) >> 1
    else:
        raise ValueError(f"predictor must be 1-7, got {predictor}")
    d = (p - pred) & 0xFFFF
    d = np.where(d >= 32768, d - 65536, d)  # [-32768, 32767]
    return d


def _category(v: np.ndarray) -> np.ndarray:
    """SSSS category: bit length of |diff|; -32768 folds to the SSSS=16
    no-extra-bits code (T.81 lossless table H.2)."""
    a = np.abs(v.astype(np.int64))
    a = np.where(v == -32768, 32768, a)
    cat = np.zeros(v.shape, np.int32)
    nz = a > 0
    cat[nz] = np.floor(np.log2(a[nz])).astype(np.int32) + 1
    return cat


def _build_encode_table(freq: np.ndarray):
    """Length-limited canonical Huffman over the SSSS alphabet (0..16).
    17 symbols cap the depth at 16 naturally; a sentinel count keeps
    the all-ones 16-bit code unassigned (T.81 C.2's reserved pattern).
    Returns (counts[16], symbols, code/length lookup arrays)."""
    import heapq

    syms = [i for i in range(17) if freq[i] > 0]
    if not syms:
        syms = [0]
    if len(syms) == 1:
        lengths = {syms[0]: 1}
    else:
        heap = [(int(freq[s]), s, (s,)) for s in syms]
        heapq.heapify(heap)
        depth: dict[int, int] = {s: 0 for s in syms}
        while len(heap) > 1:
            fa, _, ga = heapq.heappop(heap)
            fb, tb, gb = heapq.heappop(heap)
            for s in ga + gb:
                depth[s] += 1
            heapq.heappush(heap, (fa + fb, tb, ga + gb))
        lengths = depth
    counts = [0] * 16
    for s, ln in lengths.items():
        counts[ln - 1] += 1
    # canonical assignment in (length, symbol) order
    ordered = sorted(lengths, key=lambda s: (lengths[s], s))
    code = 0
    prev_len = lengths[ordered[0]]
    codes = {}
    for s in ordered:
        code <<= lengths[s] - prev_len
        prev_len = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    return counts, ordered, codes


class _BitWriter:
    __slots__ = ("out", "acc", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, v: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
        self.acc &= (1 << self.nbits) - 1

    def pad(self) -> None:
        """Pad to a byte boundary with 1-bits (T.81 F.1.2.3)."""
        if self.nbits:
            n = 8 - self.nbits
            self.bits((1 << n) - 1, n)

    def marker(self, m: int) -> None:
        """Emit a raw marker (NOT byte-stuffed) at a byte boundary."""
        self.pad()
        self.out += bytes([0xFF, m])

    def close(self) -> bytes:
        self.pad()
        return bytes(self.out)


def encode_jpeg_lossless(
    frame: np.ndarray,
    predictor: int = 1,
    precision: int | None = None,
    restart_rows: int | None = None,
) -> bytes:
    """[H, W] uint8/uint16/int16 -> a JPEG Lossless (SOF3) codestream.

    int16 is encoded bit-preservingly as its uint16 twin (the DICOM
    convention: PixelRepresentation carries signedness, the codestream
    is unsigned). ``predictor=1`` emits the SV1 (.4.70) bitstream.
    ``restart_rows`` emits a DRI of that many rows with RSTn markers
    between segments (each segment's prediction restarts, T.81 H.1.1).
    """
    frame = np.asarray(frame)
    if frame.ndim != 2:
        raise ValueError(f"frame must be [H, W], got {frame.shape}")
    if frame.dtype == np.int16:
        frame = frame.view(np.uint16)
    if frame.dtype == np.uint8:
        px = frame.astype(np.uint16)
        precision = precision or 8
    elif frame.dtype == np.uint16:
        px = frame
        precision = precision or 16
    else:
        raise TypeError(f"unsupported dtype {frame.dtype}")
    if not (2 <= precision <= 16):
        raise ValueError(f"precision {precision}")
    rows, cols = px.shape
    rr = restart_rows if restart_rows else rows
    if rr < 1:
        raise ValueError(f"restart_rows must be >= 1, got {restart_rows}")
    segs = [px[y0 : y0 + rr] for y0 in range(0, rows, rr)]
    seg_d = [_predict(s, predictor, precision) for s in segs]
    seg_c = [_category(d) for d in seg_d]
    freq = np.zeros(17, np.int64)
    for c in seg_c:
        freq += np.bincount(c.ravel(), minlength=17)
    counts, symbols, codes = _build_encode_table(freq)

    bw = _BitWriter()
    for gi, (d, cats) in enumerate(zip(seg_d, seg_c)):
        flat_d = d.ravel()
        flat_c = cats.ravel()
        for i in range(flat_d.size):
            s = int(flat_c[i])
            c, ln = codes[s]
            bw.bits(c, ln)
            if s == 0 or s == 16:
                continue
            v = int(flat_d[i])
            if v < 0:
                v += (1 << s) - 1
            bw.bits(v, s)
        if gi < len(segs) - 1:
            bw.marker(_RST0 + gi % 8)
    scan = bw.close()

    dht_body = bytes([0x00]) + bytes(counts) + bytes(symbols)
    out = bytearray()
    out += b"\xff" + bytes([_SOI])
    out += b"\xff" + bytes([_SOF3])
    sof = struct.pack(">BHHB", precision, rows, cols, 1)
    sof += bytes([1, 0x11, 0])  # component 1, H=V=1, Tq=0
    out += struct.pack(">H", len(sof) + 2) + sof
    out += b"\xff" + bytes([_DHT])
    out += struct.pack(">H", len(dht_body) + 2) + dht_body
    if restart_rows:
        out += b"\xff" + bytes([_DRI])
        out += struct.pack(">HH", 4, rr * cols)
    out += b"\xff" + bytes([_SOS])
    sos = bytes([1, 1, 0x00, predictor, 0, 0x00])  # Ns, Cs, TdTa, Ss, Se, AhAl
    out += struct.pack(">H", len(sos) + 2) + sos
    out += scan
    out += b"\xff" + bytes([_EOI])
    return bytes(out)
