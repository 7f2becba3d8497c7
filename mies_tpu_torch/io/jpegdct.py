"""JPEG sequential DCT codec (ITU-T T.81 processes 1/2/4) — decode AND
encode, for the DICOM lossy transfer syntaxes

  * 1.2.840.10008.1.2.4.50 — JPEG Baseline (process 1): 8-bit Huffman
    sequential DCT, SOF0 — the dominant ultrasound/endoscopy archive
    syntax, and
  * 1.2.840.10008.1.2.4.51 — JPEG Extended (processes 2 & 4): 8/12-bit
    Huffman sequential DCT, SOF0/SOF1 — legacy CT/MR lossy archives.

Same bitstream family as io/jpegll.py (markers, byte stuffing, canonical
Huffman, EXTEND) but the scan codes quantized 8x8 DCT blocks instead of
DPCM differences. The entropy layer is bit-serial host-side like the
lossless codec; the numeric layer (FDCT / IDCT / quantization) runs as
ONE batched float64 einsum over all blocks — numpy-vectorized, no
per-block Python.

Scope:
  * single-component scans, precision 8 or 12, non-interleaved;
  * 3-component INTERLEAVED YCbCr scans (the color
    ultrasound/endoscopy archive form): MCU-ordered decode
    at 4:4:4 / 4:2:2 / 4:2:0 sampling, libjpeg 'fancy' (triangle)
    chroma upsampling and fixed-point YCbCr->RGB reproduced exactly
    (jdsample.c / jdcolor.c arithmetic), 'RGB'-component-id frames
    pass through untransformed; output is [H, W, 3] uint8, within
    +/-3 of Pillow/libjpeg (our exact float IDCT vs its islow);
  * restart intervals; 8- and 16-bit (Pq=1) quantization tables;
  * decode: any DC/AC table ids, APPn/COM skipped, multi-segment DHT;
  * encode (grayscale): per-image optimal length-limited Huffman
    (libjpeg's reserved-symbol trick keeps the all-ones code
    unassigned and the depth <= 16), quality 1-100 via the libjpeg
    scaling curve over the T.81 Annex K.1 luminance table (scaled
    x2^(P-8) for 12-bit).

This codec is LOSSY by construction (quantized DCT); the DICOM writer
requires an explicit opt-in and the reader surfaces the syntax UID so
callers know round-trips are not bit-exact.

DICOM ingest is the SURVEY section 2b D9 north-star; real clinical
archives mix .4.50 series into CT/US studies.
Cross-checked against Pillow's libjpeg decode in tests/test_io.py
(TestJpegDct) — both decoders agree within the T.81 conformance-style
+/-1 reconstruction tolerance on 8-bit streams, ours additionally
covers 12-bit which libjpeg-8 cannot decode.
"""

from __future__ import annotations

import struct

import numpy as np

from mies_tpu_torch.io.jpegll import (
    _BitReader,
    _BitWriter,
    _build_decode_table,
    _decode_symbol,
    _extend,
)

_SOI = 0xD8
_EOI = 0xD9
_SOS = 0xDA
_DHT = 0xC4
_DQT = 0xDB
_DRI = 0xDD
_SOF0 = 0xC0
_SOF1 = 0xC1
_SOF_FAMILY = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_SOF_NAMES = {
    0xC2: "SOF2 (progressive)",
    0xC3: "SOF3 (lossless — use io/jpegll.py)",
    0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13",
    0xCE: "SOF14",
    0xCF: "SOF15",
}

# T.81 Figure A.6 zigzag: _ZIGZAG[k] = raster index of zigzag position k
_ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# T.81 Annex K.1 luminance quantization table (raster order)
_K1_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.float64)


def _dct_matrix() -> np.ndarray:
    """C[u, x] = c(u)/2 * cos((2x+1) u pi / 16) — the orthonormal 8-pt
    DCT-II basis; FDCT of block b is C @ b @ C.T, IDCT is C.T @ X @ C."""
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) / 2.0
    c[0] /= np.sqrt(2.0)
    return c


_DCT_C = _dct_matrix()


def _blocks_from_image(px: np.ndarray, precision: int) -> tuple:
    """Level-shifted edge-replicated 8x8 blocks [N, 8, 8] float64 plus
    the padded grid shape (by, bx)."""
    rows, cols = px.shape
    by = -(-rows // 8)
    bx = -(-cols // 8)
    pad = np.pad(
        px.astype(np.float64) - (1 << (precision - 1)),
        ((0, by * 8 - rows), (0, bx * 8 - cols)),
        mode="edge",
    )
    blocks = pad.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    return blocks, by, bx


def _image_from_blocks(
    blocks: np.ndarray, by: int, bx: int, rows: int, cols: int,
    precision: int,
) -> np.ndarray:
    """IDCT'd blocks -> clipped integer image (inverse of
    _blocks_from_image incl. the level shift)."""
    img = (
        blocks.reshape(by, bx, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(by * 8, bx * 8)[:rows, :cols]
    )
    img = np.round(img) + (1 << (precision - 1))
    img = np.clip(img, 0, (1 << precision) - 1)
    return img.astype(np.uint8 if precision <= 8 else np.uint16)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def decode_jpeg_dct(blob: bytes, ctx: str = "jpeg") -> np.ndarray:
    """One sequential-DCT JPEG codestream -> [rows, cols] uint8/uint16.

    SOF0 (baseline, 8-bit) and SOF1 (extended sequential, 8/12-bit),
    single grayscale component, restart intervals, 8/16-bit DQT entries.
    """
    if len(blob) < 4 or blob[0] != 0xFF or blob[1] != _SOI:
        raise ValueError(f"{ctx}: not a JPEG codestream (missing SOI)")
    try:
        return _decode_markers(blob, ctx)
    except (IndexError, struct.error) as e:
        raise ValueError(f"{ctx}: truncated JPEG codestream") from e


def _decode_markers(blob: bytes, ctx: str) -> np.ndarray:
    pos = 2
    dc_tables: dict[int, tuple] = {}
    ac_tables: dict[int, tuple] = {}
    raw_tables: dict[tuple, bytes] = {}
    qtables: dict[int, np.ndarray] = {}
    precision = rows = cols = comp_tq = components = None
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
        if m in _SOF_FAMILY and m not in (_SOF0, _SOF1):
            name = _SOF_NAMES.get(m, f"SOF{m - 0xC0}")
            raise ValueError(
                f"{ctx}: {name} is not Huffman sequential DCT — "
                "processes 1/2/4 need SOF0/SOF1"
            )
        if m in (_SOF0, _SOF1):
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp not in (1, 3):
                raise NotImplementedError(
                    f"{ctx}: {ncomp}-component DCT scan — grayscale (1) "
                    "and YCbCr color (3) are supported"
                )
            if m == _SOF0 and precision != 8:
                raise ValueError(
                    f"{ctx}: baseline (SOF0) precision must be 8, "
                    f"got {precision}"
                )
            if precision not in (8, 12):
                raise ValueError(
                    f"{ctx}: sequential DCT precision {precision} "
                    "(T.81 allows 8 or 12)"
                )
            if ncomp == 3 and precision != 8:
                raise NotImplementedError(
                    f"{ctx}: {precision}-bit color DCT scan (YCbCr "
                    "conversion is the 8-bit JFIF contract)"
                )
            components = []
            for c in range(ncomp):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                components.append(
                    {"cid": cid, "h": hv >> 4, "v": hv & 0x0F,
                     "tq": tq})
            comp_tq = components[0]["tq"]
        elif m == _DQT:
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 0x0F
                o += 1
                if pq == 0:
                    q = np.frombuffer(seg[o : o + 64], np.uint8)
                    o += 64
                elif pq == 1:
                    q = np.frombuffer(seg[o : o + 128], ">u2")
                    o += 128
                else:
                    raise ValueError(f"{ctx}: DQT Pq={pq}")
                if q.size != 64:
                    raise ValueError(f"{ctx}: truncated DQT segment")
                zz = np.zeros(64, np.float64)
                zz[_ZIGZAG] = q.astype(np.float64)  # de-zigzag
                qtables[tq] = zz.reshape(8, 8)
        elif m == _DHT:
            o = 0
            while o < len(seg):
                tc, th = seg[o] >> 4, seg[o] & 0x0F
                counts = list(seg[o + 1 : o + 17])
                nsym = sum(counts)
                symbols = list(seg[o + 17 : o + 17 + nsym])
                tbl = _build_decode_table(counts, symbols)
                (dc_tables if tc == 0 else ac_tables)[th] = tbl
                # raw form for the native scan twin: counts + nsym + syms
                raw_tables[(tc, th)] = (
                    bytes(counts) + nsym.to_bytes(2, "little")
                    + bytes(symbols))
                o += 17 + nsym
        elif m == _DRI:
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif m == _SOS:
            if precision is None:
                raise ValueError(f"{ctx}: SOS before SOF")
            ns = seg[0]
            if ns == 3 and len(components) == 3:
                return _decode_color_scan(
                    blob, pos + seglen, seg, components, dc_tables,
                    ac_tables, qtables, rows, cols, restart_interval,
                    ctx, raw_tables,
                )
            if ns != 1 or len(components) != 1:
                raise NotImplementedError(
                    f"{ctx}: {ns}-component scan over "
                    f"{len(components)} frame components — interleaved "
                    "3-scan color and single-component scans are "
                    "supported"
                )
            td, ta = seg[2] >> 4, seg[2] & 0x0F
            ss, se = seg[3], seg[4]
            if (ss, se) != (0, 63):
                raise ValueError(
                    f"{ctx}: spectral selection {ss}..{se} — sequential "
                    "DCT scans code 0..63"
                )
            if td not in dc_tables or ta not in ac_tables:
                raise ValueError(
                    f"{ctx}: scan uses undefined Huffman table "
                    f"(DC {td} / AC {ta})"
                )
            if comp_tq not in qtables:
                raise ValueError(
                    f"{ctx}: frame uses undefined quant table {comp_tq}"
                )
            coeffs = _decode_scan(
                blob, pos + seglen, dc_tables[td], ac_tables[ta],
                rows, cols, restart_interval, ctx,
                raw_tables.get((0, td)), raw_tables.get((1, ta)),
            )
            by = -(-rows // 8)
            bx = -(-cols // 8)
            deq = coeffs * qtables[comp_tq][None]
            blocks = np.einsum(
                "ui,nuv,vj->nij", _DCT_C, deq, _DCT_C, optimize=True
            )
            return _image_from_blocks(blocks, by, bx, rows, cols, precision)
        pos += seglen
    raise ValueError(f"{ctx}: no SOS marker — truncated codestream")


def _native_scan() -> bool:
    """The C++ entropy-scan twin (native/jpegdct_scan.cpp) is the
    default (~0.8-1.5 s -> ms per 512² frame — the .4.50 cine ingest
    path); ``MIES_TPU_JPEG_NATIVE=0`` pins pure Python. Bit-equal
    int32 coefficients — tests compare whole decodes."""
    import os

    if os.environ.get("MIES_TPU_JPEG_NATIVE", "1") == "0":
        return False
    from mies_tpu_torch import native

    return native.available()


def _decode_scan(
    blob, start, dc_tbl, ac_tbl, rows, cols, ri, ctx,
    raw_dc=None, raw_ac=None
) -> np.ndarray:
    """Entropy-coded scan -> float64 coefficient blocks [N, 8, 8] in
    RASTER order (de-zigzagged), NOT yet dequantized."""
    by = -(-rows // 8)
    bx = -(-cols // 8)
    n = by * bx
    if raw_dc is not None and raw_ac is not None and _native_scan():
        from mies_tpu_torch import native

        try:
            (izz,) = native.jpeg_scan_decode(
                blob, start, [[1, 1, bx, by]], raw_dc + raw_ac,
                bx, by, ri)
        except ValueError as e:
            raise ValueError(f"{ctx}: {e}") from e
        out = np.zeros((n, 64), np.float64)
        out[:, _ZIGZAG] = izz
        return out.reshape(n, 8, 8)
    br = _BitReader(blob, start)
    zz = np.zeros((n, 64), np.float64)
    pred = 0
    next_rst = 0
    i = 0
    while i < n:
        stop = min(n, i + ri) if ri else n
        while i < stop:
            s = _decode_symbol(br, dc_tbl)
            if s > 15:
                raise ValueError(f"{ctx}: DC category {s} > 15")
            pred += _extend(br.bits(s), s)
            row = zz[i]
            row[0] = pred
            k = 1
            while k < 64:
                rs = _decode_symbol(br, ac_tbl)
                r, size = rs >> 4, rs & 0x0F
                if size == 0:
                    if rs == 0x00:  # EOB
                        break
                    if rs == 0xF0:  # ZRL
                        k += 16
                        continue
                    raise ValueError(f"{ctx}: AC symbol 0x{rs:02X}")
                k += r
                if k > 63:
                    raise ValueError(f"{ctx}: AC run past block end")
                row[k] = _extend(br.bits(size), size)
                k += 1
            i += 1
        if ri and i < n:
            got = br.align_restart()
            if got != next_rst:
                raise ValueError(
                    f"{ctx}: restart marker out of order "
                    f"(RST{got}, expected RST{next_rst})"
                )
            next_rst = (next_rst + 1) % 8
            pred = 0
    out = np.zeros((n, 64), np.float64)
    out[:, _ZIGZAG] = zz  # de-zigzag all blocks at once
    return out.reshape(n, 8, 8)


def _fancy_up_h(comp: np.ndarray) -> np.ndarray:
    """libjpeg h2 'fancy' (triangle) horizontal upsample, jdsample.c
    arithmetic exactly: even outputs weight the left neighbour with
    +1 rounding, odd outputs the right neighbour with +2."""
    s = comp.astype(np.int32)
    h, w = s.shape
    out = np.empty((h, 2 * w), np.int32)
    left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    out[:, 0::2] = (3 * s + left + 1) >> 2
    out[:, 1::2] = (3 * s + right + 2) >> 2
    out[:, 0] = s[:, 0]
    out[:, -1] = s[:, -1]
    return out


def _fancy_up_v(comp: np.ndarray) -> np.ndarray:
    """libjpeg v2 'fancy' vertical upsample (the vertical half of
    h2v2_fancy_upsample): output row 2k blends input rows k (x3) and
    k-1, row 2k+1 blends k (x3) and k+1 — done FIRST, at full 2-bit
    headroom, so composing with _fancy_up_h reproduces jdsample's
    12-bit two-stage arithmetic when both axes are subsampled."""
    s = comp.astype(np.int32)
    up = np.concatenate([s[:1], s[:-1]], axis=0)
    dn = np.concatenate([s[1:], s[-1:]], axis=0)
    h, w = s.shape
    out = np.empty((2 * h, w), np.int32)
    out[0::2] = 3 * s + up
    out[1::2] = 3 * s + dn
    return out  # UNNORMALIZED (x4): the caller's h-stage divides


def _upsample_chroma(comp: np.ndarray, h: int, v: int, hmax: int,
                     vmax: int, rows: int, cols: int, ctx: str
                     ) -> np.ndarray:
    """Chroma plane -> full [rows, cols], libjpeg fancy upsampling."""
    ry, rx = vmax // v, hmax // h
    if (ry, rx) == (1, 1):
        return comp[:rows, :cols].astype(np.int32)
    if (ry, rx) == (1, 2):
        return _fancy_up_h(comp)[:rows, :cols]
    if (ry, rx) == (2, 2):
        # jdsample h2v2: vertical triangle (x4 intermediate), then
        # horizontal triangle on the 10-bit sums with >> 4 rounding
        m = _fancy_up_v(comp)
        hh, ww = m.shape
        left = np.concatenate([m[:, :1], m[:, :-1]], axis=1)
        right = np.concatenate([m[:, 1:], m[:, -1:]], axis=1)
        out = np.empty((hh, 2 * ww), np.int32)
        out[:, 0::2] = (3 * m + left + 8) >> 4
        out[:, 1::2] = (3 * m + right + 7) >> 4
        out[:, 0] = (4 * m[:, 0] + 8) >> 4
        out[:, -1] = (4 * m[:, -1] + 7) >> 4
        return out[:rows, :cols]
    raise NotImplementedError(
        f"{ctx}: chroma subsampling ratio {ry}x{rx} — 1x1 (4:4:4), "
        "1x2 (4:2:2) and 2x2 (4:2:0) are supported"
    )


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                  ) -> np.ndarray:
    """libjpeg jdcolor.c fixed-point conversion (SCALEBITS=16)."""
    y = y.astype(np.int32)
    cbx = cb.astype(np.int32) - 128
    crx = cr.astype(np.int32) - 128
    half = 1 << 15

    def fix(x):
        return int(x * 65536 + 0.5)

    r = y + ((fix(1.40200) * crx + half) >> 16)
    b = y + ((fix(1.77200) * cbx + half) >> 16)
    g = y + ((-fix(0.34414) * cbx - fix(0.71414) * crx + half) >> 16)
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _decode_color_scan(
    blob, start, sos_seg, components, dc_tables, ac_tables, qtables,
    rows, cols, ri, ctx, raw_tables=None
) -> np.ndarray:
    """Interleaved 3-component sequential-DCT scan -> [rows, cols, 3]
    uint8 RGB.  MCU-ordered entropy decode with per-component
    predictors, then per-component dequant + IDCT, libjpeg fancy
    chroma upsampling and fixed-point YCbCr->RGB (JFIF); frames whose
    component ids spell 'RGB' skip the colour transform."""
    hmax = max(c["h"] for c in components)
    vmax = max(c["v"] for c in components)
    for c in components:
        if c["h"] not in (1, 2, 4) or c["v"] not in (1, 2, 4):
            raise ValueError(f"{ctx}: sampling factors {c['h']}x{c['v']}")
        if c["tq"] not in qtables:
            raise ValueError(
                f"{ctx}: frame uses undefined quant table {c['tq']}")
    # scan-order table selectors, matched to frame components by id
    byid = {c["cid"]: c for c in components}
    scan = []
    scan_ids = []
    for s in range(3):
        cs = sos_seg[1 + 2 * s]
        tdta = sos_seg[2 + 2 * s]
        if cs not in byid:
            raise ValueError(f"{ctx}: scan names unknown component {cs}")
        comp = byid[cs]
        td, ta = tdta >> 4, tdta & 0x0F
        if td not in dc_tables or ta not in ac_tables:
            raise ValueError(
                f"{ctx}: scan uses undefined Huffman table "
                f"(DC {td} / AC {ta})"
            )
        scan.append((comp, dc_tables[td], ac_tables[ta]))
        scan_ids.append((td, ta))
    mcux = -(-cols // (8 * hmax))
    mcuy = -(-rows // (8 * vmax))
    for comp, _d, _a in scan:
        comp["bw"] = mcux * comp["h"]
        comp["bh"] = mcuy * comp["v"]
        comp["zz"] = np.zeros((comp["bh"] * comp["bw"], 64), np.float64)
    if raw_tables is not None and _native_scan() and all(
        (0, td) in raw_tables and (1, ta) in raw_tables
        for td, ta in scan_ids
    ):
        from mies_tpu_torch import native

        geom = [[c["h"], c["v"], c["bw"], c["bh"]]
                for c, _d, _a in scan]
        tables = b"".join(
            raw_tables[(0, td)] + raw_tables[(1, ta)]
            for td, ta in scan_ids)
        try:
            izzs = native.jpeg_scan_decode(
                blob, start, geom, tables, mcux, mcuy, ri)
        except ValueError as e:
            raise ValueError(f"{ctx}: {e}") from e
        for (comp, _d, _a), izz in zip(scan, izzs):
            comp["zz"][:] = izz
        return _color_scan_finish(scan, qtables, rows, cols, hmax,
                                  vmax, ctx)
    br = _BitReader(blob, start)
    preds = {id(comp): 0 for comp, _d, _a in scan}
    next_rst = 0
    n_mcu = mcux * mcuy
    i = 0
    while i < n_mcu:
        stop = min(n_mcu, i + ri) if ri else n_mcu
        while i < stop:
            my, mx = divmod(i, mcux)
            for comp, dc_tbl, ac_tbl in scan:
                for iv in range(comp["v"]):
                    for ih in range(comp["h"]):
                        bi = ((my * comp["v"] + iv) * comp["bw"]
                              + mx * comp["h"] + ih)
                        s = _decode_symbol(br, dc_tbl)
                        if s > 15:
                            raise ValueError(
                                f"{ctx}: DC category {s} > 15")
                        preds[id(comp)] += _extend(br.bits(s), s)
                        row = comp["zz"][bi]
                        row[0] = preds[id(comp)]
                        k = 1
                        while k < 64:
                            rs = _decode_symbol(br, ac_tbl)
                            r, size = rs >> 4, rs & 0x0F
                            if size == 0:
                                if rs == 0x00:
                                    break
                                if rs == 0xF0:
                                    k += 16
                                    continue
                                raise ValueError(
                                    f"{ctx}: AC symbol 0x{rs:02X}")
                            k += r
                            if k > 63:
                                raise ValueError(
                                    f"{ctx}: AC run past block end")
                            row[k] = _extend(br.bits(size), size)
                            k += 1
            i += 1
        if ri and i < n_mcu:
            got = br.align_restart()
            if got != next_rst:
                raise ValueError(
                    f"{ctx}: restart marker out of order "
                    f"(RST{got}, expected RST{next_rst})"
                )
            next_rst = (next_rst + 1) % 8
            for comp, _d, _a in scan:
                preds[id(comp)] = 0
    return _color_scan_finish(scan, qtables, rows, cols, hmax, vmax,
                              ctx)


def _color_scan_finish(scan, qtables, rows, cols, hmax, vmax, ctx
                       ) -> np.ndarray:
    """Numeric tail shared by the Python and native entropy paths:
    per-component dequant + IDCT, fancy upsample, color convert."""
    planes = []
    for comp, _d, _a in scan:
        zz = comp["zz"]
        dez = np.zeros_like(zz)
        dez[:, _ZIGZAG] = zz
        blocks = dez.reshape(-1, 8, 8) * qtables[comp["tq"]][None]
        px = np.einsum("ui,nuv,vj->nij", _DCT_C, blocks, _DCT_C,
                       optimize=True)
        img = _image_from_blocks(
            px, comp["bh"], comp["bw"],
            -(-rows * comp["v"] // vmax), -(-cols * comp["h"] // hmax),
            8)
        planes.append((comp, img))
    cids = bytes(c["cid"] for c, _img in planes)
    full = [
        _upsample_chroma(img, comp["h"], comp["v"], hmax, vmax,
                         rows, cols, ctx)
        for comp, img in planes
    ]
    if cids == b"RGB":  # Adobe-style RGB frames: no transform
        return np.clip(np.stack(full, axis=-1), 0, 255).astype(np.uint8)
    return _ycbcr_to_rgb(full[0], full[1], full[2])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _quality_table(quality: int, precision: int) -> np.ndarray:
    """Annex K.1 luminance table through the libjpeg quality curve,
    x2^(P-8) for 12-bit inputs (DCT magnitudes scale with the level
    shift), clamped to the DQT entry range."""
    if not (1 <= quality <= 100):
        raise ValueError(f"quality must be 1-100, got {quality}")
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    base = _K1_LUMA * float(1 << (precision - 8))
    q = np.floor((base * scale + 50.0) / 100.0)
    hi = 255 if precision == 8 else 65535
    return np.clip(q, 1, hi).reshape(8, 8)


def _huff_lengths(freq: np.ndarray) -> dict[int, int]:
    """Huffman code lengths over symbols with freq > 0, depth-limited to
    16 by libjpeg's adjust_bits pass. A reserved pseudo-symbol (index
    len(freq)) with frequency 1 is REQUIRED to be in freq already — it
    absorbs the all-ones code (T.81 C.2's reserved pattern)."""
    import heapq

    syms = [i for i in range(freq.size) if freq[i] > 0]
    if len(syms) == 1:
        return {syms[0]: 1}
    heap = [(int(freq[s]), s, (s,)) for s in syms]
    heapq.heapify(heap)
    depth = {s: 0 for s in syms}
    while len(heap) > 1:
        fa, _, ga = heapq.heappop(heap)
        fb, tb, gb = heapq.heappop(heap)
        for s in ga + gb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, tb, ga + gb))
    # depth-limit to 16 (libjpeg jpeg_gen_optimal_table's adjustment):
    # repeatedly convert a depth-d>16 leaf pair into d-1 + sibling moves
    counts = [0] * 33
    for ln in depth.values():
        counts[ln] += 1
    for ln in range(32, 16, -1):
        while counts[ln] > 0:
            j = ln - 2
            while counts[j] == 0:
                j -= 1
            counts[ln] -= 2
            counts[ln - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
    # reassign lengths: sort symbols by (original depth, symbol) and deal
    # the adjusted length multiset out in order
    lens_sorted = [
        ln for ln in range(1, 17) for _ in range(counts[ln])
    ]
    ordered = sorted(depth, key=lambda s: (depth[s], s))
    return dict(zip(ordered, lens_sorted))


def _encode_table(freq: np.ndarray):
    """(counts[16], symbols, {sym: (code, len)}) canonical Huffman with
    the all-ones code kept unassigned via the reserved symbol."""
    f = np.append(freq.astype(np.int64), 1)  # reserved pseudo-symbol
    reserved = f.size - 1
    lengths = _huff_lengths(f)
    # the reserved symbol must sit at the DEEPEST length so that, being
    # also the largest symbol index, it owns the LAST canonical code
    # (the all-ones region) — swap lengths with a deepest real symbol
    # if the merge order left it shallower (libjpeg guarantees this via
    # its prefer-larger-symbol tiebreak; the heap here breaks ties the
    # other way)
    deepest = max(lengths.values())
    if lengths[reserved] != deepest:
        victim = max(
            (s for s, ln in lengths.items() if ln == deepest),
        )
        lengths[victim], lengths[reserved] = (
            lengths[reserved], deepest,
        )
    ordered = sorted(lengths, key=lambda s: (lengths[s], s))
    code = 0
    prev = lengths[ordered[0]]
    codes = {}
    for s in ordered:
        code <<= lengths[s] - prev
        prev = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    # the reserved symbol sorts LAST (largest index at the deepest
    # length), so it owns the lexicographically-largest code — drop it
    codes.pop(reserved, None)
    lengths.pop(reserved, None)
    counts = [0] * 16
    for ln in lengths.values():
        counts[ln - 1] += 1
    symbols = sorted(lengths, key=lambda s: (lengths[s], s))
    return counts, symbols, codes


def encode_jpeg_dct(
    frame: np.ndarray,
    quality: int = 90,
    precision: int | None = None,
    restart_blocks: int | None = None,
) -> bytes:
    """[H, W] uint8 (8-bit) or uint16 (12-bit) -> a sequential-DCT JPEG
    codestream: SOF0 for 8-bit (baseline, .4.50-compatible), SOF1 for
    12-bit (extended, .4.51). LOSSY: Annex K.1 quantization at
    ``quality`` (libjpeg curve). Per-image optimal Huffman tables.
    """
    frame = np.asarray(frame)
    if frame.ndim != 2:
        raise ValueError(f"frame must be [H, W], got {frame.shape}")
    if frame.dtype == np.uint8:
        precision = precision or 8
    elif frame.dtype == np.uint16:
        precision = precision or 12
    else:
        raise TypeError(
            f"unsupported dtype {frame.dtype} (uint8 or uint16; lossy "
            "DCT has no bit-preserving int16 convention)"
        )
    if precision not in (8, 12):
        raise ValueError(f"precision must be 8 or 12, got {precision}")
    if int(frame.max(initial=0)) >= (1 << precision):
        raise ValueError(
            f"samples exceed {precision}-bit range (max {frame.max()})"
        )
    rows, cols = frame.shape
    qtab = _quality_table(quality, precision)
    blocks, by, bx = _blocks_from_image(frame, precision)
    coeffs = np.einsum(
        "iu,nuv,jv->nij", _DCT_C, blocks, _DCT_C, optimize=True
    )
    quant = np.round(coeffs / qtab[None]).astype(np.int32)
    zz = quant.reshape(-1, 64)[:, _ZIGZAG]  # zigzag order per block

    # gather symbol statistics (one pass), then emit (second pass)
    n = zz.shape[0]
    ri = restart_blocks or 0
    dc_freq = np.zeros(16, np.int64)
    ac_freq = np.zeros(256, np.int64)
    events: list[list[tuple[int, int, int]]] = []  # per block: (sym, v, s)

    def _cat(v: int) -> int:
        return int(v).bit_length() if v >= 0 else int(-v).bit_length()

    pred = 0
    for i in range(n):
        row = zz[i]
        if ri and i % ri == 0 and i:
            pred = 0
        ev = []
        diff = int(row[0]) - pred
        pred = int(row[0])
        s = _cat(diff)
        dc_freq[s] += 1
        ev.append((-1 - s, diff, s))  # negative tag = DC event
        run = 0
        last_nz = 63
        while last_nz > 0 and row[last_nz] == 0:
            last_nz -= 1
        for k in range(1, last_nz + 1):
            v = int(row[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                ac_freq[0xF0] += 1
                ev.append((0xF0, 0, 0))
                run -= 16
            s = _cat(v)
            sym = (run << 4) | s
            ac_freq[sym] += 1
            ev.append((sym, v, s))
            run = 0
        if last_nz < 63:
            ac_freq[0x00] += 1
            ev.append((0x00, 0, 0))
        events.append(ev)

    dc_counts, dc_syms, dc_codes = _encode_table(dc_freq)
    ac_counts, ac_syms, ac_codes = _encode_table(ac_freq)

    bw = _BitWriter()
    rst = 0
    for i, ev in enumerate(events):
        if ri and i % ri == 0 and i:
            bw.marker(0xD0 + rst)
            rst = (rst + 1) % 8
        for sym, v, s in ev:
            if sym < 0:  # DC
                c, ln = dc_codes[-1 - sym]
            else:
                c, ln = ac_codes[sym]
            bw.bits(c, ln)
            if s:
                if v < 0:
                    v += (1 << s) - 1
                bw.bits(v, s)
    scan = bw.close()

    q = qtab.reshape(-1)[_ZIGZAG]  # zigzag order for DQT
    if precision == 8:
        dqt_body = bytes([0x00]) + bytes(int(x) for x in q)
    else:
        dqt_body = bytes([0x10]) + b"".join(
            struct.pack(">H", int(x)) for x in q
        )
    out = bytearray()
    out += b"\xff" + bytes([_SOI])
    out += b"\xff" + bytes([_DQT])
    out += struct.pack(">H", len(dqt_body) + 2) + dqt_body
    out += b"\xff" + bytes([_SOF0 if precision == 8 else _SOF1])
    sof = struct.pack(">BHHB", precision, rows, cols, 1)
    sof += bytes([1, 0x11, 0])  # component 1, H=V=1, Tq=0
    out += struct.pack(">H", len(sof) + 2) + sof
    dht = bytes([0x00]) + bytes(dc_counts) + bytes(dc_syms)
    dht += bytes([0x10]) + bytes(ac_counts) + bytes(ac_syms)
    out += b"\xff" + bytes([_DHT])
    out += struct.pack(">H", len(dht) + 2) + dht
    if ri:
        out += b"\xff" + bytes([_DRI]) + struct.pack(">HH", 4, ri)
    out += b"\xff" + bytes([_SOS])
    sos = bytes([1, 1, 0x00, 0, 63, 0x00])  # Ns, Cs, TdTa, Ss, Se, AhAl
    out += struct.pack(">H", len(sos) + 2) + sos
    out += scan
    out += b"\xff" + bytes([_EOI])
    return bytes(out)
