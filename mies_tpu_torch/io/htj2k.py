"""HTJ2K (ITU-T T.814 / ISO 15444-15) High-Throughput block coder.

From-spec implementation of the HT cleanup pass and the SigProp /
MagRef refinement passes (encoder AND decoder for all three),
reconstructed
instruction-by-instruction from the BSD-licensed OpenJPEG 2.5.4
``ht_dec.c`` object code in the in-tree ``libopenjp2`` (the T.814 PDF
is not available in this offline environment; the compiled open-source
decoder is the next-best normative reference, and it is the exact
implementation our streams must interoperate with).  The CxtVLC tables
live in :mod:`mies_tpu_torch.io.htj2k_tables` (see
``tools/extract_htj2k_tables.py`` for provenance and validation).

Structure of an HT cleanup codeword segment (length ``Lcup``)::

    [ MagSgn bytes -> ] ... [ MEL bytes -> ] [ <- VLC bytes ] [S][S]
    |------ Lcup - Scup ----|-------------- Scup ---------------|

``Scup = (data[Lcup-1] << 4) | (data[Lcup-2] & 0x0F)`` and the first
VLC bits ride the high nibble of ``data[Lcup-2]``.  MagSgn and MEL are
read forward, VLC backward; each stream has its own bit-stuffing rule
(reproduced exactly below — the stuffing prevents two-byte sequences
in ``FF90..FFFF`` from appearing in the codestream).

Sample/quad geometry: the codeblock is scanned in line-pairs (two
rows); each line-pair splits into 2x2 quads processed in horizontal
pairs.  Within a quad, samples are column-major: n=0 top-left,
n=1 bottom-left, n=2 top-right, n=3 bottom-right.  Per quad the VLC
codes (rho, u_off, EMB e_k, e_1); MEL codes quad significance in
context 0 and the initial row's "both u_q exceed 2" event; UVLC codes
the exponent-bound offsets u_q; MagSgn carries, for each significant
sample, ``m_n = U_q - e_k_n`` bits holding sign (LSB) and mantissa,
with magnitude ``mu = 1 + v + e_1_n * 2^(m_n - 1)``.

Signaling invariants (what the packet header's "zero bitplanes" tag
tree value ``zbp`` means for HT, verified against the reference
decoder's checks): every quad bound must satisfy ``U_q <= zbp + 1``,
and samples reconstruct at ``2^(p-1)`` granularity with
``p = B + 1 - zbp`` magnitude bitplanes in play (``B`` = band
bitplanes, ``Mb`` of the reference): ``p - 1`` planes stay below the
cleanup pass.  A lossless cleanup-only encoder therefore signals
``zbp = B`` so that ``p = 1``.
"""

from __future__ import annotations

import os

import numpy as np

from mies_tpu_torch.io.htj2k_tables import MEL_E, UVLC_PREFIX, VLC_TBL0, VLC_TBL1


class HTError(ValueError):
    """Malformed HT codeblock."""


# --------------------------------------------------------------------
# bit-stream readers (exact twins of the reference's mel/rev/frwd)
# --------------------------------------------------------------------


class _MelDec:
    """MEL bit-stream: forward, MSB-first, 13-state run-length coder.

    Stuffing: a byte following 0xFF contributes 7 bits (its MSB is
    spill-OR'd over the previous byte's last bit, exactly like the
    reference's ``t = (t << 7) | v``).  The LAST byte of the segment is
    read OR 0x0F; bytes beyond the segment read 0xFF.
    """

    def __init__(self, data: bytes, lcup: int, scup: int):
        self.data = data
        self.pos = lcup - scup
        self.size = scup - 1  # the final Scup byte is never MEL's
        self.acc = 0
        self.nbits = 0
        self.unstuff = False
        self.k = 0
        self.runs: list[int] = []

    def _feed(self) -> None:
        if self.size > 0:
            v = self.data[self.pos]
            self.pos += 1
            self.size -= 1
            if self.size == 0:
                v |= 0x0F
        else:
            v = 0xFF
        nb = 7 if self.unstuff else 8
        self.unstuff = v == 0xFF
        self.acc = (self.acc << nb) | v  # deliberate 1-bit spill OR
        self.nbits += nb

    def _bit(self) -> int:
        if self.nbits == 0:
            self._feed()
        self.nbits -= 1
        b = (self.acc >> self.nbits) & 1
        self.acc &= (1 << self.nbits) - 1
        return b

    def _decode_one(self) -> None:
        e = MEL_E[self.k]
        if self._bit():
            self.runs.append(((1 << e) - 1) * 2)
            self.k = min(self.k, 11) + 1
        else:
            v = 0
            for _ in range(e):
                v = (v << 1) | self._bit()
            self.runs.append(2 * v + 1)
            self.k = max(self.k, 1) - 1

    def get_run(self) -> int:
        if not self.runs:
            self._decode_one()
        return self.runs.pop(0)


class _RevDec:
    """VLC bit-stream: read backward from ``data[lcup-2]``, LSB-first.

    The first unit is the high nibble of ``data[lcup-2]`` (3 bits only
    if its low three bits are all ones); thereafter whole bytes, where
    a byte contributes 7 bits iff the previously-read (higher-address)
    byte was > 0x8F AND this byte's low 7 bits are all ones.  Bytes
    before the segment start read 0x00.
    """

    def __init__(self, data: bytes, lcup: int, scup: int):
        self.data = data
        self.pos = lcup - 3
        self.size = scup - 2
        d = data[lcup - 2]
        self.tmp = d >> 4
        self.bits = 3 if (self.tmp & 7) == 7 else 4
        self.unstuff = (d | 0x0F) > 0x8F

    def _feed(self) -> None:
        if self.size > 0:
            v = self.data[self.pos]
            self.pos -= 1
            self.size -= 1
        else:
            v = 0
        nb = 7 if (self.unstuff and (v & 0x7F) == 0x7F) else 8
        self.tmp |= v << self.bits  # bit-7 spill lands on the next slot
        self.bits += nb
        self.unstuff = v > 0x8F

    def fetch(self) -> int:
        while self.bits < 32:
            self._feed()
        return self.tmp & 0xFFFFFFFF

    def advance(self, n: int) -> None:
        if n > self.bits:
            raise HTError("VLC stream over-read")
        self.tmp >>= n
        self.bits -= n


class _FwdDec:
    """MagSgn / SigProp bit-stream: forward, LSB-first.

    A byte following 0xFF contributes 7 bits.  Bytes beyond the
    segment read as ``fill`` (0xFF for MagSgn, 0x00 for SigProp).
    """

    def __init__(self, data: bytes, fill: int):
        self.data = data
        self.pos = 0
        self.size = len(data)
        self.fill = fill
        self.tmp = 0
        self.bits = 0
        self.unstuff = False

    def _feed(self) -> None:
        if self.size > 0:
            v = self.data[self.pos]
            self.pos += 1
            self.size -= 1
        else:
            v = self.fill
        nb = 7 if self.unstuff else 8
        self.unstuff = v == 0xFF
        self.tmp |= v << self.bits
        self.bits += nb

    def fetch(self) -> int:
        while self.bits < 32:
            self._feed()
        return self.tmp & 0xFFFFFFFF

    def advance(self, n: int) -> None:
        while n > self.bits:
            self._feed()
        self.tmp >>= n
        self.bits -= n


# --------------------------------------------------------------------
# bit-stream writers (exact duals)
# --------------------------------------------------------------------


class _MelEnc:
    def __init__(self):
        self.k = 0
        self.run = 0  # pending count of 0-events
        self.bits: list[int] = []

    def encode(self, event: int) -> None:
        if event:
            # miss: 0 then E bits (MSB first) give the pending count
            e = MEL_E[self.k]
            self.bits.append(0)
            for i in range(e - 1, -1, -1):
                self.bits.append((self.run >> i) & 1)
            self.run = 0
            self.k = max(self.k, 1) - 1
        else:
            self.run += 1
            if self.run == 1 << MEL_E[self.k]:
                self.bits.append(1)  # hit: a full run of 2^E zeros
                self.run = 0
                self.k = min(self.k, 11) + 1

    def flush(self) -> bytes:
        if self.run > 0:
            # terminate the pending zero-run with a hit: it declares
            # 2^E[k] > run zero-events, and the surplus is never
            # requested.  Without this the decoder would read VLC
            # bytes (which share the Scup region) as MEL data.
            self.bits.append(1)
        # Pack MSB-first with the after-0xFF 7-bit stuffing rule; pad
        # the tail with 1-bits (hits).  Two last-byte hazards, both
        # from the decoder's handling of the segment's final byte:
        #   * it is read OR 0x0F — a meaningful 0 bit in the low
        #     nibble would flip to 1;
        #   * if the OR'd value is 0xFF (high nibble 0xF), the
        #     decoder's unstuff guard then requires the NEXT raw byte
        #     (the adjacent VLC byte, which we don't control) to be
        #     <= 0x8F — the reference rejects the block otherwise.
        # One appended 0x00 terminator (all-spare bits, never
        # consumed) clears both.
        out = bytearray()
        bits = self.bits
        i = 0
        n_meaningful_last = 0
        width = 8
        while i < len(bits):
            width = 7 if (out and out[-1] == 0xFF) else 8
            chunk = bits[i : i + width]
            n_meaningful_last = len(chunk)
            v = 0
            for j in range(width):
                b = chunk[j] if j < len(chunk) else 1
                v = (v << 1) | b
            out.append(v)
            i += width
        if out and (
            (out[-1] & 0xF0) == 0xF0
            or (
                n_meaningful_last > width - 4
                and (out[-1] & 0x0F) != 0x0F
            )
        ):
            out.append(0x00)
        return bytes(out)


class _RevEnc:
    """VLC writer: bits in decoder-read order, packed into bytes that
    will be laid out in REVERSE (the returned bytes are in read order:
    first the initial nibble, then successive bytes; the caller places
    byte j at address ``lcup - 3 - j`` and the nibble in the high half
    of ``data[lcup - 2]``)."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        for i in range(n):  # LSB first
            self.bits.append((value >> i) & 1)

    def flush(self) -> tuple[int, bytes]:
        bits = self.bits
        # initial nibble: 3 bits if they are 111 (the decoder then
        # counts only 3; bit 3 must read 0), else 4
        first3 = bits[:3]
        first3 += [0] * (3 - len(first3))
        if first3 == [1, 1, 1]:
            nib = 0b0111
            i = 3
        else:
            nib = 0
            for j in range(4):
                b = bits[j] if j < len(bits) else 0
                nib |= b << j
            i = 4
        out = bytearray()
        prev = (nib << 4) | 0x0F  # unstuff after the nibble ignores
        # the Scup low bits: (d | 0x0F) > 0x8F <=> nibble >= 9
        while i < len(bits):
            stuffed = prev > 0x8F
            rest = bits[i : i + 7]
            if stuffed and len(rest) == 7 and all(rest):
                v = 0x7F
                i += 7
            else:
                v = 0
                for j in range(8):
                    b = bits[i + j] if i + j < len(bits) else 0
                    v |= b << j
                i += 8
            out.append(v)
            prev = v
        return nib, bytes(out)


class _FwdEnc:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        for i in range(n):
            self.bits.append((value >> i) & 1)

    def flush(self) -> bytes:
        out = bytearray()
        i = 0
        while i < len(self.bits):
            width = 7 if (out and out[-1] == 0xFF) else 8
            v = 0
            for j in range(width):
                b = self.bits[i + j] if i + j < len(self.bits) else 0
                v |= b << j
            out.append(v)
            i += width
        # a trailing 0xFF is legal for the decoder but would abut the
        # MEL segment; the zero-padding above already avoids it unless
        # the last 8 meaningful bits are all ones — then the stuffing
        # dual (next byte <= 0x7F) is satisfied by an explicit 0x00
        if out and out[-1] == 0xFF:
            out.append(0x00)
        return bytes(out)


# --------------------------------------------------------------------
# UVLC
# --------------------------------------------------------------------


def _dec_uvlc_prefix(vlcval: int) -> tuple[int, int, int, int]:
    ln, sfx, base = UVLC_PREFIX[vlcval & 7]
    return ln, sfx, base, vlcval >> ln


def _decode_uvlc_pair(
    vlcval: int, mode: int, initial: bool
) -> tuple[int, int, int]:
    """Return (U0, U1, bits_consumed) for a quad pair.

    ``mode`` = u_off0 | u_off1 << 1, plus (initial rows only) 4 when
    the MEL "both u_q exceed 2" event fired.  The returned values are
    the decoder's ``u`` outputs (kappa-free bound contributions; for
    initial rows these are the final U_q since kappa == 1).
    """
    if mode == 0:
        return 1, 1, 0
    if mode in (1, 2):
        ln, sfx, base, v = _dec_uvlc_prefix(vlcval)
        u = base + (v & ((1 << sfx) - 1)) + 1
        return (u, 1, ln + sfx) if mode == 1 else (1, u, ln + sfx)
    if mode == 3:
        if not initial:
            ln0, sfx0, base0, v = _dec_uvlc_prefix(vlcval)
            ln1, sfx1, base1, v = _dec_uvlc_prefix(v)
            u0 = base0 + (v & ((1 << sfx0) - 1)) + 1
            v >>= sfx0
            u1 = base1 + (v & ((1 << sfx1) - 1)) + 1
            return u0, u1, ln0 + ln1 + sfx0 + sfx1
        ln0, sfx0, base0, v = _dec_uvlc_prefix(vlcval)
        if ln0 > 2:
            u1 = 2 + (v & 1)
            v >>= 1
            u0 = base0 + (v & ((1 << sfx0) - 1)) + 1
            return u0, u1, ln0 + 1 + sfx0
        ln1, sfx1, base1, v = _dec_uvlc_prefix(v)
        u0 = base0 + (v & ((1 << sfx0) - 1)) + 1
        v >>= sfx0
        u1 = base1 + (v & ((1 << sfx1) - 1)) + 1
        return u0, u1, ln0 + ln1 + sfx0 + sfx1
    # mode 4: initial rows, both u_off, MEL said both exceed 2
    ln0, sfx0, base0, v = _dec_uvlc_prefix(vlcval)
    ln1, sfx1, base1, v = _dec_uvlc_prefix(v)
    u0 = base0 + (v & ((1 << sfx0) - 1)) + 3
    v >>= sfx0
    u1 = base1 + (v & ((1 << sfx1) - 1)) + 3
    return u0, u1, ln0 + ln1 + sfx0 + sfx1


def _enc_uvlc_val(val: int) -> tuple[int, int]:
    """Encode one UVLC value >= 1 as (bits LSB-first, nbits)."""
    if val == 1:
        return 0b1, 1
    if val == 2:
        return 0b10, 2  # read order 0,1
    if val <= 4:
        # prefix 001 (read order 0,0,1) + 1 suffix bit
        return 0b100 | ((val - 3) << 3), 4
    if val > 36:
        raise HTError(f"UVLC value {val} out of range")
    return ((val - 5) << 3), 8  # prefix 000 + 5 suffix bits


def _encode_uvlc_pair(u0: int, u1: int, mode: int, initial: bool):
    """Dual of _decode_uvlc_pair: yield (value, nbits) pieces."""
    out: list[tuple[int, int]] = []
    if mode == 0:
        return out
    if mode in (1, 2):
        out.append(_enc_uvlc_val((u0 if mode == 1 else u1) - 1))
        return out
    if mode == 3:
        if not initial:
            b0, n0 = _enc_uvlc_val(u0 - 1)
            b1, n1 = _enc_uvlc_val(u1 - 1)
            out.append((b0 & ((1 << min(n0, 3)) - 1), min(n0, 3)))
            out.append((b1 & ((1 << min(n1, 3)) - 1), min(n1, 3)))
            if n0 > 3:
                out.append((b0 >> 3, n0 - 3))
            if n1 > 3:
                out.append((b1 >> 3, n1 - 3))
            return out
        # initial row, MEL bit was 0: u0 first; if its prefix is the
        # 3-bit class (u0 >= 4), u1 must be in {2, 3} and is one bit
        b0, n0 = _enc_uvlc_val(u0 - 1)
        p0 = min(n0, 3)
        out.append((b0 & ((1 << p0) - 1), p0))
        if u0 >= 4:
            if u1 not in (2, 3):
                raise HTError("initial-pair UVLC: u1 must be 2 or 3")
            out.append((u1 - 2, 1))
            if n0 > 3:
                out.append((b0 >> 3, n0 - 3))
            return out
        b1, n1 = _enc_uvlc_val(u1 - 1)
        p1 = min(n1, 3)
        out.append((b1 & ((1 << p1) - 1), p1))
        if n0 > 3:
            out.append((b0 >> 3, n0 - 3))
        if n1 > 3:
            out.append((b1 >> 3, n1 - 3))
        return out
    # mode 4: decode adds 3 to the raw prefix+suffix value
    b0, n0 = _enc_uvlc_val(u0 - 3)
    b1, n1 = _enc_uvlc_val(u1 - 3)
    out.append((b0 & ((1 << min(n0, 3)) - 1), min(n0, 3)))
    out.append((b1 & ((1 << min(n1, 3)) - 1), min(n1, 3)))
    if n0 > 3:
        out.append((b0 >> 3, n0 - 3))
    if n1 > 3:
        out.append((b1 >> 3, n1 - 3))
    return out


# --------------------------------------------------------------------
# encoder-side CxtVLC lookup: (tbl, ctx, rho, u_off) -> candidates
# --------------------------------------------------------------------


def _build_enc_tables():
    tabs = []
    for tbl in (VLC_TBL0, VLC_TBL1):
        m: dict[tuple[int, int, int], list[tuple[int, int, int, int]]] = {}
        for ctx in range(8):
            seen = set()
            for w in range(128):
                e = tbl[(ctx << 7) | w]
                ln = e & 7
                cwd = w & ((1 << ln) - 1)
                key = (e, cwd)
                if key in seen:
                    continue
                seen.add(key)
                rho = (e >> 4) & 0xF
                u_off = (e >> 3) & 1
                e_1 = (e >> 8) & 0xF
                e_k = (e >> 12) & 0xF
                m.setdefault((ctx, rho, u_off), []).append(
                    (ln, cwd, e_k, e_1)
                )
        for cands in m.values():
            cands.sort()
        tabs.append(m)
    return tabs


_ENC_TBL = _build_enc_tables()


def _select_entry(initial: bool, ctx: int, rho: int, u_off: int,
                  eps: int, u_gt1: bool):
    """Pick the shortest valid codeword for a quad.

    ``eps`` = bit pattern of samples whose exponent attains U_q.
    Valid iff e_1 == e_k & eps, and (U_q > 1 or e_k == 0) so every
    significant sample keeps >= 1 MagSgn bit for its sign.
    """
    cands = _ENC_TBL[0 if initial else 1].get((ctx, rho, u_off))
    if not cands:
        raise HTError(
            f"no CxtVLC entry for ctx={ctx} rho={rho:#x} u_off={u_off}"
        )
    for ln, cwd, e_k, e_1 in cands:
        if e_1 != (e_k & eps):
            continue
        if not u_gt1 and e_k:
            continue
        return ln, cwd, e_k, e_1
    raise HTError(
        f"no valid CxtVLC entry for ctx={ctx} rho={rho:#x} "
        f"u_off={u_off} eps={eps:#x}"
    )


# --------------------------------------------------------------------
# cleanup-pass decoder
# --------------------------------------------------------------------


def _bitlen(x: int) -> int:
    return x.bit_length()


def decode_ht_cleanup(
    data: bytes, lcup: int, w: int, h: int, zbp: int
) -> tuple[np.ndarray, np.ndarray]:
    """Decode the HT cleanup pass of one codeblock.

    Returns ``(mu, sign)``: integer magnitudes (0 = insignificant) and
    the sign bits, both ``[h, w]``.  ``zbp`` is the packet header's
    zero-bitplanes value; every decoded ``U_q`` must be
    ``<= zbp + 1``.
    """
    if lcup < 2 or lcup > len(data):
        raise HTError("invalid cleanup segment length")
    scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0x0F)
    if scup < 2 or scup > lcup or scup > 4079:
        raise HTError("2 <= Scup <= min(Lcup, 4079) violated")
    mel = _MelDec(data, lcup, scup)
    vlc = _RevDec(data, lcup, scup)
    ms = _FwdDec(data[: lcup - scup], fill=0xFF)

    mu = np.zeros((h, w), np.int64)
    sg = np.zeros((h, w), np.uint8)
    limit = zbp + 1
    nq = (w + 1) // 2  # quads per row

    mel_run = mel.get_run()
    # E[j] = (significant, exponent) straddling quads j-1 | j of the
    # previous line-pair's bottom row (max of its two adjacent samples)
    e_prev = [(0, 0)] * (nq + 2)

    for y in range(0, h, 2):
        initial = y == 0
        tbl = VLC_TBL0 if initial else VLC_TBL1
        e_cur = [(0, 0)] * (nq + 2)
        cq_w = 0  # the W-neighbour context contribution
        vlcval = vlc.fetch()
        for q in range(0, w, 4):
            j = q // 2  # quad index of the pair's first quad
            qinf = [0, 0]
            us: list[int] = [1, 1]

            def _dec_quad(idx_quad: int, ctx: int) -> int:
                nonlocal mel_run, vlcval
                e = tbl[(ctx << 7) | (vlcval & 0x7F)]
                if ctx == 0:
                    mel_run -= 2
                    if mel_run != -1:
                        e = 0
                    if mel_run < 0:
                        mel_run = mel.get_run()
                qinf[idx_quad] = e
                vlc.advance(e & 7)
                vlcval = vlc.fetch()
                return e

            if initial:
                e0 = _dec_quad(0, cq_w)
                cq_w = ((e0 >> 4) & 1) | ((e0 >> 5) & 7)
                if q + 2 < w:
                    e1 = _dec_quad(1, cq_w)
                    cq_w = ((e1 >> 4) & 1) | ((e1 >> 5) & 7)
            else:
                ctx0 = (
                    cq_w
                    | (e_prev[j][0])
                    | (e_prev[j + 1][0] << 2)
                )
                e0 = _dec_quad(0, ctx0)
                cq_w = ((e0 >> 5) | (e0 >> 6)) & 2
                if q + 2 < w:
                    ctx1 = (
                        cq_w
                        | (e_prev[j + 1][0])
                        | (e_prev[j + 2][0] << 2)
                    )
                    e1 = _dec_quad(1, ctx1)
                    cq_w = ((e1 >> 5) | (e1 >> 6)) & 2

            q0, q1 = qinf
            mode = ((q0 >> 3) & 1) | ((q1 >> 2) & 2)
            if initial and mode == 3:
                mel_run -= 2
                if mel_run == -1:
                    mode = 4
                if mel_run < 0:
                    mel_run = mel.get_run()
            u0, u1, consumed = _decode_uvlc_pair(vlcval, mode, initial)
            vlc.advance(consumed)
            vlcval = vlc.fetch()
            if not initial:
                if ((q0 & 0xF0) & ((q0 & 0xF0) - 1)) != 0:
                    emax = max(e_prev[j][1], e_prev[j + 1][1])
                    u0 += max(emax, 2) - 2
                if ((q1 & 0xF0) & ((q1 & 0xF0) - 1)) != 0:
                    emax = max(e_prev[j + 1][1], e_prev[j + 2][1])
                    u1 += max(emax, 2) - 2
            if u0 > limit or u1 > limit:
                raise HTError("U_q larger than zero bitplanes + 1")
            us[0], us[1] = u0, u1

            mask = 0xFF
            if q + 3 >= w:
                mask >>= 2 * (q + 4 - w)
            if h <= 1:
                mask &= 0x55
            elif y + 1 >= h:
                mask &= 0x55
            rho_pair = ((q0 >> 4) & 0xF) | (q1 & 0xF0)
            if rho_pair & ~mask:
                raise HTError(
                    "VLC significance outside the codeblock area"
                )

            for slot in range(8):
                quad = slot >> 2
                n = slot & 3
                col = q + 2 * quad + (n >> 1)
                row = y + (n & 1)
                e = qinf[quad]
                if (e >> 4) & (1 << n):
                    m = us[quad] - ((e >> (12 + n)) & 1)
                    msval = ms.fetch() & ((1 << m) - 1)
                    ms.advance(m)
                    i_n = (e >> (8 + n)) & 1
                    x = (msval | 1) + (i_n << m)
                    val = (x + 1) >> 1
                    mu[row, col] = val
                    sg[row, col] = msval & 1 if m else 0
                    if n & 1:  # bottom-row sample: E tracking
                        jj = j + quad + (n >> 1)
                        old = e_cur[jj]
                        e_cur[jj] = (1, max(old[1], _bitlen(x)))
                # insignificant in-block samples stay zero

        e_prev = e_cur
    return mu, sg


# --------------------------------------------------------------------
# SigProp + MagRef decoders (refinement segment)
# --------------------------------------------------------------------


class _RevMrp:
    """MagRef bit-stream: read backward from the END of the
    refinement segment, LSB-first, with the VLC unstuffing rule and —
    the MagRef twist — the unstuff flag initially SET (the segment's
    last byte contributes 7 bits when its low 7 bits are all ones)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = len(data) - 1
        self.size = len(data)
        self.tmp = 0
        self.bits = 0
        self.unstuff = True

    def _feed(self) -> None:
        if self.size > 0:
            v = self.data[self.pos]
            self.pos -= 1
            self.size -= 1
        else:
            v = 0
        nb = 7 if (self.unstuff and (v & 0x7F) == 0x7F) else 8
        self.tmp |= v << self.bits
        self.bits += nb
        self.unstuff = v > 0x8F

    def fetch(self) -> int:
        while self.bits < 32:
            self._feed()
        return self.tmp & 0xFFFFFFFF

    def advance(self, n: int) -> None:
        self.tmp >>= n
        self.bits -= n


# SigProp in-pass causal extension: a sample at stripe-row r made
# significant extends the candidate set to (r+1, same col) and rows
# r-1..r+1 of the NEXT column — the reference's 0x32/0x74/0xE8/0xC0
# nibble masks.  Entries are (ABSOLUTE stripe-row, column delta).
_SP_EXT = {
    0: ((1, 0), (0, 1), (1, 1)),
    1: ((2, 0), (0, 1), (1, 1), (2, 1)),
    2: ((3, 0), (1, 1), (2, 1), (3, 1)),
    3: ((2, 1), (3, 1)),
}


def _sigprop_walk(h, w, sig_clean, sig, sig_bit, sign_bit) -> None:
    """The SigProp candidate walk, shared VERBATIM by decode and
    encode (the bit SEQUENCE is defined by this walk; two copies once
    disagreed on absolute vs relative stripe rows).

    ``sig_bit(y, x) -> 0/1`` produces/consumes one significance bit;
    ``sign_bit(y, x)`` one sign bit.  Per 4-column group all
    significance bits come first, then the new samples' signs.
    Candidates are insignificant samples with a significant
    8-neighbour — the row above a stripe post-SigProp, the row below
    cleanup-only — extended causally within the stripe by the
    reference's 0x32/0x74/0xE8/0xC0 masks (absolute stripe-rows).
    """
    for s0 in range(0, h, 4):
        sh = min(4, h - s0)
        # vectorized 8-neighbour dilation of the significance context
        # (rows s0-1 .. s0+sh: the row above is post-SigProp, the row
        # below cleanup-only — `sig` holds exactly that state here)
        ctx = np.zeros((sh + 2, w + 2), bool)
        ctx[1 : sh + 1, 1 : w + 1] = sig[s0 : s0 + sh, :]
        if s0 > 0:
            ctx[0, 1 : w + 1] = sig[s0 - 1, :]
        if s0 + sh < h:
            ctx[sh + 1, 1 : w + 1] = sig[s0 + sh, :]
        dil = np.zeros((sh, w), bool)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                dil |= ctx[dy : dy + sh, dx : dx + w]
        mbr = np.zeros((4, w), bool)
        mbr[:sh] = dil & ~sig_clean[s0 : s0 + sh, :]
        for gbase in range(0, w, 4):
            if not mbr[:, gbase : gbase + 4].any():
                continue  # no candidates -> the group consumes 0 bits
            new: list[tuple[int, int]] = []
            for c in range(gbase, min(gbase + 4, w)):
                for r in range(sh):
                    if not mbr[r, c]:
                        continue
                    if sig_bit(s0 + r, c):
                        new.append((r, c))
                        sig[s0 + r, c] = True
                        for rr, dc in _SP_EXT[r]:
                            cc = c + dc
                            if (
                                s0 + rr < h
                                and cc < w
                                and not sig_clean[s0 + rr, cc]
                            ):
                                mbr[rr, cc] = True
            for r, c in new:
                sign_bit(s0 + r, c)


def _sigprop_decode(rd, v, sg, sig, p, h, w) -> None:
    """SigProp (pass 2), decode side: bits from the forward reader."""
    half3 = 3 << (p - 2)

    def sig_bit(y, x):
        b = rd.fetch() & 1
        rd.advance(1)
        return b

    def sign_bit(y, x):
        sgn = rd.fetch() & 1
        rd.advance(1)
        v[y, x] = half3
        sg[y, x] = sgn

    _sigprop_walk(h, w, sig.copy(), sig, sig_bit, sign_bit)


def _sigprop_encode(wr, coeffs, sig_clean, p, h, w) -> None:
    """SigProp encode: the same walk, emitting bits."""
    mu = np.abs(coeffs)

    def sig_bit(y, x):
        b = int((int(mu[y, x]) >> (p - 2)) & 1)
        wr.put(b, 1)
        return b

    def sign_bit(y, x):
        wr.put(1 if coeffs[y, x] < 0 else 0, 1)

    _sigprop_walk(h, w, sig_clean, sig_clean.copy(), sig_bit,
                  sign_bit)


def _magref_decode(rd, v, sig_clean, p, h, w) -> None:
    """MagRef (pass 3): one bit per CLEANUP-significant sample (the
    SigProp additions are excluded), stripe-major then column then
    row; the bit keeps (1) or clears (0) plane p-1, then the midpoint
    moves to plane p-2."""
    hi = 1 << (p - 1)
    half = 1 << (p - 2)
    for s in range(0, h, 4):
        sh = min(4, h - s)
        # column-major within the stripe (col, then row) — bulk-read
        # one bit per cleanup-significant sample in that order
        block = sig_clean[s : s + sh, :]
        n = int(block.sum())
        if not n:
            continue
        bits = np.empty(n, np.int64)
        i = 0
        while i < n:
            take = min(32, n - i)
            win = rd.fetch()
            for j in range(take):
                bits[i + j] = (win >> j) & 1
            rd.advance(take)
            i += take
        rows, cols = np.nonzero(block.T)  # (col-major order)
        ys = s + cols  # block.T nonzero: rows=col idx, cols=row idx
        xs = rows
        vals = v[ys, xs]
        vals ^= (1 - bits) * hi
        vals |= half
        v[ys, xs] = vals


def decode_ht_refinement(
    ref: bytes,
    num_extra: int,
    mu: np.ndarray,
    sg: np.ndarray,
    p: int,
) -> np.ndarray:
    """Apply SigProp (and, when ``num_extra == 2``, MagRef) to the
    cleanup result.  Returns the refined fixed-point magnitudes
    ``v`` — the reference's ``(2*mu + 1) << (p - 1)`` representation,
    whose final integer magnitude is ``v >> 1``."""
    if p < 2:
        raise HTError(
            "refinement passes with p = 1 are malformed (no plane "
            "below the cleanup pass)"
        )
    h, w = mu.shape
    v = np.where(mu > 0, (2 * mu.astype(np.int64) + 1) << (p - 1), 0)
    sig_clean = mu > 0
    sig = sig_clean.copy()
    _sigprop_decode(_FwdDec(ref, fill=0), v, sg, sig, p, h, w)
    if num_extra > 1:
        _magref_decode(_RevMrp(ref), v, sig_clean, p, h, w)
    return v


def _magref_encode(bits: list[int], coeffs, sig_clean, p, h, w):
    mu = np.abs(coeffs)
    for s in range(0, h, 4):
        sh = min(4, h - s)
        for c in range(w):
            for r in range(sh):
                if sig_clean[s + r, c]:
                    bits.append(int((int(mu[s + r, c]) >> (p - 2)) & 1))


def _mrp_flush(bits: list[int]) -> bytes:
    """Pack MagRef bits for the BACKWARD reader: byte j of the output
    is read j-th from the segment's end.  The first-read byte sees the
    unstuff flag SET; thereafter the VLC rule applies."""
    out = bytearray()
    i = 0
    prev_gt = True  # initial unstuff state
    n = len(bits)
    while i < n:
        rest = bits[i : i + 7]
        if prev_gt and len(rest) == 7 and all(rest):
            out.append(0x7F)
            i += 7
        else:
            b = 0
            for j in range(8):
                if i + j < n:
                    b |= bits[i + j] << j
            out.append(b)
            i += 8
        prev_gt = out[-1] > 0x8F
    return bytes(out)


def encode_ht_refinement(coeffs: np.ndarray, p: int) -> bytes:
    """SigProp + MagRef segment for ``p = 2`` coding (the standard
    3-pass HT form): SigProp bytes forward, MagRef bytes reversed at
    the tail, sharing one codeword segment."""
    h, w = coeffs.shape
    mu = np.abs(coeffs.astype(np.int64))
    sig_clean = (mu >> (p - 1)) > 0
    spp = _FwdEnc()
    _sigprop_encode(spp, coeffs, sig_clean, p, h, w)
    mrp_bits: list[int] = []
    _magref_encode(mrp_bits, coeffs, sig_clean, p, h, w)
    return spp.flush() + bytes(reversed(_mrp_flush(mrp_bits)))


# --------------------------------------------------------------------
# cleanup-pass encoder
# --------------------------------------------------------------------


def encode_ht_cleanup(
    mu: np.ndarray, sg: np.ndarray, zbp: int
) -> bytes:
    """Encode one codeblock's cleanup pass (the exact dual of
    :func:`decode_ht_cleanup`).

    ``mu`` int magnitudes (0 = insignificant), ``sg`` sign bits.
    ``zbp`` is the zero-bitplanes value the packet header will signal;
    every quad bound U_q must satisfy ``U_q <= zbp + 1`` (the caller
    picks ``zbp = B - 1`` for lossless cleanup-only coding).
    """
    h, w = mu.shape
    mel = _MelEnc()
    vlc = _RevEnc()
    ms = _FwdEnc()
    limit = zbp + 1
    nq = (w + 1) // 2

    e_prev = [(0, 0)] * (nq + 2)

    for y in range(0, h, 2):
        initial = y == 0
        e_cur = [(0, 0)] * (nq + 2)
        cq_w = 0
        for q in range(0, w, 4):
            j = q // 2
            quads = []
            for quad in range(2):
                if quad == 1 and q + 2 >= w:
                    quads.append(None)
                    continue
                rho = 0
                exps = [0, 0, 0, 0]
                for n in range(4):
                    col = q + 2 * quad + (n >> 1)
                    row = y + (n & 1)
                    if row < h and col < w and mu[row, col]:
                        rho |= 1 << n
                        exps[n] = _bitlen(2 * int(mu[row, col]) - 1)
                quads.append((rho, exps))

            # contexts + kappa
            ctxs = [0, 0]
            kappas = [1, 1]
            for quad in range(2):
                if quads[quad] is None:
                    continue
                if initial:
                    ctxs[quad] = cq_w
                else:
                    jj = j + quad
                    ctxs[quad] = (
                        cq_w
                        | e_prev[jj][0]
                        | (e_prev[jj + 1][0] << 2)
                    )
                rho = quads[quad][0]
                if not initial and (rho & (rho - 1)) != 0:
                    jj = j + quad
                    emax = max(e_prev[jj][1], e_prev[jj + 1][1])
                    kappas[quad] = max(emax - 1, 1)
                # W context chain for the next quad
                if initial:
                    # decoder: ((qinf >> 4) & 1) | ((qinf >> 5) & 7)
                    cq_w = (rho & 1) | ((rho >> 1) & 7)
                else:
                    cq_w = 2 if (rho & 0xC) else 0

            # bounds + u_off
            U = [1, 1]
            u_off = [0, 0]
            for quad in range(2):
                if quads[quad] is None:
                    continue
                rho, exps = quads[quad]
                emaxq = max(exps) if rho else 0
                U[quad] = max(kappas[quad], emaxq)
                u_q = U[quad] - kappas[quad]
                u_off[quad] = 1 if u_q > 0 else 0
                if rho == 0:
                    U[quad] = kappas[quad]
                if U[quad] > limit:
                    raise HTError(
                        f"U_q={U[quad]} exceeds zbp+1={limit}"
                    )

            mode = u_off[0] | (u_off[1] << 1)
            melbit = None
            if initial and mode == 3:
                melbit = 1 if (U[0] > 3 and U[1] > 3) else 0

            # emit quad VLC codewords (+ MEL significance events)
            for quad in range(2):
                if quads[quad] is None:
                    continue
                rho, exps = quads[quad]
                if ctxs[quad] == 0:
                    mel.encode(1 if rho else 0)
                    if not rho:
                        quads[quad] = (0, exps, 0, 0)
                        continue
                eps = 0
                for n in range(4):
                    if (rho >> n) & 1 and exps[n] == U[quad]:
                        eps |= 1 << n
                ln, cwd, e_k, e_1 = _select_entry(
                    initial, ctxs[quad], rho, u_off[quad], eps,
                    U[quad] > 1,
                )
                quads[quad] = (rho, exps, e_k, e_1)
                vlc.put(cwd, ln)

            if melbit is not None:
                mel.encode(melbit)
                if melbit:
                    mode = 4
            if initial:
                uv0 = U[0] if u_off[0] else 1
                uv1 = U[1] if u_off[1] else 1
            else:
                uv0 = U[0] - kappas[0] + 1 if u_off[0] else 1
                uv1 = U[1] - kappas[1] + 1 if u_off[1] else 1
            for val, n in _encode_uvlc_pair(uv0, uv1, mode, initial):
                vlc.put(val, n)

            # MagSgn + E tracking
            for quad in range(2):
                if quads[quad] is None:
                    continue
                rho, exps, e_k, e_1 = quads[quad]
                for n in range(4):
                    if not ((rho >> n) & 1):
                        continue
                    col = q + 2 * quad + (n >> 1)
                    row = y + (n & 1)
                    m = U[quad] - ((e_k >> n) & 1)
                    i_n = (e_1 >> n) & 1
                    muv = int(mu[row, col])
                    v = muv - 1 - (i_n << (m - 1)) if m else 0
                    if v < 0 or (m and v >= (1 << max(m - 1, 0))):
                        raise HTError(
                            f"magnitude {muv} unencodable with "
                            f"m={m} i={i_n} U={U[quad]}"
                        )
                    word = (v << 1) | int(sg[row, col])
                    ms.put(word, m)
                    if n & 1:
                        x = 2 * muv - 1
                        jj = j + quad + (n >> 1)
                        old = e_cur[jj]
                        e_cur[jj] = (1, max(old[1], _bitlen(x)))
        e_prev = e_cur

    magsgn = ms.flush()
    melb = mel.flush()
    nib, vlcb = vlc.flush()
    scup = len(melb) + len(vlcb) + 2
    if scup > 4079:
        raise HTError("Scup overflow (codeblock too complex)")
    seg = bytearray(magsgn)
    seg += melb
    seg += bytes(reversed(vlcb))
    seg.append((nib << 4) | (scup & 0xF))
    seg.append(scup >> 4)
    if len(seg) - len(magsgn) != scup:
        raise HTError("internal: Scup bookkeeping")
    return bytes(seg)


# --------------------------------------------------------------------
# block-level API used by the Tier-2 integration
# --------------------------------------------------------------------


def _native_ht() -> bool:
    """The C++ twin (native/htj2k_t1.cpp) is the default hot path
    (~120x encode / ~170x decode vs these bit-serial Python loops:
    15.9 / 3.7 ms per 512^2-equivalent of 64x64 blocks vs ~1.9 s /
    0.65 s); ``MIES_TPU_HTJ2K_NATIVE=0`` pins pure Python.  Both are
    bit-equal — tests pin segment bytes and decoded planes."""
    if os.environ.get("MIES_TPU_HTJ2K_NATIVE", "1") == "0":
        return False
    from mies_tpu_torch import native

    return native.available()


def decode_ht_block_parts(
    data: bytes,
    w: int,
    h: int,
    zbp: int,
    num_passes: int,
    B: int,
    seg2_len: int = 0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode an HT codeblock to ``(mag, chi, undecoded_planes)`` —
    the same contract as the classic Tier-1 ``_t1_decode`` so
    ``_band_coeffs`` applies identical reversible / irreversible
    reconstruction to both coders.  ``undecoded_planes = p - 1`` with
    ``p = B + 1 - zbp``."""
    if B > 30:
        raise HTError(f"more than 30 bitplanes ({B}) unsupported")
    p = B + 1 - zbp
    if p < 1:
        raise HTError(
            f"{zbp} zero bitplanes in {B} bitplanes is malformed"
        )
    lcup = len(data) - seg2_len
    if _native_ht():
        from mies_tpu_torch import native

        mu, sg = native.ht_decode(bytes(data[:lcup]), w, h, zbp)
    else:
        mu, sg = decode_ht_cleanup(data, lcup, w, h, zbp)
    if num_passes > 1 and p > 1:
        v = decode_ht_refinement(
            bytes(data[lcup:]), num_passes - 1, mu, sg, p
        )
        # v is the reference's fixed-point (2*mag + 1) << (p - 1)
        # form with SigProp/MagRef folded in; its final magnitude is
        # v >> 1 with every remaining midpoint already applied
        return (v >> 1).astype(np.int32), sg, 0
    # extra passes with p == 1 carry no plane to refine — the
    # reference warns and decodes the cleanup pass only
    return mu.astype(np.int32), sg, p - 1


def decode_ht_block(
    data: bytes,
    w: int,
    h: int,
    zbp: int,
    num_passes: int,
    B: int,
    seg2_len: int = 0,
) -> np.ndarray:
    """Decode an HT codeblock to signed integer coefficients.

    ``data`` holds the cleanup segment followed (if ``num_passes > 1``)
    by the refinement segment of ``seg2_len`` bytes.  ``B`` is the
    band's total bitplane count (Mb); ``p = B + 1 - zbp`` with
    ``p - 1`` magnitude planes below the cleanup pass: cleanup-only
    blocks reconstruct at the midpoint of the ``2^(p-1)`` uncertainty
    interval, matching the reference decoder.
    """
    mu, sg, und = decode_ht_block_parts(
        data, w, h, zbp, num_passes, B, seg2_len
    )
    out = mu.astype(np.int64)
    if und > 0:
        # midpoint reconstruction of the uncoded planes, exactly the
        # reference's (v + 2) << (p - 1) then /2 sign-magnitude
        out = np.where(out > 0, (out << und) + (1 << (und - 1)), 0)
    neg = sg.astype(bool)
    return np.where(neg, -out, out)


def encode_ht_block(coeffs: np.ndarray, B: int) -> tuple[bytes, int]:
    """Encode signed integer coefficients as a lossless cleanup-only
    HT codeblock.  Returns ``(segment, zbp)`` with ``zbp = B``
    (i.e. p = 1: no uncoded planes).  The caller signals ``zbp`` via
    the packet header tag tree and a single coding pass.
    """
    if B > 30:
        raise HTError(f"more than 30 bitplanes ({B}) unsupported")
    mu = np.abs(coeffs).astype(np.int64)
    sg = (coeffs < 0).astype(np.uint8)
    kmax = int(_bitlen(int(2 * mu.max() - 1))) if mu.any() else 0
    zbp = B  # p = B + 1 - zbp = 1: every magnitude plane is coded
    if kmax > zbp + 1:
        raise HTError(
            f"sample exponent {kmax} exceeds band bitplanes + 1"
        )
    if _native_ht():
        from mies_tpu_torch import native

        return native.ht_encode(np.asarray(coeffs, np.int32), B)
    return encode_ht_cleanup(mu, sg, zbp), zbp


def encode_ht_block_3pass(
    coeffs: np.ndarray, B: int
) -> tuple[bytes, bytes, int]:
    """Encode signed coefficients as the standard 3-pass HT form
    (p = 2): the cleanup pass codes magnitudes >> 1 and SigProp +
    MagRef carry plane 0 in a second codeword segment.  Returns
    ``(cleanup_segment, refinement_segment, zbp)`` with
    ``zbp = B - 1`` — lossless when all three passes are kept."""
    if B > 30:
        raise HTError(f"more than 30 bitplanes ({B}) unsupported")
    if B < 2:
        raise HTError("3-pass coding needs at least 2 bitplanes")
    p = 2
    zbp = B - 1  # p = B + 1 - zbp = 2
    c = np.asarray(coeffs, np.int64)
    mu_half = np.abs(c) >> 1
    sg = (c < 0).astype(np.uint8)
    kmax = (
        int(_bitlen(int(2 * mu_half.max() - 1))) if mu_half.any() else 0
    )
    if kmax > zbp + 1:
        raise HTError(
            f"sample exponent {kmax} exceeds zero bitplanes + 1"
        )
    cleanup = encode_ht_cleanup(mu_half, sg, zbp)
    ref = encode_ht_refinement(c, p)
    return cleanup, ref, zbp
