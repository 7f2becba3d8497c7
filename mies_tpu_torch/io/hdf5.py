"""Minimal pure-Python HDF5 reader — NetCDF-4 volume ingest without
the C stack (SURVEY.md §2b D9: the reference's one volume dependency
reads classic and NetCDF-4 transparently, so an HDF5-backed ``.nc``
volume must load without netCDF4 installed).

Scope is what libhdf5 emits for the files ``netCDF4.Dataset`` /
``h5py.File`` produce by default, read-only:

* superblock v0 (old-style root symbol table) and v2/v3;
* object headers v1 and v2 ("OHDR"), with continuation blocks;
* old-style groups (symbol-table message -> v1 B-tree of "SNOD" nodes
  + local heap) and new-style COMPACT link messages (netCDF's root
  group holds a handful of variables — dense fractal-heap storage
  kicks in past 8 links and is refused by name);
* dataspace v1/v2, datatype classes 0/1 (fixed-point and IEEE float,
  either byte order), data layout v3 (compact / contiguous / chunked
  with v1 B-tree chunk index);
* filter pipeline v1/v2 with gzip (deflate), shuffle and fletcher32
  (checksum skipped, data passed through).

Everything else is a guidance-bearing refusal naming the feature.
Like io/netcdf3.py: stdlib + numpy only.  The golden source lives
in-tree — h5py/libhdf5 writes real files in this environment, so the
tests generate fixtures with the REAL library and pin byte equality
(tests/test_io.py::TestHdf5).

io/volume.py dispatches: classic CDF -> scipy reader; HDF5 ``.nc`` ->
netCDF4 package if installed, else THIS reader (full loads and lazy
z-slab streaming both supported).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF


class _Reader:
    """Byte-level cursor over the file image with the superblock's
    offset/length sizes.  OWNS the mmap + fd: datasets hold a _Reader
    reference, so the mapping lives exactly as long as anything that
    can still read from it."""

    def __init__(self, buf, osz: int, lsz: int, ctx: str, fobj=None):
        self.buf = buf
        self.osz, self.lsz = osz, lsz
        self.ctx = ctx
        self._fobj = fobj

    def __del__(self):
        try:
            if hasattr(self.buf, "close"):
                self.buf.close()
            if self._fobj is not None:
                self._fobj.close()
        except Exception:
            pass

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def off(self, pos: int) -> int:
        v = self.u(pos, self.osz)
        return _UNDEF if v == (1 << (8 * self.osz)) - 1 else v

    def ln(self, pos: int) -> int:
        return self.u(pos, self.lsz)


def is_hdf5(path: str | Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == _SIG
    except OSError:
        return False


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


def _parse_dataspace(d: bytes, rd: _Reader, ctx: str) -> tuple[int, ...]:
    ver = d[0]
    rank = d[1]
    if ver == 1:
        pos = 8
    elif ver == 2:
        pos = 4
    else:
        raise NotImplementedError(f"{ctx}: dataspace version {ver}")
    dims = []
    for _ in range(rank):
        dims.append(int.from_bytes(d[pos:pos + rd.lsz], "little"))
        pos += rd.lsz
    return tuple(dims)


def _parse_datatype(d: bytes, ctx: str) -> np.dtype:
    cls = d[0] & 0x0F
    ver = d[0] >> 4
    bits = int.from_bytes(d[1:4], "little")
    size = int.from_bytes(d[4:8], "little")
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"{ctx}: {size}-byte fixed-point datatype")
        kind = "i" if bits & 0x08 else "u"
        return np.dtype(f"{order}{kind}{size}")
    if cls == 1:  # IEEE float
        if size not in (2, 4, 8):
            raise NotImplementedError(f"{ctx}: {size}-byte float")
        return np.dtype(f"{order}f{size}")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 8: "enum", 9: "vlen",
             10: "array"}
    raise NotImplementedError(
        f"{ctx}: datatype class {names.get(cls, cls)} (v{ver}) — only "
        "fixed-point and IEEE float volumes are supported"
    )


def _parse_filters(d: bytes, ctx: str) -> list[tuple[int, tuple]]:
    ver = d[0]
    nf = d[1]
    pos = 8 if ver == 1 else 2
    out = []
    for _ in range(nf):
        fid = int.from_bytes(d[pos:pos + 2], "little")
        if ver == 1 or fid >= 256:
            namelen = int.from_bytes(d[pos + 2:pos + 4], "little")
            pos += 4
        else:
            namelen = 0
            pos += 2
        pos += 2  # flags
        nvals = int.from_bytes(d[pos:pos + 2], "little")
        pos += 2 + namelen
        vals = tuple(
            int.from_bytes(d[pos + 4 * i:pos + 4 * i + 4], "little")
            for i in range(nvals)
        )
        pos += 4 * nvals
        if ver == 1 and nvals % 2:
            pos += 4  # v1 pads odd client-value counts
        out.append((fid, vals))
    return out


def _parse_messages_v1(rd: _Reader, addr: int, ctx: str) -> list:
    buf = rd.buf
    if buf[addr] != 1:
        raise NotImplementedError(
            f"{ctx}: object header prefix version {buf[addr]}")
    nmsgs = rd.u(addr + 2, 2)
    hdrsize = rd.u(addr + 8, 4)
    blocks = [(addr + 16, hdrsize)]  # 12-byte prefix + 4 pad
    msgs = []
    while blocks and len(msgs) < nmsgs:
        bpos, bsize = blocks.pop(0)
        pos, end = bpos, bpos + bsize
        while pos + 8 <= end and len(msgs) < nmsgs:
            mtype = rd.u(pos, 2)
            msize = rd.u(pos + 2, 2)
            data = buf[pos + 8:pos + 8 + msize]
            if mtype == 0x0010:  # continuation
                blocks.append((
                    int.from_bytes(data[:rd.osz], "little"),
                    int.from_bytes(data[rd.osz:rd.osz + rd.lsz],
                                   "little")))
            else:
                msgs.append((mtype, data))
            pos += 8 + msize
    return msgs


def _parse_messages_v2(rd: _Reader, addr: int, ctx: str) -> list:
    buf = rd.buf
    if buf[addr:addr + 4] != b"OHDR":
        raise ValueError(f"{ctx}: bad v2 object header signature")
    flags = buf[addr + 5]
    pos = addr + 6
    if flags & 0x20:
        pos += 16  # times
    if flags & 0x10:
        pos += 4  # max compact / min dense
    szlen = 1 << (flags & 0x03)
    chunk0 = rd.u(pos, szlen)
    pos += szlen
    track_order = bool(flags & 0x04)
    blocks = [(pos, chunk0)]
    msgs = []
    while blocks:
        bpos, bsize = blocks.pop(0)
        pos, end = bpos, bpos + bsize
        while pos + 4 <= end:
            mtype = buf[pos]
            msize = rd.u(pos + 1, 2)
            pos += 4
            if track_order:
                pos += 2
            data = buf[pos:pos + msize]
            pos += msize
            if mtype == 0x10:
                caddr = int.from_bytes(data[:rd.osz], "little")
                clen = int.from_bytes(
                    data[rd.osz:rd.osz + rd.lsz], "little")
                if buf[caddr:caddr + 4] != b"OCHK":
                    raise ValueError(f"{ctx}: bad OCHK continuation")
                blocks.append((caddr + 4, clen - 8))  # sig + checksum
            else:
                msgs.append((mtype, data))
    return msgs


def _object_messages(rd: _Reader, addr: int, ctx: str) -> list:
    if rd.buf[addr:addr + 4] == b"OHDR":
        return _parse_messages_v2(rd, addr, ctx)
    return _parse_messages_v1(rd, addr, ctx)


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------


def _heap_name(rd: _Reader, heap_addr: int, off: int, ctx: str) -> str:
    buf = rd.buf
    if buf[heap_addr:heap_addr + 4] != b"HEAP":
        raise ValueError(f"{ctx}: bad local heap signature")
    data_addr = rd.off(heap_addr + 8 + 2 * rd.lsz)
    end = buf.find(b"\x00", data_addr + off)  # mmap has find, not index
    if end < 0:
        raise ValueError(f"{ctx}: unterminated local-heap name")
    return bytes(buf[data_addr + off:end]).decode("utf-8")


def _walk_group_btree(rd: _Reader, btree_addr: int, heap_addr: int,
                      out: dict, ctx: str) -> None:
    buf = rd.buf
    if buf[btree_addr:btree_addr + 4] != b"TREE":
        raise ValueError(f"{ctx}: bad group B-tree signature")
    level = buf[btree_addr + 5]
    nent = rd.u(btree_addr + 6, 2)
    pos = btree_addr + 8 + 2 * rd.osz  # skip left/right siblings
    pos += rd.lsz  # key 0
    for _ in range(nent):
        child = rd.off(pos)
        pos += rd.osz + rd.lsz  # child + next key
        if level > 0:
            _walk_group_btree(rd, child, heap_addr, out, ctx)
        else:  # SNOD symbol node
            if buf[child:child + 4] != b"SNOD":
                raise ValueError(f"{ctx}: bad symbol node signature")
            nsyms = rd.u(child + 6, 2)
            p = child + 8
            for _ in range(nsyms):
                name_off = rd.ln(p)
                ohdr = rd.off(p + rd.lsz)
                out[_heap_name(rd, heap_addr, name_off, ctx)] = ohdr
                p += rd.lsz + rd.osz + 24  # entry: cache + scratch


def _group_children(rd: _Reader, msgs: list, ctx: str) -> dict:
    """name -> object header address for one group's links."""
    out: dict[str, int] = {}
    for mtype, d in msgs:
        if mtype == 0x0011:  # symbol table (old-style group)
            btree = int.from_bytes(d[:rd.osz], "little")
            heap = int.from_bytes(d[rd.osz:2 * rd.osz], "little")
            _walk_group_btree(rd, btree, heap, out, ctx)
        elif mtype == 0x0006:  # link message (compact new-style)
            flags = d[1]
            pos = 2
            ltype = 0
            if flags & 0x08:
                ltype = d[pos]
                pos += 1
            if flags & 0x04:
                pos += 8  # creation order
            if flags & 0x10:
                pos += 1  # charset
            nlen = int.from_bytes(d[pos:pos + (1 << (flags & 3))],
                                  "little")
            pos += 1 << (flags & 3)
            name = d[pos:pos + nlen].decode("utf-8")
            pos += nlen
            if ltype == 0:  # hard link
                out[name] = int.from_bytes(d[pos:pos + rd.osz],
                                           "little")
        elif mtype == 0x0002 and len(d) >= 2 and d[1] & 0x02:
            # Link Info with a fractal-heap address set and no compact
            # links seen -> dense link storage
            raise NotImplementedError(
                f"{ctx}: dense (fractal-heap) group link storage — "
                "this file has more links than compact storage holds"
            )
    return out


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _walk_chunk_btree(rd: _Reader, addr: int, noffs: int, out: list,
                      ctx: str) -> None:
    """``noffs`` = ndim + 1 (the key carries one offset per dataset
    dimension plus the trailing element-size-dimension 0)."""
    buf = rd.buf
    if addr == _UNDEF:
        return
    if buf[addr:addr + 4] != b"TREE":
        raise ValueError(f"{ctx}: bad chunk B-tree signature")
    if buf[addr + 4] != 1:
        raise ValueError(f"{ctx}: chunk B-tree node type {buf[addr+4]}")
    level = buf[addr + 5]
    nent = rd.u(addr + 6, 2)
    keysize = 8 + 8 * noffs
    pos = addr + 8 + 2 * rd.osz
    for _ in range(nent):
        nbytes = rd.u(pos, 4)
        fmask = rd.u(pos + 4, 4)
        offs = tuple(rd.u(pos + 8 + 8 * i, 8) for i in range(noffs - 1))
        child = rd.off(pos + keysize)
        if level > 0:
            _walk_chunk_btree(rd, child, noffs, out, ctx)
        else:
            out.append((offs, child, nbytes, fmask))
        pos += keysize + rd.osz


_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32015: "zstd"}


def _defilter(raw: bytes, filters: list, itemsize: int, fmask: int,
              ctx: str) -> bytes:
    # pipeline applies in reverse on read; bit i of fmask skips filter i
    for i in range(len(filters) - 1, -1, -1):
        fid, vals = filters[i]
        if fmask & (1 << i):
            continue
        if fid == 1:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                raise ValueError(
                    f"{ctx}: corrupt gzip chunk ({e})") from e
        elif fid == 2:  # shuffle: de-interleave byte planes
            n = vals[0] if vals else itemsize
            if n > 1 and len(raw) % n == 0:
                arr = np.frombuffer(raw, np.uint8)
                raw = (arr.reshape(n, len(raw) // n).T).tobytes()
        elif fid == 3:  # fletcher32: 4-byte checksum suffix (unverified)
            raw = raw[:-4]
        else:
            raise NotImplementedError(
                f"{ctx}: filter {_FILTER_NAMES.get(fid, fid)} — only "
                "gzip/shuffle/fletcher32 pipelines are supported"
            )
    return raw


class H5Dataset:
    """One dataset: shape/dtype up front, lazy whole reads and lazy
    first-axis slab reads (chunked reads touch only the chunks that
    intersect the slab)."""

    def __init__(self, rd: _Reader, name: str, msgs: list, ctx: str):
        self._rd = rd
        self.name = name
        self._ctx = f"{ctx}:{name}"
        self.shape: tuple[int, ...] = ()
        self._dtmsg: bytes | None = None
        self._dtype: np.dtype | None = None
        self._layout = None
        self._filters: list = []
        for mtype, d in msgs:
            if mtype == 0x0001:
                self.shape = _parse_dataspace(d, rd, self._ctx)
                if int(np.prod(self.shape, dtype=np.float64)) > (1 << 33):
                    raise ValueError(
                        f"{self._ctx}: dataspace declares shape "
                        f"{self.shape} (> 2^33 elements) — refusing "
                        "the allocation (corrupt header?)"
                    )
            elif mtype == 0x0003:
                self._dtmsg = d
            elif mtype == 0x000B:
                self._filters = _parse_filters(d, self._ctx)
            elif mtype == 0x0008:
                self._layout = d
        if self._layout is None:
            raise ValueError(f"{self._ctx}: dataset has no layout")

    @property
    def dtype(self) -> np.dtype:
        """Parsed LAZILY so an unsupported sibling dataset (string,
        compound, ...) never blocks reading the volume next to it —
        the refusal fires only when THIS dataset is read."""
        if self._dtype is None:
            if self._dtmsg is None:
                raise ValueError(f"{self._ctx}: dataset has no datatype")
            self._dtype = _parse_datatype(self._dtmsg, self._ctx)
        return self._dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _layout_parsed(self):
        d = self._rd
        lay = self._layout
        ver = lay[0]
        if ver == 4:
            return self._layout_v4(lay)
        if ver != 3:
            raise NotImplementedError(
                f"{self._ctx}: data layout version {ver} — files from "
                "default-libver writers use v3 (re-save, or install "
                "netCDF4/h5py)"
            )
        cls = lay[1]
        if cls == 0:  # compact
            size = int.from_bytes(lay[2:4], "little")
            return ("compact", lay[4:4 + size])
        if cls == 1:  # contiguous
            addr = int.from_bytes(lay[2:2 + d.osz], "little")
            size = int.from_bytes(lay[2 + d.osz:2 + d.osz + d.lsz],
                                  "little")
            return ("contiguous", addr, size)
        if cls == 2:  # chunked, v1 B-tree index
            rank = lay[2]  # = ndim + 1 (element-size dim)
            addr = int.from_bytes(lay[3:3 + d.osz], "little")
            dims = tuple(
                int.from_bytes(lay[3 + d.osz + 4 * i:
                                   3 + d.osz + 4 * i + 4], "little")
                for i in range(rank)
            )
            return ("chunked", addr, dims[:-1])
        raise ValueError(f"{self._ctx}: unknown layout class {cls}")

    def _layout_v4(self, lay: bytes):
        """Data layout v4 (libver='latest' writers): compact and
        contiguous share v3's fields; chunked carries a chunk-index
        type — single-chunk (1) and implicit (2) are readable, the
        fixed/extensible-array and v2-B-tree indexes (3/4/5) are
        refused by name (default-libver files never use v4)."""
        d = self._rd
        cls = lay[1]
        if cls == 0:
            size = int.from_bytes(lay[2:4], "little")
            return ("compact", lay[4:4 + size])
        if cls == 1:
            addr = int.from_bytes(lay[2:2 + d.osz], "little")
            size = int.from_bytes(lay[2 + d.osz:2 + d.osz + d.lsz],
                                  "little")
            return ("contiguous", addr, size)
        if cls != 2:
            raise ValueError(f"{self._ctx}: unknown layout class {cls}")
        flags = lay[2]
        rank = lay[3]
        enc = lay[4]
        pos = 5
        dims = tuple(int.from_bytes(lay[pos + enc * i:
                                        pos + enc * (i + 1)], "little")
                     for i in range(rank))
        pos += enc * rank
        itype = lay[pos]
        pos += 1
        if itype == 1:  # single chunk
            nbytes = fmask = None
            if flags & 0x02:  # filtered single chunk
                nbytes = int.from_bytes(lay[pos:pos + d.lsz], "little")
                fmask = int.from_bytes(
                    lay[pos + d.lsz:pos + d.lsz + 4], "little")
                pos += d.lsz + 4
            addr = int.from_bytes(lay[pos:pos + d.osz], "little")
            return ("chunked4-single", addr, dims[:-1], nbytes,
                    fmask or 0)
        if itype == 2:  # implicit: unfiltered chunks, row-major dense
            addr = int.from_bytes(lay[pos:pos + d.osz], "little")
            return ("chunked4-implicit", addr, dims[:-1])
        if itype == 3:  # fixed array (libver='latest' h5py default)
            pos += 1  # page bits
            addr = int.from_bytes(lay[pos:pos + d.osz], "little")
            return ("chunked4-fixedarray", addr, dims[:-1],
                    bool(flags & 0x02))
        names = {4: "extensible array", 5: "v2 B-tree"}
        raise NotImplementedError(
            f"{self._ctx}: layout-v4 chunk index "
            f"{names.get(itype, itype)} — re-save without "
            "libver='latest' (default-libver files use the v1 B-tree "
            "index this reader supports)"
        )

    def _fixed_array_chunks(self, fa_addr: int, cdims, filtered: bool):
        """Unpaged Fixed Array chunk index ('FAHD' header + 'FADB'
        data block): one element per grid chunk in row-major order —
        address (+ size and filter mask when the pipeline filters)."""
        rd, buf = self._rd, self._rd.buf
        shape, it = self.shape, self.dtype.itemsize
        if buf[fa_addr:fa_addr + 4] != b"FAHD":
            raise ValueError(f"{self._ctx}: bad Fixed Array header")
        # client id 1 = filtered elements (address + size + mask);
        # it, not the layout flags, is authoritative
        filtered = buf[fa_addr + 5] == 1
        entsize = buf[fa_addr + 6]
        page_bits = buf[fa_addr + 7]
        nent = rd.ln(fa_addr + 8)
        dblk = rd.off(fa_addr + 8 + rd.lsz)
        if nent > (1 << page_bits):
            raise NotImplementedError(
                f"{self._ctx}: paged Fixed Array chunk index "
                f"({nent} entries > {1 << page_bits}/page)"
            )
        if buf[dblk:dblk + 4] != b"FADB":
            raise ValueError(f"{self._ctx}: bad Fixed Array data block")
        pos = dblk + 6 + rd.osz  # sig + version + client id + header
        grid = [-(-shape[i] // cdims[i]) for i in range(len(shape))]
        csz = int(np.prod(cdims)) * it
        chunks = []
        for lin in range(nent):
            e = pos + lin * entsize
            caddr = rd.off(e)
            if filtered:
                szlen = entsize - rd.osz - 4
                nbytes = rd.u(e + rd.osz, szlen)
                fmask = rd.u(e + rd.osz + szlen, 4)
            else:
                nbytes, fmask = csz, 0
            if caddr == _UNDEF:
                continue
            idx, rem = [], lin
            for g in reversed(grid):
                idx.append(rem % g)
                rem //= g
            idx = idx[::-1]
            chunks.append((
                tuple(idx[i] * cdims[i] for i in range(len(shape))),
                caddr, nbytes, fmask))
        return chunks

    def _chunk_map(self, addr: int, rank: int):
        out: list = []
        _walk_chunk_btree(self._rd, addr, rank + 1, out, self._ctx)
        return out

    def read_slab(self, z0: int = 0, z1: int | None = None,
                  out: np.ndarray | None = None) -> np.ndarray:
        """Read ``[z0:z1]`` along the first axis (the whole array for a
        0-/1-D dataset when defaulted); into ``out`` (an array of the
        slab's shape, any byte order) when given, with no other copy of
        the slab, else into a new array of the dataset's dtype."""
        shape = self.shape
        if z1 is None:
            z1 = shape[0] if shape else 1
        z1 = min(z1, shape[0]) if shape else 1
        nz = max(z1 - z0, 0)
        oshape = (nz,) + shape[1:] if shape else ()
        if out is None:
            out = np.empty(oshape, self.dtype)
        elif out.shape != oshape:
            raise ValueError(f"out has shape {out.shape}, the slab {oshape}")
        kind = self._layout_parsed()
        it = self.dtype.itemsize
        if kind[0] == "compact":
            arr = np.frombuffer(kind[1], self.dtype).reshape(shape)
            np.copyto(out, arr[z0:z1] if shape else arr)
            return out
        if kind[0] == "contiguous":
            _tag, addr, size = kind
            if addr == _UNDEF:  # never written: fill value (zeros)
                out[...] = 0
                return out
            row = int(np.prod(shape[1:], dtype=np.int64)) * it if shape \
                else it
            # a view of the mapping, not a bytes copy of the slab
            raw = memoryview(self._rd.buf)[addr + z0 * row:addr + z1 * row]
            np.copyto(out, np.frombuffer(raw, self.dtype).reshape(oshape))
            return out
        tag, addr, cdims = kind[0], kind[1], kind[2]
        out[...] = 0
        if tag == "chunked":
            chunks = self._chunk_map(addr, len(shape))
        elif tag == "chunked4-fixedarray":
            chunks = self._fixed_array_chunks(addr, cdims, kind[3])
        elif tag == "chunked4-single":
            nbytes = kind[3] or int(np.prod(cdims)) * it
            chunks = [((0,) * len(shape), addr, nbytes, kind[4])]
        else:  # chunked4-implicit: dense row-major unfiltered grid
            grid = [-(-shape[i] // cdims[i]) for i in range(len(shape))]
            csz = int(np.prod(cdims)) * it
            chunks = []
            for lin in range(int(np.prod(grid))):
                idx, rem = [], lin
                for g in reversed(grid):
                    idx.append(rem % g)
                    rem //= g
                idx = idx[::-1]
                chunks.append((
                    tuple(idx[i] * cdims[i] for i in range(len(shape))),
                    addr + lin * csz, csz, 0))
        for offs, caddr, nbytes, fmask in chunks:
            if offs[0] >= z1 or offs[0] + cdims[0] <= z0:
                continue
            raw = _defilter(
                self._rd.buf[caddr:caddr + nbytes], self._filters, it,
                fmask, self._ctx)
            chunk = np.frombuffer(raw, self.dtype)
            chunk = chunk[:int(np.prod(cdims))].reshape(cdims)
            src = [slice(0, min(cdims[i], shape[i] - offs[i]))
                   for i in range(len(shape))]
            dst = [slice(offs[i], offs[i] + src[i].stop)
                   for i in range(len(shape))]
            # clip the slab window on axis 0
            lo = max(z0, offs[0])
            hi = min(z1, offs[0] + src[0].stop)
            src[0] = slice(lo - offs[0], hi - offs[0])
            dst[0] = slice(lo - z0, hi - z0)
            out[tuple(dst)] = chunk[tuple(src)]
        return out

    def read(self) -> np.ndarray:
        return self.read_slab(0, self.shape[0] if self.shape else None)


class H5File:
    """Read-only HDF5 file: root group's datasets by name (one level of
    subgroups is followed — netCDF-4 groups nest variables)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        ctx = str(path)
        # mmap, not read_bytes: open_volume_slabs' O(slab) host-memory
        # contract must hold for multi-GB NetCDF-4 volumes too — only
        # the touched pages (headers + the chunks a slab intersects)
        # become resident
        import mmap

        fobj = open(self.path, "rb")
        try:
            buf = mmap.mmap(fobj.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file etc.
            buf = fobj.read()
        if buf[:8] != _SIG:
            raise ValueError(f"{ctx}: not an HDF5 file (signature)")
        ver = buf[8]
        if ver == 0:
            osz, lsz = buf[13], buf[14]
            rd = _Reader(buf, osz, lsz, ctx, fobj)
            # v0 fields end at 24 + 4*O (four addresses: base,
            # free space, end of file, the file-layer block); the root group SYMBOL TABLE ENTRY follows:
            # link name offset (O), then the object header address
            root = rd.off(24 + 4 * osz + osz)
        elif ver in (2, 3):
            osz, lsz = buf[9], buf[10]
            rd = _Reader(buf, osz, lsz, ctx, fobj)
            root = rd.off(12 + 3 * osz)
        else:
            raise NotImplementedError(
                f"{ctx}: superblock version {ver} (v0/v2/v3 supported)")
        self._rd = rd
        self.datasets: dict[str, H5Dataset] = {}
        self._collect(root, "", ctx, depth=0)

    def _collect(self, ohdr: int, prefix: str, ctx: str, depth: int):
        msgs = _object_messages(self._rd, ohdr, ctx)
        types = {m for m, _ in msgs}
        if 0x0008 in types and 0x0001 in types:  # layout + dataspace
            name = prefix.rstrip("/") or "/"
            self.datasets[name] = H5Dataset(
                self._rd, name, msgs, ctx)
            return
        if depth > 2:
            return
        for name, addr in _group_children(self._rd, msgs, ctx).items():
            self._collect(addr, f"{prefix}{name}/", ctx, depth + 1)


def read_hdf5_volume(
    path: str | Path, var_name: str | None = None
) -> tuple[np.ndarray, str]:
    """First 3-D dataset (or ``var_name``) as a native-endian array —
    the netCDF4.Dataset fallback io/volume.py uses.  Truncated or
    garbled files surface as ValueError (fuzz contract), never a raw
    mmap IndexError."""
    try:
        return _read_hdf5_volume(path, var_name)
    except IndexError as e:
        raise ValueError(
            f"{path}: truncated or corrupt HDF5 file") from e


def _read_hdf5_volume(
    path: str | Path, var_name: str | None = None
) -> tuple[np.ndarray, str]:
    f = H5File(path)
    if var_name is None:
        var_name = next(
            (n for n, d in f.datasets.items() if d.ndim == 3), None)
        if var_name is None:
            raise ValueError(f"no 3-D variable found in {path}")
    if var_name not in f.datasets:
        raise KeyError(
            f"{path}: no dataset {var_name!r} (has: "
            f"{sorted(f.datasets)})")
    vol = f.datasets[var_name].read()
    return np.ascontiguousarray(
        vol.astype(vol.dtype.newbyteorder("="))), var_name
