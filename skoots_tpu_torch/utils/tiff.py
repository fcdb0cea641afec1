"""TIFF stacks read and written with numpy and zlib, without Pillow.

The port's own codec behind ``utils/io.py``; the JAX package reads and
writes TIFF through Pillow (``skoots_tpu/utils/io.py``), which the card's
machine does not have.

Reading (:func:`read_pages`) covers what users' stacks hold: classic TIFF
in either byte order and BigTIFF; a chain of pages (IFDs) in strips or
tiles; no compression, PackBits, LZW or Deflate (codes 1, 32773, 5, 8 and
32946), with or without the horizontal predictor (2); 1, 8, 16, 32 and 64
bits a sample, unsigned, signed or float; one or more samples a pixel
(chunky). LZW and PackBits decode in host C++ (``csrc/host/tiff_codec.cpp``,
built by ``g++`` at first use), Deflate in :mod:`zlib`, the predictor and
the layout in numpy. Each page comes back as Pillow's ``np.asarray`` of it
would, so the port's ``imread`` equals the JAX package's: 1 bit -> bool
(inverted for WhiteIsZero), 8 bits -> uint8 (signed bytes as their raw
bytes, WhiteIsZero inverted), 16 bits -> uint16 or int32 (signed), 32 bits
-> int32 or float32, several samples -> ``[rows, cols, channels]`` with
Pillow's channels (uint8, 16-bit colour samples to their high byte, unused
extra samples dropped). 64-bit and half-float samples, which Pillow cannot
open, come back in their own dtype. A tag value the reader cannot read
raises ``ValueError`` naming the tag.

Writing (:func:`write_pages`): a ``[Z, rows, cols]`` stack, one page per
Z, in strips (or tiles), Deflate or none, with an optional predictor, in
either byte order, classic or BigTIFF. :func:`pillow_dtype` gives the
sample type Pillow's ``Image.fromarray`` writes for a numpy dtype (bool as
1-bit pages, int8 / int16 / uint32 / 64-bit integers as int32, float64 as
float32), which ``imsave`` applies before writing, so a file read back
through Pillow equals one the JAX package wrote.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Iterable, List, Optional, Tuple

import numpy as np

from skoots_tpu_torch.utils import host_lib

TAG_NAMES = {
    254: "NewSubfileType", 256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample",
    259: "Compression", 262: "PhotometricInterpretation", 266: "FillOrder",
    273: "StripOffsets", 277: "SamplesPerPixel", 278: "RowsPerStrip",
    279: "StripByteCounts", 284: "PlanarConfiguration", 317: "Predictor",
    322: "TileWidth", 323: "TileLength", 324: "TileOffsets", 325: "TileByteCounts",
    338: "ExtraSamples", 339: "SampleFormat",
}
NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS = 1, 5, 8, 32946, 32773
COMPRESSIONS = {NONE: "none", LZW: "LZW", DEFLATE: "Deflate", DEFLATE_OLD: "Deflate",
                PACKBITS: "PackBits"}

# IFD field type -> (numpy kind, values an item)
_FIELDS = {1: ("u1", 1), 2: ("u1", 1), 3: ("u2", 1), 4: ("u4", 1), 5: ("u4", 2),
           6: ("i1", 1), 7: ("u1", 1), 8: ("i2", 1), 9: ("i4", 1), 10: ("i4", 2),
           11: ("f4", 1), 12: ("f8", 1), 13: ("u4", 1), 16: ("u8", 1), 17: ("i8", 1),
           18: ("u8", 1)}
_SAMPLE_KINDS = {1: "u", 2: "i", 3: "f"}
# colour channels of each PhotometricInterpretation Pillow opens
_COLOUR_CHANNELS = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 1, 8: 3}


def _unsupported(tag: int, value) -> ValueError:
    return ValueError(f"TIFF {TAG_NAMES.get(tag, 'tag')} ({tag}) = {value} is not supported")


@functools.lru_cache(maxsize=None)
def _codec() -> ctypes.CDLL:
    lib = host_lib.library("tiff_codec")
    for fn in (lib.tiff_lzw_decode, lib.tiff_packbits_decode):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return lib


def _decompress(code: int, data: np.ndarray, nbytes: int) -> np.ndarray:
    """The first ``nbytes`` decoded bytes of one strip or tile (uint8)."""
    if code == NONE:
        raw = data
    elif code in (DEFLATE, DEFLATE_OLD):
        raw = np.frombuffer(zlib.decompressobj().decompress(data, nbytes), np.uint8)
    else:
        src = np.ascontiguousarray(data)
        raw = np.empty(nbytes, np.uint8)
        fn = _codec().tiff_lzw_decode if code == LZW else _codec().tiff_packbits_decode
        n = fn(src.ctypes.data, src.size, raw.ctypes.data, nbytes)
        if n == -2:
            raise _unsupported(259, "5 (the old LSB-first LZW)")
        if n < 0:
            raise ValueError("TIFF LZW data holds a code outside its dictionary")
        raw = raw[:n]
    if raw.size < nbytes:
        raise ValueError(f"a TIFF {COMPRESSIONS[code]} chunk decodes to {raw.size} of "
                         f"{nbytes} bytes")
    return raw[:nbytes]


def _ifds(buf: np.ndarray) -> Iterable[Tuple[str, dict]]:
    """(byte order, {tag: values}) of each page in the IFD chain."""
    head = bytes(buf[:16])
    bo = {b"II": "<", b"MM": ">"}.get(head[:2])
    if bo is None or len(head) < 8:
        raise ValueError("not a TIFF file (no II / MM byte-order mark)")
    magic = struct.unpack(bo + "H", head[2:4])[0]
    if magic == 42:
        big, off = False, struct.unpack(bo + "I", head[4:8])[0]
    elif magic == 43:
        if struct.unpack(bo + "HH", head[4:8]) != (8, 0):
            raise ValueError("BigTIFF header with an offset size other than 8")
        big, off = True, struct.unpack(bo + "Q", head[8:16])[0]
    else:
        raise ValueError(f"not a TIFF file (version {magic})")
    count_fmt, entry, word = ("Q", 20, "Q") if big else ("H", 12, "I")
    head_size, inline = (8, 8) if big else (2, 4)
    seen = set()
    while off:
        if off in seen or off + head_size > buf.size:
            raise ValueError(f"bad TIFF IFD offset {off}")
        seen.add(off)
        n = struct.unpack(bo + count_fmt, bytes(buf[off:off + head_size]))[0]
        block = bytes(buf[off + head_size:off + head_size + n * entry + inline])
        tags = {}
        for i in range(n):
            e = block[i * entry:(i + 1) * entry]
            tag, typ = struct.unpack(bo + "HH", e[:4])
            if typ not in _FIELDS:  # unknown field types are skipped (TIFF 6.0 s. 2)
                continue
            count = struct.unpack(bo + word, e[4:4 + inline])[0]
            kind, per = _FIELDS[typ]
            dt = np.dtype(bo + kind)
            nvals = count * per
            value = e[4 + inline:]
            if dt.itemsize * nvals <= inline:
                vals = np.frombuffer(value, dt, nvals)
            else:
                at = struct.unpack(bo + word, value)[0]
                vals = np.frombuffer(buf, dt, nvals, at)
            tags[tag] = vals.astype(dt.newbyteorder("="))
        yield bo, tags
        off = struct.unpack(bo + word, block[n * entry:n * entry + inline])[0]


def _sample_dtype(bits: int, fmt: int, bo: str) -> np.dtype:
    kind = _SAMPLE_KINDS.get(fmt)
    if kind is None:
        raise _unsupported(339, fmt)
    if bits not in (8, 16, 32, 64) or (kind == "f" and bits == 8):
        raise _unsupported(258, bits)
    return np.dtype(f"{bo}{kind}{bits // 8}")


def _page(buf: np.ndarray, bo: str, tags: dict) -> np.ndarray:
    """One page as Pillow's ``np.asarray`` gives it (module docstring)."""
    def get(tag, default=None):
        if tag in tags:
            return tags[tag]
        if default is None:
            raise ValueError(f"TIFF page lacks {TAG_NAMES[tag]} ({tag})")
        return np.asarray(default)

    def one(tag, default=None) -> int:
        vals = set(get(tag, default).tolist())
        if len(vals) != 1:
            raise _unsupported(tag, sorted(vals))
        return int(vals.pop())

    width, height, spp = one(256), one(257), one(277, [1])
    bits, fmt, code = one(258, [1]), one(339, [1]), one(259, [1])
    photometric, predictor = one(262, [0]), one(317, [1])
    extras = tuple(get(338, []).tolist())
    if code not in COMPRESSIONS:
        raise _unsupported(259, code)
    if one(266, [1]) != 1:
        raise _unsupported(266, one(266))
    if spp > 1 and one(284, [1]) != 1:
        raise _unsupported(284, one(284))
    if predictor not in (1, 2) or (predictor == 2 and bits == 1):
        raise _unsupported(317, predictor)
    if photometric not in _COLOUR_CHANNELS:
        raise _unsupported(262, photometric)
    if 1 in extras:  # Pillow un-premultiplies associated alpha
        raise _unsupported(338, extras)
    if bits == 1:
        if spp != 1 or fmt != 1:
            raise _unsupported(258, f"1 with {spp} samples of format {fmt}")
        dt = None
        row_bytes = lambda w: (w + 7) // 8  # noqa: E731
    else:
        dt = _sample_dtype(bits, fmt, bo)
        row_bytes = lambda w: w * spp * dt.itemsize  # noqa: E731

    if 322 in tags:
        cw, ch = one(322), one(323)
        offsets, counts = get(324), get(325)
        across = -(-width // cw)
        origins = [((i // across) * ch, (i % across) * cw) for i in range(len(offsets))]
        shapes = [(ch, cw)] * len(offsets)
    else:
        rps = min(one(278, [2 ** 32 - 1]), height)
        offsets = get(273)
        counts = get(279) if 279 in tags else np.full(len(offsets), rps * row_bytes(width))
        origins = [(i * rps, 0) for i in range(len(offsets))]
        shapes = [(min(rps, height - r), width) for r, _ in origins]
    if len(counts) != len(offsets) or sum(r < height for r, _ in origins) != len(offsets):
        raise ValueError(f"TIFF page of {height}x{width}: {len(offsets)} chunks do not "
                         "tile it")

    out = np.zeros((height, width, spp), np.bool_ if dt is None else dt.newbyteorder("="))
    for (r0, c0), (rows, cols), off, n in zip(origins, shapes, offsets, counts):
        raw = _decompress(code, buf[int(off):int(off) + int(n)], rows * row_bytes(cols))
        if dt is None:
            chunk = np.unpackbits(raw.reshape(rows, -1), axis=1)[:, :cols, None] > 0
        else:
            chunk = raw.view(dt).reshape(rows, cols, spp)
            if predictor == 2:
                u = np.dtype(f"u{dt.itemsize}")
                chunk = np.cumsum(chunk.view(f"{bo}u{dt.itemsize}").astype(u), axis=1,
                                  dtype=u).view(out.dtype)
        r1, c1 = min(r0 + rows, height), min(c0 + cols, width)
        out[r0:r1, c0:c1] = chunk[:r1 - r0, :c1 - c0]
    return _as_pillow(out, bits, fmt, photometric, extras)


def _as_pillow(page: np.ndarray, bits: int, fmt: int, photometric: int,
               extras: tuple) -> np.ndarray:
    """A decoded ``[rows, cols, samples]`` page in the dtype and channels of
    Pillow's mode for it (``TiffImagePlugin.OPEN_INFO``)."""
    spp = page.shape[-1]
    if bits == 1:
        page = page if photometric != 0 else ~page
        return page[..., 0].astype(np.uint8) if photometric == 3 else page[..., 0]
    if spp == 1:
        p = page[..., 0]
        if bits == 8:
            p = p.view(np.uint8)
            return 255 - p if photometric == 0 else p
        if bits == 16 and fmt == 2:
            return p.astype(np.int32)
        if bits == 32 and fmt != 3:
            return p.view(np.int32)
        return p
    colours = _COLOUR_CHANNELS[photometric]
    alpha = int(spp > colours and (not extras or extras[0] in (2, 999)))
    page = page[..., :colours + alpha]
    if bits == 16 and photometric in (2, 5):  # Pillow's RGB;16 keeps the high byte
        page = (page >> 8).astype(np.uint8)
    elif bits == 8:
        page = page.view(np.uint8)
    return page if page.shape[-1] > 1 else page[..., 0]


def read_pages(path: str) -> List[np.ndarray]:
    """Every page of the TIFF file at ``path``, as Pillow's ``np.asarray``
    gives it (module docstring)."""
    buf = np.memmap(path, np.uint8, "r")
    try:
        return [_page(buf, bo, tags) for bo, tags in _ifds(buf)]
    finally:
        del buf


# ---------------------------------------------------------------- writing

def pillow_dtype(dtype) -> np.dtype:
    """The sample dtype Pillow's ``Image.fromarray`` writes for ``dtype``
    (bool is written as 1-bit pages)."""
    dt = np.dtype(dtype)
    if dt.kind == "b" or dt in (np.uint8, np.uint16, np.int32, np.float32):
        return dt.newbyteorder("=")
    if dt.kind in "iu":
        return np.dtype(np.int32)
    if dt == np.float64:
        return np.dtype(np.float32)
    raise TypeError(f"TIFF stacks of {dt} cannot be written (Pillow cannot either)")


def as_pillow_writes(vol: np.ndarray) -> np.ndarray:
    """``vol`` in :func:`pillow_dtype`, converted as Pillow converts it:
    signed bytes through their raw bytes, wider integers wrapping."""
    dt = pillow_dtype(vol.dtype)
    if vol.dtype == np.int8:
        vol = vol.view(np.uint8)
    return vol.astype(dt, copy=False)


_IFD_TYPES = {"H": 3, "I": 4, "Q": 16}
_SAMPLE_FORMATS = {"u": 1, "b": 1, "i": 2, "f": 3}


def _ifd_bytes(bo: str, big: bool, at: int, entries: List[Tuple[int, str, list]]
               ) -> Tuple[bytes, int]:
    """One IFD at file offset ``at``: (its bytes with out-of-line values after
    it, the offset of its next-IFD field). Entries are (tag, struct code,
    values), written in tag order."""
    word, inline, head = ("Q", 8, "Q") if big else ("I", 4, "H")
    n = len(entries)
    head_size = struct.calcsize(head)
    table = struct.pack(bo + head, n)
    tail = b""
    data_at = at + head_size + n * (4 + 2 * inline) + inline
    for tag, fmt, vals in sorted(entries):
        blob = struct.pack(f"{bo}{len(vals)}{fmt}", *vals)
        table += struct.pack(f"{bo}HH{word}", tag, _IFD_TYPES[fmt], len(vals))
        if len(blob) <= inline:
            table += blob.ljust(inline, b"\0")
        else:
            table += struct.pack(bo + word, data_at + len(tail))
            tail += blob + b"\0" * (len(blob) % 2)
    next_field = at + len(table)
    return table + b"\0" * inline + tail, next_field


def write_pages(path: str, pages: np.ndarray, *, compression: int = DEFLATE,
                predictor: int = 1, tile: Optional[Tuple[int, int]] = None,
                byteorder: str = "<", bigtiff: Optional[bool] = None) -> None:
    """Write ``pages`` ``[Z, rows, cols]`` (one dtype; bool as 1-bit) as a
    Z-page TIFF: compression 1 (none), 8 or 32946 (Deflate, zlib's default
    level 6, as libtiff's); ``predictor`` 2 differences each row of a chunk; ``tile``
    (rows, cols), multiples of 16, or strips of about 1 MiB; ``byteorder``
    ``"<"`` or ``">"``; BigTIFF when asked or when the stack may pass 4 GiB."""
    pages = np.asarray(pages)
    if pages.ndim != 3:
        raise ValueError(f"write_pages takes [Z, rows, cols], got {pages.shape}")
    if compression not in (NONE, DEFLATE, DEFLATE_OLD):
        raise ValueError(f"the writer compresses with none or Deflate, not {compression}")
    bit = pages.dtype.kind == "b"
    dt = None if bit else pages.dtype.newbyteorder(byteorder)
    if predictor == 2 and bit:
        raise ValueError("predictor 2 needs samples of 8 bits or more")
    z, height, width = pages.shape
    if bigtiff is None:
        bigtiff = pages.nbytes * 1.01 + (1 << 20) >= 2 ** 32
    bo = byteorder
    word = "Q" if bigtiff else "I"
    bits = 1 if bit else dt.itemsize * 8
    row_bytes = (lambda w: (w + 7) // 8) if bit else (lambda w: w * dt.itemsize)  # noqa: E731
    if tile is None:
        rps = max(1, min(height, (1 << 20) // max(1, row_bytes(width))))
        chunks = [(r, 0, min(rps, height - r), width) for r in range(0, height, rps)]
    else:
        th, tw = tile
        if th % 16 or tw % 16:
            raise ValueError(f"tile sides must be multiples of 16, got {tile}")
        chunks = [(r, c, th, tw) for r in range(0, height, th) for c in range(0, width, tw)]

    def encode(page, r, c, rows, cols):
        block = np.zeros((rows, cols), page.dtype)
        src = page[r:r + rows, c:c + cols]
        block[:src.shape[0], :src.shape[1]] = src
        if bit:
            raw = np.packbits(block, axis=1)
        else:
            if predictor == 2:
                u = block.view(f"u{dt.itemsize}")
                block = np.concatenate([u[:, :1], np.diff(u, axis=1)], axis=1).view(block.dtype)
            raw = block.astype(dt, copy=False)
        raw = np.ascontiguousarray(raw).tobytes()
        return raw if compression == NONE else zlib.compress(raw)

    with open(path, "wb") as f:
        if bigtiff:
            f.write(struct.pack(bo + "HHHHQ", 0x4949 if bo == "<" else 0x4D4D, 43, 8, 0, 0))
            link = 8
        else:
            f.write(struct.pack(bo + "HHI", 0x4949 if bo == "<" else 0x4D4D, 42, 0))
            link = 4
        for page in pages:
            offsets, counts = [], []
            for r, c, rows, cols in chunks:
                blob = encode(page, r, c, rows, cols)
                offsets.append(f.tell())
                counts.append(len(blob))
                f.write(blob)
            if f.tell() % 2:
                f.write(b"\0")
            entries = [
                (256, "I", [width]), (257, "I", [height]), (258, "H", [bits]),
                (259, "H", [compression]), (262, "H", [1]), (277, "H", [1]),
                (284, "H", [1]),
                (339, "H", [_SAMPLE_FORMATS[pages.dtype.kind]]),
            ]
            if predictor == 2:
                entries.append((317, "H", [2]))
            if tile is None:
                entries += [(273, word, offsets), (278, "I", [chunks[0][2]]),
                            (279, word, counts)]
            else:
                entries += [(322, "I", [tile[1]]), (323, "I", [tile[0]]),
                            (324, word, offsets), (325, word, counts)]
            at = f.tell()
            if not bigtiff and at + 64 * len(chunks) + 4096 >= 2 ** 32:
                raise ValueError("the stack passes 4 GiB: write it as BigTIFF")
            ifd, next_field = _ifd_bytes(bo, bigtiff, at, entries)
            f.write(ifd)
            f.seek(link)
            f.write(struct.pack(bo + word, at))
            f.seek(0, 2)
            link = next_field
