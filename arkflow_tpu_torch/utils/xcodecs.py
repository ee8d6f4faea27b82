"""Kafka record-batch compression codecs beyond gzip, in Python.

Counterpart of the Python paths of ``arkflow_tpu/utils/xcodecs.py``:

- **snappy** (codec 2): block decoder and a literal-only block encoder
  (legal snappy, unit ratio). On the wire both raw-block and xerial
  (snappy-java) streams are read, and xerial framing is written, which
  every client stack accepts.
- **lz4** (codec 3): the LZ4 *frame* format with xxHash32 header and
  content checksums; blocks decode in Python, and frames are written with
  stored (uncompressed) blocks, which is legal LZ4F.
- **zstd** (codec 4): the ``zstandard`` package, imported inside the call
  (the card's machine has none; the other codecs need no package).

The JAX package's C++ tier is not ported, so the bytes this module writes
are those of the JAX package's Python tier.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------------
# xxHash32 (LZ4 frame checksums)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_P1, _P2, _P3, _P4, _P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _py_xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        while i + 16 <= n:
            w1, w2, w3, w4 = struct.unpack_from("<4I", data, i)
            v1 = (_rotl((v1 + w1 * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + w2 * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + w3 * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + w4 * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (w,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + w * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


def xxh32(data: bytes, seed: int = 0) -> int:
    return _py_xxh32(data, seed)


# ---------------------------------------------------------------------------
# snappy block codec
# ---------------------------------------------------------------------------


def _snappy_uncompressed_len(src: bytes) -> tuple[int, int]:
    """(uncompressed_len, preamble_bytes) from the varint preamble."""
    ulen = 0
    shift = 0
    for i, b in enumerate(src):
        ulen |= (b & 0x7F) << shift
        if not (b & 0x80):
            return ulen, i + 1
        shift += 7
        if shift > 35:
            break
    raise ValueError("snappy: bad length preamble")


def _py_snappy_decompress(src: bytes) -> bytes:
    ulen, i = _snappy_uncompressed_len(src)
    out = bytearray()
    n = len(src)
    while i < n:
        tag = src[i]
        i += 1
        t = tag & 3
        if t == 0:
            ln = (tag >> 2) + 1
            if ln > 60:
                nb = ln - 60
                ln = int.from_bytes(src[i:i + nb], "little") + 1
                i += nb
            if n - i < ln:
                raise ValueError("snappy: truncated literal")
            out += src[i:i + ln]
            i += ln
        else:
            if t == 1:
                ln = 4 + ((tag >> 2) & 7)
                off = ((tag >> 5) << 8) | src[i]
                i += 1
            elif t == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(src[i:i + 2], "little")
                i += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(src[i:i + 4], "little")
                i += 4
            if off == 0 or off > len(out):
                raise ValueError("snappy: bad copy offset")
            for _ in range(ln):  # byte-wise: offsets may overlap the output
                out.append(out[-off])
    if len(out) != ulen:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


def _py_snappy_compress(src: bytes) -> bytes:
    """Literal-only snappy (legal stream, unit ratio)."""
    out = bytearray()
    v = len(src)
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            break
    i = 0
    while i < len(src) or (i == 0 and not src):
        chunk = min(len(src) - i, 1 << 16)
        if chunk <= 0:
            break
        if chunk <= 60:
            out.append((chunk - 1) << 2)
        else:
            enc = (chunk - 1).to_bytes(4, "little").rstrip(b"\x00") or b"\x00"
            out.append((59 + len(enc)) << 2)
            out += enc
        out += src[i:i + chunk]
        i += chunk
    return bytes(out)


def snappy_block_decompress(src: bytes) -> bytes:
    ulen, _ = _snappy_uncompressed_len(src)
    if ulen > 1 << 30:
        raise ValueError("snappy: implausible uncompressed length")
    return _py_snappy_decompress(src)


def snappy_block_compress(src: bytes) -> bytes:
    return _py_snappy_compress(src)


_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def snappy_decode(data: bytes) -> bytes:
    """Kafka codec 2 payload -> bytes. Handles xerial (snappy-java) streams
    and raw snappy blocks, like librdkafka's reader."""
    if data.startswith(_XERIAL_MAGIC):
        i = 16  # magic(8) + version(4) + compatible(4)
        out = bytearray()
        while i < len(data):
            if len(data) - i < 4:
                raise ValueError("snappy-java: truncated chunk header")
            (clen,) = struct.unpack_from(">i", data, i)
            i += 4
            if clen < 0 or len(data) - i < clen:
                raise ValueError("snappy-java: truncated chunk")
            out += snappy_block_decompress(data[i:i + clen])
            i += clen
        return bytes(out)
    return snappy_block_decompress(data)


def snappy_encode(data: bytes) -> bytes:
    """bytes -> xerial-framed snappy (what snappy-java consumers require and
    every other client detects)."""
    out = bytearray(_XERIAL_MAGIC)
    out += struct.pack(">ii", 1, 1)
    i = 0
    block = 32 * 1024  # xerial default block size
    while i < len(data) or i == 0:
        chunk = data[i:i + block]
        comp = snappy_block_compress(chunk)
        out += struct.pack(">i", len(comp))
        out += comp
        i += block
        if i >= len(data):
            break
    return bytes(out)


# ---------------------------------------------------------------------------
# LZ4 frame format (magic, FLG/BD, xxh32 checksums, block stream)
# ---------------------------------------------------------------------------

_LZ4_MAGIC = 0x184D2204
_BD_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def _py_lz4_decompress_block(src: bytes, max_out: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[i]
                i += 1
                litlen += b
                if b != 255:
                    break
        if n - i < litlen or len(out) + litlen > max_out:
            raise ValueError("lz4: truncated literals")
        out += src[i:i + litlen]
        i += litlen
        if i >= n:
            break
        if n - i < 2:
            raise ValueError("lz4: truncated offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0 or off > len(out):
            raise ValueError("lz4: bad match offset")
        mlen = token & 15
        if mlen == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        if len(out) + mlen > max_out:
            raise ValueError("lz4: output overflow")
        for _ in range(mlen):
            out.append(out[-off])
    return bytes(out)


def lz4_frame_decode(data: bytes) -> bytes:
    if len(data) < 7 or struct.unpack_from("<I", data)[0] != _LZ4_MAGIC:
        raise ValueError("lz4: bad frame magic")
    i = 4
    flg, bd = data[i], data[i + 1]
    i += 2
    if (flg >> 6) != 1:
        raise ValueError(f"lz4: unsupported frame version {flg >> 6}")
    has_bchk = bool(flg & 0x10)
    has_csize = bool(flg & 0x08)
    has_cchk = bool(flg & 0x04)
    if flg & 0x01:
        raise ValueError("lz4: dictionaries not supported")
    if has_csize:
        i += 8
    bmax = _BD_SIZES.get((bd >> 4) & 7)
    if bmax is None:
        raise ValueError("lz4: bad block-size code")
    hc = data[i]
    i += 1
    # header checksum covers FLG..last header byte (excluding magic and HC)
    expect = (xxh32(data[4:i - 1], 0) >> 8) & 0xFF
    if hc != expect:
        raise ValueError("lz4: header checksum mismatch")
    out = bytearray()
    while True:
        if len(data) - i < 4:
            raise ValueError("lz4: truncated block header")
        (bsz,) = struct.unpack_from("<I", data, i)
        i += 4
        if bsz == 0:
            break  # EndMark
        stored = bool(bsz & 0x80000000)
        bsz &= 0x7FFFFFFF
        if len(data) - i < bsz:
            raise ValueError("lz4: truncated block")
        blk = data[i:i + bsz]
        i += bsz
        if has_bchk:
            if len(data) - i < 4:
                raise ValueError("lz4: truncated block checksum")
            (bchk,) = struct.unpack_from("<I", data, i)
            i += 4
            if bchk != xxh32(blk, 0):
                raise ValueError("lz4: block checksum mismatch")
        if stored:
            out += blk
        else:
            out += _py_lz4_decompress_block(blk, bmax)
    if has_cchk:
        if len(data) - i < 4:
            raise ValueError("lz4: missing content checksum")
        (cchk,) = struct.unpack_from("<I", data, i)
        if cchk != xxh32(bytes(out), 0):
            raise ValueError("lz4: content checksum mismatch")
    return bytes(out)


def lz4_frame_encode(data: bytes) -> bytes:
    """bytes -> LZ4 frame (64KB independent blocks, content checksum), every
    block stored uncompressed (legal LZ4F, unit ratio)."""
    out = bytearray(struct.pack("<I", _LZ4_MAGIC))
    flg = (1 << 6) | 0x20 | 0x04  # version 1, block-independent, content chk
    bd = 4 << 4  # 64KB max block
    out.append(flg)
    out.append(bd)
    out.append((xxh32(bytes([flg, bd]), 0) >> 8) & 0xFF)
    block = 1 << 16
    for i in range(0, len(data) or 1, block):
        chunk = data[i:i + block]
        out += struct.pack("<I", len(chunk) | 0x80000000)
        out += chunk
    out += struct.pack("<I", 0)  # EndMark
    out += struct.pack("<I", xxh32(data, 0))
    return bytes(out)


# ---------------------------------------------------------------------------
# zstd (the ``zstandard`` package, imported at the call)
# ---------------------------------------------------------------------------


def zstd_encode(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor().compress(data)


def zstd_decode(data: bytes) -> bytes:
    import zstandard

    # decompressobj, not decompress(): streaming producers (Java zstd-jni's
    # ZstdOutputStream, python stream_writer) emit frames WITHOUT the
    # content-size header field, which one-shot decompress() refuses with
    # "could not determine content size in frame header"
    out = bytearray()
    view = data
    while view:  # concatenated frames decode back-to-back
        dec = zstandard.ZstdDecompressor().decompressobj()
        out += dec.decompress(view)
        leftover = dec.unused_data
        if not leftover or leftover == view:
            break
        view = leftover
    return bytes(out)
