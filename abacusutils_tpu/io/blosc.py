"""Blosc1 chunk codec, implemented from the container format spec.

AbacusSummit data products store each ASDF binary block as a stream of
independently-compressed Blosc chunks, each prefixed with a 4-byte big-endian
length (matching the framing of the reference's ASDF extension,
cf. /root/reference/abacusnbody/data/asdf.py:36-94). Each chunk is a standard
c-blosc1 container:

    byte 0    : format version
    byte 1    : codec format version
    byte 2    : flags (bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
                bit4 dont_split, bits5-7 codec format id)
    byte 3    : typesize
    bytes 4-7 : nbytes   (uncompressed chunk size, LE uint32)
    bytes 8-11: blocksize (LE uint32)
    bytes12-15: cbytes   (total compressed chunk size incl. header, LE uint32)

If not memcpyed, the header is followed by ``nblocks`` LE uint32 offsets (from
chunk start) to each compressed block. Each block holds ``nstreams`` streams
(``typesize`` streams if split, else 1), each prefixed by an LE int32
compressed length; a stream whose compressed length equals its uncompressed
length is stored raw, and a zero length means an all-zero stream. Byte-shuffle
is applied per block over the largest multiple of ``typesize``.

This module only needs the zstd codec (format id 4), which is what Abacus
uses; blosclz/lz4 chunks raise an error.

Compression here always writes zstd + byte-shuffle + dont_split chunks, which
modern c-blosc decompresses fine (it honors the flag bits).
"""

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ['decompress_chunk', 'compress_chunk', 'ChunkedBloscDecoder']

# blosc1 flag bits
_DOSHUFFLE = 0x1
_MEMCPYED = 0x2
_DOBITSHUFFLE = 0x4
_DONT_SPLIT = 0x10

# blosc1 "format" ids stored in flag bits 5-7
_FMT_BLOSCLZ = 0
_FMT_LZ4 = 1
_FMT_SNAPPY = 2
_FMT_ZLIB = 3
_FMT_ZSTD = 4

_MAX_TYPESIZE = 255

# ZstdDecompressor contexts are not thread-safe; keep one per thread
_tls = __import__('threading').local()


class _ZstdProxy:
    def decompress(self, *args, **kwargs):
        d = getattr(_tls, 'zd', None)
        if d is None:
            import zstandard

            d = _tls.zd = zstandard.ZstdDecompressor()
        return d.decompress(*args, **kwargs)


_zstd_d = _ZstdProxy()


def _unshuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    """Undo blosc byte-shuffle on a single block (uint8 array)."""
    n = len(buf)
    nel = n // typesize
    body = n - n % typesize
    out = np.empty(n, dtype=np.uint8)
    # shuffled layout: stream of byte-0 of all elements, then byte-1, ...
    out[:body] = buf[:body].reshape(typesize, nel).T.ravel()
    out[body:] = buf[body:]
    return out


def _unbitshuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    """Undo blosc bit-shuffle on a single block (uint8 array).

    Forward bitshuffle stores bit-plane-major data: row r = 8*b + k of a
    [8*typesize, nelem/8] byte matrix holds bit k of byte b of every element,
    8 elements per byte, LSB-first. c-blosc (>=1.18) semantics: if the block's
    element count is NOT a multiple of 8 the whole block is memcpy'd raw
    (verified against Abacus pack9 data products); otherwise all elements are
    transposed and the sub-typesize remainder is copied raw.
    """
    n = len(buf)
    nelem = n // typesize
    if nelem % 8:
        return buf.copy()
    body = nelem * typesize
    out = np.empty(n, dtype=np.uint8)
    if body:
        planes = buf[:body].reshape(8 * typesize, nelem // 8)
        bits = np.unpackbits(planes, axis=1, bitorder='little')  # [8T, nelem]
        out[:body] = np.packbits(
            bits.T.reshape(nelem, typesize, 8), axis=2, bitorder='little'
        ).reshape(body)
    out[body:] = buf[body:]
    return out


def _shuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    n = len(buf)
    nel = n // typesize
    body = n - n % typesize
    out = np.empty(n, dtype=np.uint8)
    out[:body] = buf[:body].reshape(nel, typesize).T.ravel()
    out[body:] = buf[body:]
    return out


def decompress_chunk(chunk, out=None):
    """Decompress one blosc1 chunk (bytes-like) into a uint8 ndarray.

    If `out` (a writable uint8 ndarray of length nbytes) is given, decompress
    into it and return it.
    """
    chunk = memoryview(chunk)
    flags = chunk[2]
    typesize = chunk[3]
    nbytes, blocksize, cbytes = struct.unpack_from('<III', chunk, 4)

    if out is None:
        out = np.empty(nbytes, dtype=np.uint8)
    else:
        if len(out) != nbytes:
            raise ValueError(f'out has length {len(out)}, expected {nbytes}')

    if flags & _MEMCPYED:
        out[:] = np.frombuffer(chunk[16 : 16 + nbytes], dtype=np.uint8)
        return out

    fmt = flags >> 5
    if fmt != _FMT_ZSTD:
        raise NotImplementedError(f'blosc codec format {fmt} not supported (zstd only)')

    bitshuffle = bool(flags & _DOBITSHUFFLE)
    shuffle = (bool(flags & _DOSHUFFLE) and typesize > 1) or bitshuffle
    nblocks = (nbytes + blocksize - 1) // blocksize
    offsets = struct.unpack_from(f'<{nblocks}I', chunk, 16)

    # split streams: c-blosc1 splits a block into `typesize` streams unless
    # the dont_split flag is set
    nstreams = 1 if (flags & _DONT_SPLIT) or not shuffle else typesize

    for i, off in enumerate(offsets):
        expected = min(blocksize, nbytes - i * blocksize)
        neblock = expected // nstreams if nstreams > 1 else expected
        pos = off
        block = np.empty(expected, dtype=np.uint8) if shuffle else out[i * blocksize : i * blocksize + expected]
        written = 0
        while written < expected:
            (cb,) = struct.unpack_from('<i', chunk, pos)
            pos += 4
            ne = min(neblock, expected - written)
            if cb == 0:
                block[written : written + ne] = 0
            elif cb == ne:
                block[written : written + ne] = np.frombuffer(
                    chunk[pos : pos + cb], dtype=np.uint8
                )
                pos += cb
            else:
                raw = _zstd_d.decompress(chunk[pos : pos + cb], max_output_size=ne)
                if len(raw) != ne:
                    raise ValueError(
                        f'stream decompressed to {len(raw)} bytes, expected {ne}'
                    )
                block[written : written + ne] = np.frombuffer(raw, dtype=np.uint8)
                pos += cb
            written += ne
        if bitshuffle:
            out[i * blocksize : i * blocksize + expected] = _unbitshuffle(
                block, typesize
            )
        elif shuffle:
            out[i * blocksize : i * blocksize + expected] = _unshuffle(block, typesize)
    return out


def compress_chunk(
    data, typesize, clevel=1, shuffle=True, blocksize=512 * 1024
) -> bytes:
    """Compress bytes-like `data` into one blosc1 chunk (zstd codec)."""
    data = np.frombuffer(memoryview(data).cast('B'), dtype=np.uint8)
    nbytes = len(data)
    if typesize < 1 or typesize > _MAX_TYPESIZE:
        typesize = 1
    shuffle = shuffle and typesize > 1
    # keep blocks a multiple of typesize so shuffle never straddles blocks
    blocksize = max(typesize, blocksize - blocksize % typesize)
    nblocks = max(1, (nbytes + blocksize - 1) // blocksize)

    flags = _DONT_SPLIT | (_FMT_ZSTD << 5)
    if shuffle:
        flags |= _DOSHUFFLE

    import zstandard

    cctx = zstandard.ZstdCompressor(level=clevel)
    header = bytearray(16)
    header[0] = 2  # format version
    header[1] = 1
    header[2] = flags
    header[3] = typesize

    offsets = []
    blocks = []
    pos = 16 + 4 * nblocks
    for i in range(nblocks):
        raw = data[i * blocksize : (i + 1) * blocksize]
        if shuffle:
            raw = _shuffle(raw, typesize)
        comp = cctx.compress(raw.tobytes())
        if len(comp) >= len(raw):
            comp = raw.tobytes()  # store raw; detected via cb == ne
        blocks.append(struct.pack('<i', len(comp)) + comp)
        offsets.append(pos)
        pos += len(blocks[-1])

    cbytes = pos
    struct.pack_into('<III', header, 4, nbytes, blocksize, cbytes)
    return bytes(header) + struct.pack(f'<{nblocks}I', *offsets) + b''.join(blocks)


class ChunkedBloscDecoder:
    """Decode the reference framing: a byte stream of [4-byte BE length][blosc chunk]...

    Decodes chunks in parallel with a thread pool (zstd releases the GIL).
    """

    def __init__(self, nthreads=4):
        self.nthreads = nthreads

    def iter_chunks(self, buf):
        buf = memoryview(buf)
        pos = 0
        n = len(buf)
        while pos < n:
            (size,) = struct.unpack_from('!I', buf, pos)
            pos += 4
            yield buf[pos : pos + size]
            pos += size

    def decompress(self, buf, out):
        """Decompress full framed stream `buf` into uint8 ndarray `out`.

        Uses the native C++ decoder when available (threaded zstd +
        unshuffle), falling back to the pure-Python path."""
        from .native import decode_blosc_stream_native

        if decode_blosc_stream_native(buf, out, nthreads=self.nthreads):
            return len(out)

        chunks = list(self.iter_chunks(buf))
        sizes = [struct.unpack_from('<I', c, 4)[0] for c in chunks]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        if offs[-1] != len(out):
            raise ValueError(f'decompressed size {offs[-1]} != block size {len(out)}')
        if len(chunks) > 1 and self.nthreads > 1:
            with ThreadPoolExecutor(self.nthreads) as ex:
                list(
                    ex.map(
                        lambda ic: decompress_chunk(
                            ic[1], out[offs[ic[0]] : offs[ic[0] + 1]]
                        ),
                        enumerate(chunks),
                    )
                )
        else:
            for i, c in enumerate(chunks):
                decompress_chunk(c, out[offs[i] : offs[i + 1]])
        return len(out)

    def compress(self, data, typesize, clevel=1, shuffle=True, chunk_nbytes=1 << 22):
        """Compress ndarray/bytes into the framed stream (4 MB chunks).

        Dispatches to the native C++ path (threaded zstd + shuffle) when
        available; the formats are interchangeable."""
        if shuffle:
            from .native import compress_blosc_stream_native

            out = compress_blosc_stream_native(
                data, typesize, clevel=clevel, chunk_nbytes=chunk_nbytes,
                nthreads=self.nthreads,
            )
            if out is not None:
                return out
        data = np.frombuffer(memoryview(data).cast('B'), dtype=np.uint8)
        parts = []
        for i in range(0, max(len(data), 1), chunk_nbytes):
            chunk = compress_chunk(
                data[i : i + chunk_nbytes], typesize, clevel=clevel, shuffle=shuffle
            )
            parts.append(struct.pack('!I', len(chunk)))
            parts.append(chunk)
        return b''.join(parts)
