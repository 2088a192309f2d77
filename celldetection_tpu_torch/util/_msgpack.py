"""MessagePack in plain Python, with flax's extension types for arrays.

Every cdt model file and trainer checkpoint is msgpack, and its weights are
flax's encoding of a tree of arrays (``flax.serialization.to_bytes``). The
port reads and writes both without msgpack or flax:

* :func:`packb` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
  for nil, bool, int, float (as float64), str, bytes (bin), list and tuple
  (array) and dict (map); a numpy array or scalar becomes flax's extension
  (``ndarray = 1``: a packed ``(shape, dtype name, C-order bytes)``;
  ``npscalar = 3``: the same of a 0-d array), as flax's ``msgpack_serialize``
  packs it. Types are checked exactly, as flax's ``strict_types=True`` does,
  so a numpy scalar is never packed as the Python number it subclasses.
* :func:`unpackb` reads all of msgpack with strings as ``str`` and maps of any
  key type (``strict_map_key=False``); an array comes back as an
  ``np.frombuffer`` view of the input, with no per-element Python.
* :func:`msgpack_serialize` and :func:`msgpack_restore` are flax's functions
  of the same names: arrays over ``MAX_CHUNK_SIZE`` bytes travel in flax's
  chunked form (``'__msgpack_chunked_array__'``).
"""
import struct

import numpy as np

__all__ = ['packb', 'unpackb', 'msgpack_serialize', 'msgpack_restore', 'MAX_CHUNK_SIZE']

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack holds at most 2^31 - 1 bytes in an object
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = '__msgpack_chunked_array__'


def _sized(out, n: int, fix: int, fix_max: int, codes):
    """Append the header of a str, bin, array or map of length ``n``."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n < 0x100:
        out.append(struct.pack('>BB', codes[0], n))
    elif n < 0x10000:
        out.append(struct.pack('>BH', codes[1], n))
    elif n < 0x100000000:
        out.append(struct.pack('>BI', codes[2], n))
    else:
        raise ValueError(f'msgpack object of length {n} is too large')


def _pack_int(out, v: int):
    if 0 <= v < 0x80:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(bytes((v & 0xff,)))
    elif v >= 0:
        for code, fmt, top in ((0xcc, '>BB', 0x100), (0xcd, '>BH', 0x10000),
                               (0xce, '>BI', 0x100000000), (0xcf, '>BQ', 1 << 64)):
            if v < top:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f'{v} does not fit in msgpack')
    else:
        for code, fmt, low in ((0xd0, '>Bb', -0x80), (0xd1, '>Bh', -0x8000),
                               (0xd2, '>Bi', -0x80000000), (0xd3, '>Bq', -(1 << 63))):
            if v >= low:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f'{v} does not fit in msgpack')


def _pack_ext(out, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fixed is not None:
        out.append(struct.pack('>Bb', fixed, code))
    else:
        _sized(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(struct.pack('>b', code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``(shape, dtype name, C bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes cannot be serialized')
    return packb([[int(s) for s in arr.shape], arr.dtype.name, arr.tobytes('C')])


def _pack(out, obj):
    t = type(obj)
    if obj is None:
        out.append(b'\xc0')
    elif t is bool:
        out.append(b'\xc3' if obj else b'\xc2')
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(struct.pack('>Bd', 0xcb, obj))
    elif t is str:
        data = obj.encode('utf-8')
        _sized(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _sized(out, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif t in (list, tuple):
        _sized(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _sized(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f'cannot serialize {t.__name__} to msgpack')


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (see the module's docstring for the types)."""
    out = []
    _pack(out, obj)
    return b''.join(out)


class _Reader:
    """One pass over a msgpack buffer; arrays are views of ``buf``."""

    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def take(self, fmt: str):
        v = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v[0] if len(v) == 1 else v

    def raw(self, n: int) -> bytes:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError('truncated msgpack data')
        return bytes(self.view[start:self.pos])

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            # flax's _ndarray_from_bytes, read in place
            if self.read_header_len() != 3:
                raise ValueError('malformed ndarray extension')
            shape = self.read()
            name = self.read()
            name = name.decode() if isinstance(name, bytes) else name
            size = self.read_bin_len()
            dtype = np.dtype(name)
            arr = np.frombuffer(self.buf, dtype=dtype, count=size // dtype.itemsize,
                                offset=self.pos).reshape(shape, order='C') if size else \
                np.empty(shape, dtype)
            self.pos += size
            out = arr if code == EXT_NDARRAY else arr[()]
        else:
            raise ValueError(f'unknown msgpack extension type {code}')
        if self.pos != end:
            raise ValueError(f'malformed msgpack extension type {code}')
        return out

    def read_header_len(self) -> int:
        b = self.take('>B')
        if 0x90 <= b <= 0x9f:
            return b & 0x0f
        if b == 0xdc:
            return self.take('>H')
        if b == 0xdd:
            return self.take('>I')
        raise ValueError('expected a msgpack array')

    def read_bin_len(self) -> int:
        b = self.take('>B')
        fmt = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xd9: '>B', 0xda: '>H', 0xdb: '>I'}.get(b)
        if fmt is None:
            if 0xa0 <= b <= 0xbf:
                return b & 0x1f
            raise ValueError('expected msgpack bin')
        return self.take(fmt)

    def read(self):
        b = self.take('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.raw(b & 0x1f).decode('utf-8')
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return self.raw(self.take(('>B', '>H', '>I')[b - 0xc4]))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.take(('>B', '>H', '>I')[b - 0xc7])
            return self.ext(self.take('>b'), n)
        if b == 0xca:
            return self.take('>f')
        if b == 0xcb:
            return self.take('>d')
        if 0xcc <= b <= 0xd3:
            return self.take(('>B', '>H', '>I', '>Q', '>b', '>h', '>i', '>q')[b - 0xcc])
        if 0xd4 <= b <= 0xd8:
            code = self.take('>b')
            return self.ext(code, 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return self.raw(self.take(('>B', '>H', '>I')[b - 0xd9])).decode('utf-8')
        if b in (0xdc, 0xdd):
            return [self.read() for _ in range(self.take('>H' if b == 0xdc else '>I'))]
        if b in (0xde, 0xdf):
            return self.map(self.take('>H' if b == 0xde else '>I'))
        raise ValueError(f'invalid msgpack byte 0x{b:02x} at {self.pos - 1}')

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data):
    """Decode one msgpack object that fills ``data`` (bytes or a buffer)."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(data):
        raise ValueError(f'{len(data) - r.pos} bytes of extra data after the msgpack object')
    return obj


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: an array as flat chunks of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, 'shape': {str(i): int(s) for i, s in enumerate(arr.shape)},
            'chunks': {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree):
    if isinstance(tree, dict):   # in sorted key order, as flax's copy with jax.tree_util
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
            chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of dicts with numpy leaves: the
    same bytes, with every dict's keys in sorted order."""
    return packb(_chunk_leaves(tree))


def msgpack_restore(data):
    """flax's ``msgpack_restore``: the tree, with chunked arrays joined."""
    return _unchunk_leaves(unpackb(data))
