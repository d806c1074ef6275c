"""The msgpack encoding of ``flax.serialization``, in numpy and the standard library.

The JAX package's checkpoint sections are ``flax.serialization.to_bytes``
of a state tree: ``to_state_dict`` (lists and tuples become maps keyed
``"0"``, ``"1"``, ..., a named tuple a map of its fields; the port builds
its trees in that form, ``interop.py``), then ``msgpack_serialize``.
This module writes and reads that subset of msgpack, so that a checkpoint moves between the port and the JAX package
without ``msgpack``, ``flax`` or ``jax``:

- maps (in the order the caller's dict has them), arrays (from lists),
  str, bin, int, float (always float64), bool and nil, each in msgpack's
  shortest form, as ``msgpack.packb(..., strict_types=True)`` picks it;
- ext type 1, an array: the msgpack array ``(shape, dtype name, C-order
  bytes)`` with ``use_bin_type=True``.  Leaves are numpy arrays and CPU
  tensors; a 0-d array stays an array (optax's ``count``);
- ext type 3, a numpy scalar, in the same inner form;
- the ``__msgpack_chunked_array__`` map of an array above
  :data:`MAX_CHUNK_SIZE` bytes that is a map's value or the whole tree,
  as flax splits it.

Decoded arrays are writable numpy arrays; ``bfloat16``, which numpy lacks,
comes back as a ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
# flax's limit for one array leaf; read at call time, so a test may patch it
MAX_CHUNK_SIZE = 2**30


# -- leaves ------------------------------------------------------------------


def _array_parts(leaf) -> tuple[tuple, str, bytes]:
    """``(shape, dtype name, C-order bytes)`` of a numpy array or a tensor."""
    if isinstance(leaf, torch.Tensor):
        tensor = leaf.detach().cpu().contiguous()
        if tensor.dtype == torch.bfloat16:
            return (tuple(tensor.shape), "bfloat16",
                    tensor.view(torch.int16).numpy().tobytes())
        leaf = tensor.numpy()
    if leaf.dtype.hasobject or leaf.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax-msgpack form")
    return leaf.shape, leaf.dtype.name, leaf.tobytes("C")


def _array_from_parts(shape, name: str, buffer: bytes):
    if name == "bfloat16":
        bits = (torch.frombuffer(bytearray(buffer), dtype=torch.int16) if buffer
                else torch.empty(0, dtype=torch.int16))
        return bits.view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.size * leaf.dtype.itemsize


def _chunk(leaf) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes, with its shape."""
    itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    chunks = [flat[i: i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunk_large(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy: arrays that are
    map values (at any depth of maps) or the whole tree."""
    if isinstance(tree, dict):
        return {k: (_chunk(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE
                    else _chunk_large(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(node: dict):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_all(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps that are the
    tree or map values (at any depth of maps)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        return _unchunk(tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            tree[k] = _unchunk(v) if CHUNKED in v else _unchunk_all(v)
    return tree


# -- msgpack ---------------------------------------------------------------------


def _pack_int(out: list, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0 <= x <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", x))
    elif -0x80 <= x < 0:
        out.append(b"\xd0" + struct.pack("b", x))
    elif 0 <= x <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", x))
    elif -0x8000 <= x < 0:
        out.append(b"\xd1" + struct.pack(">h", x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", x))
    elif -0x80000000 <= x < 0:
        out.append(b"\xd2" + struct.pack(">i", x))
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", x))
    elif -0x8000000000000000 <= x < 0:
        out.append(b"\xd3" + struct.pack(">q", x))
    else:
        raise OverflowError(f"int {x} does not fit in 64 bits")


def _pack_length(out: list, n: int, fix: int | None, fix_limit: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-, 16-
    or 32-bit form (``codes``, None where the family has no 8-bit form)."""
    if fix is not None and n < fix_limit:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"a msgpack object of length {n} is too large")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _pack_array_payload(leaf) -> bytes:
    shape, name, buffer = _array_parts(leaf)
    return _packb([list(shape), name, buffer])


def _pack(out: list, x) -> None:
    kind = type(x)
    if x is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif kind is int:
        _pack_int(out, x)
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif kind is str:
        data = x.encode("utf-8")
        _pack_length(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif kind in (bytes, bytearray):
        _pack_length(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
    elif kind is list:
        _pack_length(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif kind is dict:
        _pack_length(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in x.items():
            _pack(out, key)
            _pack(out, value)
    elif _is_array(x):
        _pack_ext(out, EXT_NDARRAY, _pack_array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _pack_array_payload(np.asarray(x)))
    else:
        # strict types, as flax packs: a tuple or a subclass is no list or int
        raise TypeError(f"can not serialize {kind.__name__!r} object")


def _packb(x) -> bytes:
    out: list = []
    _pack(out, x)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        chunk = self.data[self.pos: self.pos + n]
        self.pos += n
        return bytes(chunk)

    def unpack(self, fmt: str):
        (value,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return value

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"byte 0x{b:02x} starts no msgpack object this reader knows")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")
        inner = _Reader(data)
        shape, name, buffer = inner.value()
        array = _array_from_parts(shape, name if isinstance(name, str) else name.decode(), buffer)
        if code == EXT_NDARRAY:
            return array
        return array.reshape(()) if isinstance(array, torch.Tensor) else array[()]


# -- the flax API ---------------------------------------------------------------------


def serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree, in_place=True)``: maps in
    the order ``tree`` has them, large arrays chunked."""
    return _packb(_chunk_large(tree))


def restore(blob: bytes):
    """``flax.serialization.msgpack_restore``: the tree of ``blob``, chunked
    arrays joined."""
    reader = _Reader(blob)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes follow the msgpack object")
    return _unchunk_all(tree)
