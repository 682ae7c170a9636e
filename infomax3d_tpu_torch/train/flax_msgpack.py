"""A reader for the checkpoints the JAX package writes: the msgpack subset of
`flax.serialization.to_bytes`, decoded as `flax.serialization.msgpack_restore`
decodes it, without `msgpack` or `flax`.

msgpack types: nil, bool, every int width, float32 and float64, str, bin,
arrays (-> lists) and maps (-> dicts, str or bytes keys).  flax's ext
types: 1 an ndarray (an inner msgpack ``(shape, dtype name, C-order
bytes)``), 2 a complex number (an inner ``(real, imag)``), 3 a numpy
scalar (an ndarray of shape ``()``).  ``__msgpack_chunked_array__`` maps
(flax's split of a leaf above ``MAX_CHUNK_SIZE``) become their array.

numpy has no bfloat16: a ``bfloat16`` leaf is returned as float32, its 16
bits widened exactly (a bfloat16 is the top half of a float32).  Every
other dtype is numpy's of the stored name; arrays are writable copies.

Anything else (a reserved byte, an unknown ext type or dtype, a map key
that is not a string, bytes missing or left over) raises
`MsgpackError` naming the byte offset.  Read only: the port writes no
msgpack.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos}, {len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self, raw: bool = False) -> Any:
        at = self.pos
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.uint(1), n, at)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.uint(1), 1 << (b - 0xD4), at)
        if 0xD9 <= b <= 0xDB:
            return self.str(self.uint(1 << (b - 0xD9)), raw, at)
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4), raw)
        raise MsgpackError(f"reserved byte 0x{b:02x} at offset {at}")

    def str(self, n: int, raw: bool, at: int):
        body = bytes(self.take(n))
        if raw:
            return body
        try:
            return body.decode("utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"invalid UTF-8 in the str at offset {at}") \
                from e

    def array(self, n: int, raw: bool) -> list:
        return [self.value(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            at = self.pos
            k = self.value(raw)
            if not isinstance(k, (str, bytes)):
                raise MsgpackError(f"map key of type {type(k).__name__} at "
                                   f"offset {at}")
            out[k] = self.value(raw)
        return out

    def ext(self, code: int, n: int, at: int):
        body = bytes(self.take(n))
        if code in (1, 3):
            arr = _ndarray(body, at)
            return arr if code == 1 else arr[()]
        if code == 2:
            re_im = _inner(body, at, raw=False)
            return complex(re_im[0], re_im[1])
        raise MsgpackError(f"unknown ext type {code} at offset {at}")


def _inner(body: bytes, at: int, raw: bool):
    r = _Reader(body)
    try:
        out = r.value(raw)
    except MsgpackError as e:
        raise MsgpackError(f"in the ext at offset {at}: {e}") from e
    if r.pos != len(body):
        raise MsgpackError(f"in the ext at offset {at}: "
                           f"{len(body) - r.pos} bytes left over")
    return out


def _ndarray(body: bytes, at: int) -> np.ndarray:
    """flax's `_ndarray_from_bytes`: ``(shape, dtype name, buffer)``."""
    parts = _inner(body, at, raw=True)
    if not (isinstance(parts, list) and len(parts) == 3):
        raise MsgpackError(f"ndarray ext at offset {at} is not "
                           f"(shape, dtype, buffer)")
    shape, name, buf = parts
    try:
        name = name.decode("ascii") if isinstance(name, bytes) else name
        if name == "bfloat16":
            u16 = np.frombuffer(buf, np.uint16)
            flat = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            flat = np.frombuffer(buf, np.dtype(name)).copy()
        return flat.reshape(tuple(shape), order="C")
    except (TypeError, ValueError) as e:
        raise MsgpackError(f"ndarray ext at offset {at}: {e}") from e


def _unchunk(tree: Any) -> Any:
    """flax's `_unchunk_array_leaves_in_place`, returning the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` returns (dicts,
    lists, Python scalars, numpy arrays and scalars; bfloat16 as
    float32)."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes left over at offset "
                           f"{r.pos}")
    return _unchunk(tree)


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
