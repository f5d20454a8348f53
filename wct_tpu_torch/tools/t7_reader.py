"""Minimal pure-Python Torch7 (.t7) deserializer.

A copy of ``wct_tpu/tools/t7_reader.py`` (numpy only), kept in the port
so that it imports nothing of the JAX package. It implements just
enough of the Torch7 binary serialization format (little-endian;
type-tagged objects with a memoization heap) for
``wct_tpu_torch.tools.convert_t7`` to convert ``vgg_normalised.t7``
offline to an npz tree. Covers: nil, number, boolean, string, table,
torch classes, ``torch.*Tensor`` / ``torch.*Storage``.

A matching writer (``write_t7``) exists for round-trip testing — it is
NOT a general Torch serializer, just the mirror of what the reader
understands.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8

_STORAGE_DTYPES = {
    "torch.DoubleStorage": (np.float64, 8),
    "torch.FloatStorage": (np.float32, 4),
    "torch.LongStorage": (np.int64, 8),
    "torch.IntStorage": (np.int32, 4),
    "torch.ByteStorage": (np.uint8, 1),
    "torch.CharStorage": (np.int8, 1),
    "torch.ShortStorage": (np.int16, 2),
}
_TENSOR_TO_STORAGE = {
    f"torch.{k}Tensor": f"torch.{k}Storage"
    for k in ("Double", "Float", "Long", "Int", "Byte", "Char", "Short")
}


@dataclasses.dataclass
class TorchObject:
    """A deserialized non-tensor Torch class instance (e.g. nn.* module)."""

    torch_typename: str
    attrs: dict

    def __getitem__(self, key):
        return self.attrs[key]

    def get(self, key, default=None):
        return self.attrs.get(key, default)


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        data = self.f.read(size)
        if len(data) != size:
            raise EOFError("truncated t7 file")
        return struct.unpack(fmt, data)[0]

    def read_int(self) -> int:
        return self._read("<i")

    def read_long(self) -> int:
        return self._read("<q")

    def read_double(self) -> float:
        return self._read("<d")

    def read_string(self) -> str:
        n = self.read_int()
        return self.f.read(n).decode("latin-1")

    def read_array(self, n: int, dtype: np.dtype, elem_size: int) -> np.ndarray:
        return np.frombuffer(self.f.read(n * elem_size), dtype=dtype, count=n)

    def read_obj(self) -> Any:
        type_id = self.read_int()
        if type_id == TYPE_NIL:
            return None
        if type_id == TYPE_NUMBER:
            return self.read_double()
        if type_id == TYPE_BOOLEAN:
            return self.read_int() == 1
        if type_id == TYPE_STRING:
            return self.read_string()
        if type_id in (TYPE_TABLE, TYPE_TORCH, TYPE_FUNCTION, TYPE_RECUR_FUNCTION):
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            if type_id == TYPE_TORCH:
                return self._read_torch(index)
            if type_id == TYPE_TABLE:
                return self._read_table(index)
            raise NotImplementedError("t7 function objects are not supported")
        raise ValueError(f"unknown t7 type id {type_id}")

    def _read_torch(self, index: int) -> Any:
        version = self.read_string()
        if version.startswith("V "):
            classname = self.read_string()
        else:  # pre-versioning files: the string IS the class name
            classname = version

        if classname in _STORAGE_DTYPES:
            dtype, elem = _STORAGE_DTYPES[classname]
            n = self.read_long()
            arr = self.read_array(n, dtype, elem)
            self.memo[index] = arr
            return arr

        if classname in _TENSOR_TO_STORAGE:
            ndim = self.read_int()
            sizes = self.read_array(ndim, np.int64, 8)
            strides = self.read_array(ndim, np.int64, 8)
            offset = self.read_long() - 1  # 1-indexed
            storage = self.read_obj()
            if storage is None or ndim == 0:
                arr = np.empty((0,))
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=tuple(int(s) for s in sizes),
                    strides=tuple(int(s) * storage.itemsize for s in strides),
                ).copy()
            self.memo[index] = arr
            return arr

        # Memoize BEFORE reading attrs: a module's table may legally
        # back-reference the module itself; the placeholder makes the
        # inner (TYPE_TORCH, index) hit the memo instead of re-reading
        # the stream (which would misparse everything after it).
        obj = TorchObject(classname, {})
        self.memo[index] = obj
        attrs = self.read_obj()  # the object's table
        obj.attrs = (
            attrs.attrs if isinstance(attrs, TorchObject) else (attrs or {})
        )
        return obj

    def _read_table(self, index: int) -> Any:
        n = self.read_int()
        table: dict = {}
        self.memo[index] = table
        for _ in range(n):
            key = self.read_obj()
            value = self.read_obj()
            if isinstance(key, float) and key.is_integer():
                key = int(key)
            table[key] = value
        # A pure 1..N int-keyed table is a Lua list.
        if table and all(isinstance(k, int) for k in table):
            keys = sorted(table)
            if keys == list(range(1, len(keys) + 1)):
                as_list = [table[k] for k in keys]
                self.memo[index] = as_list
                return as_list
        return table


def load_t7(path: str) -> Any:
    """Load a .t7 file (binary serialization) to Python objects."""
    with open(path, "rb") as f:
        return _Reader(f).read_obj()


# ----------------------------------------------------------------------
# Writer — mirror of the reader, for round-trip tests only.
# ----------------------------------------------------------------------


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_index = 1

    def write_int(self, v: int):
        self.f.write(struct.pack("<i", v))

    def write_long(self, v: int):
        self.f.write(struct.pack("<q", v))

    def write_string(self, s: str):
        raw = s.encode("latin-1")
        self.write_int(len(raw))
        self.f.write(raw)

    def write_obj(self, obj: Any):
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, TorchObject):
            self.write_int(TYPE_TORCH)
            self.write_int(self._bump())
            self.write_string("V 1")
            self.write_string(obj.torch_typename)
            self.write_obj(obj.attrs)
        elif isinstance(obj, (list, dict)):
            self.write_int(TYPE_TABLE)
            self.write_int(self._bump())
            items = (
                list(enumerate(obj, start=1)) if isinstance(obj, list)
                else list(obj.items())
            )
            self.write_int(len(items))
            for k, v in items:
                self.write_obj(k)
                self.write_obj(v)
        else:
            raise TypeError(f"cannot serialize {type(obj)}")

    def _bump(self) -> int:
        i = self.next_index
        self.next_index += 1
        return i

    def _write_tensor(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        kind = {"f4": "Float", "f8": "Double", "i8": "Long"}[arr.dtype.str[1:]]
        self.write_int(TYPE_TORCH)
        self.write_int(self._bump())
        self.write_string("V 1")
        self.write_string(f"torch.{kind}Tensor")
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        strides = [st // arr.itemsize for st in arr.strides]
        for s in strides:
            self.write_long(s)
        self.write_long(1)  # storage offset, 1-indexed
        # storage
        self.write_int(TYPE_TORCH)
        self.write_int(self._bump())
        self.write_string("V 1")
        self.write_string(f"torch.{kind}Storage")
        self.write_long(arr.size)
        self.f.write(arr.tobytes())


def write_t7(path: str, obj: Any) -> None:
    """Write ``obj`` in Torch7 binary format (round-trip test helper)."""
    with open(path, "wb") as f:
        _Writer(f).write_obj(obj)
