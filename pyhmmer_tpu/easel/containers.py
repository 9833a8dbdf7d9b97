"""Generic containers: bit fields, key hashes, typed vectors/matrices.

Mirrors ``pyhmmer.easel``'s ``Bitfield`` (``easel.pyx:721-1025``),
``KeyHash`` (``easel.pyx:1026-1303``), ``Vector``/``VectorD/F/I/U8``
(``easel.pyx:1304-3228``) and ``Matrix``/``MatrixD/F/I/U8``
(``easel.pyx:3229-4706``).  This package backs every one with a NumPy
array (buffer protocol for free) instead of Easel's C structs.
"""

from __future__ import annotations

import numpy as np
from typing import Iterable, Iterator, Optional

__all__ = [
    "Bitfield", "KeyHash",
    "Vector", "VectorD", "VectorF", "VectorI", "VectorU8",
    "Matrix", "MatrixD", "MatrixF", "MatrixI", "MatrixU8",
]


class Bitfield:
    """A packed boolean vector (``ESL_BITFIELD`` equivalent).

    Example:
        >>> b = Bitfield([True, False, True])
        >>> len(b), b.count()
        (3, 2)
        >>> b.toggle(1); b.count()
        3
    """

    def __init__(self, iterable: Iterable[object]):
        self._bits = np.array([bool(x) for x in iterable], dtype=bool)

    @classmethod
    def zeros(cls, n: int) -> "Bitfield":
        self = cls.__new__(cls)
        self._bits = np.zeros(n, dtype=bool)
        return self

    @classmethod
    def ones(cls, n: int) -> "Bitfield":
        self = cls.__new__(cls)
        self._bits = np.ones(n, dtype=bool)
        return self

    def __len__(self) -> int:
        return len(self._bits)

    def __getitem__(self, i: int) -> bool:
        return bool(self._bits[self._wrap(i)])

    def __setitem__(self, i: int, value: object) -> None:
        self._bits[self._wrap(i)] = bool(value)

    def __iter__(self) -> Iterator[bool]:
        return (bool(b) for b in self._bits)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Bitfield)
                and np.array_equal(self._bits, other._bits))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({[bool(b) for b in self._bits]!r})"

    def _wrap(self, i: int) -> int:
        n = len(self._bits)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return i

    def count(self, value: bool = True) -> int:
        """Number of positions equal to ``value``."""
        n = int(self._bits.sum())
        return n if value else len(self._bits) - n

    def toggle(self, i: int) -> None:
        i = self._wrap(i)
        self._bits[i] = not self._bits[i]

    def copy(self) -> "Bitfield":
        out = Bitfield.__new__(Bitfield)
        out._bits = self._bits.copy()
        return out


class KeyHash:
    """An ordered string-to-index mapping (``ESL_KEYHASH`` equivalent;
    used for hit ranking in jackhmmer).

    Example:
        >>> kh = KeyHash()
        >>> kh.add(b"first"), kh.add(b"second"), kh.add(b"first")
        (0, 1, 0)
        >>> kh[b"second"], len(kh), b"first" in kh
        (1, 2, True)
    """

    def __init__(self):
        self._map: dict = {}
        self._keys: list = []

    def add(self, key: bytes) -> int:
        """Insert ``key`` and return its index (existing index if
        already present)."""
        if key in self._map:
            return self._map[key]
        idx = len(self._keys)
        self._map[key] = idx
        self._keys.append(key)
        return idx

    def __getitem__(self, key: bytes) -> int:
        return self._map[key]

    def __contains__(self, key: bytes) -> bool:
        return key in self._map

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self) -> Iterator[bytes]:
        return iter(self._keys)

    def __eq__(self, other) -> bool:
        return isinstance(other, KeyHash) and self._keys == other._keys

    def clear(self) -> None:
        self._map.clear()
        self._keys.clear()

    def copy(self) -> "KeyHash":
        out = KeyHash()
        out._map = dict(self._map)
        out._keys = list(self._keys)
        return out


class Vector:
    """A typed 1-D array with the Easel vector operations."""

    _dtype: Optional[np.dtype] = None

    def __init__(self, iterable: Iterable = ()):
        self._data = np.array(list(iterable), dtype=self._dtype)

    @classmethod
    def zeros(cls, n: int):
        self = cls.__new__(cls)
        self._data = np.zeros(n, dtype=cls._dtype)
        return self

    @classmethod
    def _from_array(cls, arr: np.ndarray):
        self = cls.__new__(cls)
        self._data = np.asarray(arr, dtype=cls._dtype)
        return self

    # -- container protocol -------------------------------------------------

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return type(self)._from_array(self._data[i])
        return self._data[i].item()

    def __setitem__(self, i, v):
        self._data[i] = v

    def __iter__(self):
        return (x.item() for x in self._data)

    def __eq__(self, other) -> bool:
        return (type(other) is type(self)
                and np.array_equal(self._data, other._data))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._data.tolist()!r})"

    def __array__(self, dtype=None, copy=None):
        return np.array(self._data, dtype=dtype) if dtype else self._data

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        o = other._data if isinstance(other, Vector) else other
        return type(self)._from_array(self._data + o)

    def __iadd__(self, other):
        o = other._data if isinstance(other, Vector) else other
        self._data += o
        return self

    def __mul__(self, other):
        o = other._data if isinstance(other, Vector) else other
        return type(self)._from_array(self._data * o)

    def __imul__(self, other):
        o = other._data if isinstance(other, Vector) else other
        self._data *= o
        return self

    def __matmul__(self, other):
        o = other._data if isinstance(other, Vector) else other
        return (self._data @ o).item()

    # -- Easel vector ops ---------------------------------------------------

    @property
    def shape(self):
        return self._data.shape

    @property
    def strides(self):
        return self._data.strides

    @property
    def itemsize(self) -> int:
        return self._data.itemsize

    def argmax(self) -> int:
        return int(self._data.argmax())

    def argmin(self) -> int:
        return int(self._data.argmin())

    def max(self):
        return self._data.max().item()

    def min(self):
        return self._data.min().item()

    def sum(self):
        return self._data.sum().item()

    def reverse(self) -> None:
        self._data = self._data[::-1].copy()

    def copy(self):
        return type(self)._from_array(self._data.copy())


class VectorD(Vector):
    _dtype = np.dtype(np.float64)

    def normalize(self) -> None:
        """Scale so elements sum to 1 (``esl_vec_DNorm``)."""
        s = self._data.sum()
        if s != 0.0:
            self._data /= s

    def entropy(self) -> float:
        """Shannon entropy in bits (``esl_vec_DEntropy``)."""
        p = self._data[self._data > 0]
        return float(-(p * np.log2(p)).sum())

    def relative_entropy(self, other) -> float:
        """KL divergence in bits (``esl_vec_DRelEntropy``)."""
        q = other._data if isinstance(other, Vector) else np.asarray(other)
        p = self._data
        mask = p > 0
        if np.any(mask & (q <= 0)):
            return float("inf")
        return float((p[mask] * np.log2(p[mask] / q[mask])).sum())


class VectorF(VectorD):
    _dtype = np.dtype(np.float32)


class VectorI(Vector):
    _dtype = np.dtype(np.int32)


class VectorU8(Vector):
    _dtype = np.dtype(np.uint8)


class Matrix:
    """A typed 2-D array."""

    _dtype: Optional[np.dtype] = None
    _vector: type = Vector

    def __init__(self, iterable: Iterable = ()):
        rows = [list(r) for r in iterable]
        self._data = np.array(rows, dtype=self._dtype)
        if self._data.ndim != 2:
            raise ValueError("expected a 2-D iterable of rows")

    @classmethod
    def zeros(cls, m: int, n: int):
        self = cls.__new__(cls)
        self._data = np.zeros((m, n), dtype=cls._dtype)
        return self

    @classmethod
    def _from_array(cls, arr):
        self = cls.__new__(cls)
        self._data = np.asarray(arr, dtype=cls._dtype)
        return self

    def __len__(self) -> int:
        return self._data.shape[0]

    def __getitem__(self, i):
        if isinstance(i, tuple):
            v = self._data[i]
            return v.item() if np.isscalar(v) or v.ndim == 0 else v
        return self._vector._from_array(self._data[i])

    def __setitem__(self, i, v):
        self._data[i] = v

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __eq__(self, other) -> bool:
        return (type(other) is type(self)
                and np.array_equal(self._data, other._data))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._data.tolist()!r})"

    def __array__(self, dtype=None, copy=None):
        return np.array(self._data, dtype=dtype) if dtype else self._data

    @property
    def shape(self):
        return self._data.shape

    def argmax(self):
        """(row, col) of the maximum element."""
        return tuple(int(x) for x in
                     np.unravel_index(self._data.argmax(), self._data.shape))

    def argmin(self):
        return tuple(int(x) for x in
                     np.unravel_index(self._data.argmin(), self._data.shape))

    def max(self):
        return self._data.max().item()

    def min(self):
        return self._data.min().item()

    def sum(self):
        return self._data.sum().item()

    def copy(self):
        return type(self)._from_array(self._data.copy())


class MatrixD(Matrix):
    _dtype = np.dtype(np.float64)
    _vector = VectorD


class MatrixF(Matrix):
    _dtype = np.dtype(np.float32)
    _vector = VectorF


class MatrixI(Matrix):
    _dtype = np.dtype(np.int32)
    _vector = VectorI


class MatrixU8(Matrix):
    _dtype = np.dtype(np.uint8)
    _vector = VectorU8
