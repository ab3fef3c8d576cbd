"""fvecs/ivecs dataset I/O and timing helpers.

TPU-native replacement for the reference's include/util.h:12-200 (`ReadData`,
`WriteData`, `ReadSize`, `time_cost`) using numpy memory mapping instead of
per-vector ifstream loops. File format is identical: each vector is
[int32 dim][dim * 4 bytes payload].
"""

from __future__ import annotations

import struct
import time
from pathlib import Path

import numpy as np


def read_size(path: str | Path) -> tuple[int, int]:
    """(dim, num) of an fvecs/ivecs file (reference util.h ReadSize)."""
    path = Path(path)
    with open(path, "rb") as f:
        (dim,) = struct.unpack("<i", f.read(4))
    row_bytes = 4 + dim * 4
    size = path.stat().st_size
    if size % row_bytes != 0:
        raise ValueError(f"{path}: size {size} not a multiple of row bytes {row_bytes}")
    return dim, size // row_bytes


def _read_vecs(path: str | Path, dtype, max_num: int | None = None) -> np.ndarray:
    dim, num = read_size(path)
    if max_num is not None:
        num = min(num, max_num)
    raw = np.fromfile(path, dtype=np.int32, count=num * (dim + 1))
    mat = raw.reshape(num, dim + 1)[:, 1:]
    return mat.view(dtype).copy() if dtype != np.int32 else mat.copy()


def read_fvecs(path: str | Path, max_num: int | None = None) -> np.ndarray:
    """float32[num, dim] (reference util.h ReadData for fvecs; partial read
    mirrors main_partial.cc:84-98). Uses the native mmap reader when built."""
    from . import native

    out = native.read_vecs(path, np.float32, max_num or 0)
    if out is not None:
        return out
    return _read_vecs(path, np.float32, max_num)


def read_ivecs(path: str | Path, max_num: int | None = None) -> np.ndarray:
    """int32[num, dim] (groundtruth / knn files)."""
    from . import native

    out = native.read_vecs(path, np.int32, max_num or 0)
    if out is not None:
        return out
    return _read_vecs(path, np.int32, max_num)


def write_fvecs(path: str | Path, data: np.ndarray) -> None:
    _write_vecs(path, np.asarray(data, dtype=np.float32))


def write_ivecs(path: str | Path, data: np.ndarray) -> None:
    _write_vecs(path, np.asarray(data, dtype=np.int32))


def _write_vecs(path: str | Path, data: np.ndarray) -> None:
    """reference util.h WriteData: [dim][payload] per row."""
    num, dim = data.shape
    out = np.empty((num, dim + 1), dtype=np.int32)
    out[:, 0] = dim
    out[:, 1:] = data.view(np.int32)
    out.tofile(path)


class Timer:
    """Millisecond stopwatch (reference util.h time_cost)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def reset(self) -> float:
        ms = self.ms()
        self.t0 = time.perf_counter()
        return ms
