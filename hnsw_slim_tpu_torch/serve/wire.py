"""The wire messages of ``serve/query.proto`` as a small proto3 codec.

The JAX package serializes with protobuf's generated ``query_pb2``; the
port writes the same bytes itself, so that it needs no protobuf package:

    QueryRequest        1: repeated float vector (packed), 2: int32 k
    QueryResponse       1: repeated int32 labels (packed), 2: repeated float
                        distances (packed)
    SetEfRequest        1: int32 ef_search
    SetEfResponse       1: string status, 2: int32 new_ef_search
    VectorData          1: int64 id, 2: repeated float vector (packed)
    UpdateIndexRequest  1: repeated VectorData vectors

As proto3 writes them: fields in number order, a scalar at its default
(0, "") and an empty repeated field left out, repeated scalars packed, a
negative int32 or int64 as a ten-byte sign-extended varint, floats as
little-endian f32. The decoders also take unpacked repeated scalars and skip
unknown fields, as protobuf parsers do.
"""

from __future__ import annotations

import numpy as np

VARINT, I64, LEN, I32 = 0, 1, 2, 5
_M64 = (1 << 64) - 1


def _varint(v: int) -> bytes:
    v &= _M64  # negatives: two's complement over 64 bits, ten bytes
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint(field << 3 | wire_type)


def _int(field: int, v: int) -> bytes:
    return _key(field, VARINT) + _varint(int(v)) if v else b""


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, LEN) + _varint(len(data)) + data


def _floats(field: int, values) -> bytes:
    a = np.asarray(values, "<f4").reshape(-1)
    return _bytes(field, a.tobytes()) if a.size else b""


def _ints(field: int, values) -> bytes:
    vals = [int(v) for v in np.asarray(values).reshape(-1)]
    return _bytes(field, b"".join(map(_varint, vals))) if vals else b""


def _read_varint(buf, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _fields(buf):
    """(field, wire type, value) of each record: an int for a varint, the
    raw bytes for the other wire types."""
    buf = memoryview(buf)
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == VARINT:
            v, pos = _read_varint(buf, pos)
        elif wt == LEN:
            n, pos = _read_varint(buf, pos)
            v = buf[pos:pos + n]
            pos += n
        elif wt in (I64, I32):
            n = 8 if wt == I64 else 4
            v = buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if pos > len(buf):
            raise ValueError("truncated message")
        yield field, wt, v


def _add_floats(acc: list, wt: int, v) -> None:
    if wt not in (LEN, I32):  # packed, or one unpacked fixed32
        raise ValueError("float field with a varint")
    acc.append(np.frombuffer(bytes(v), "<f4"))


def _add_ints(acc: list, wt: int, v, bits: int) -> None:
    if wt == VARINT:
        acc.append(_signed(v, bits))
    elif wt == LEN:
        pos, raw = 0, bytes(v)
        while pos < len(raw):
            x, pos = _read_varint(raw, pos)
            acc.append(_signed(x, bits))
    else:
        raise ValueError("integer field with a fixed-width value")


def _float_array(parts: list) -> np.ndarray:
    return (np.concatenate(parts).astype(np.float32) if parts
            else np.zeros(0, np.float32))


# ---- the six messages ---------------------------------------------------


def encode_query_request(vector, k: int) -> bytes:
    return _floats(1, vector) + _int(2, k)


def decode_query_request(buf) -> tuple[np.ndarray, int]:
    """(vector f32[d], k; 0 when unset)."""
    vec, k = [], 0
    for f, wt, v in _fields(buf):
        if f == 1:
            _add_floats(vec, wt, v)
        elif f == 2 and wt == VARINT:
            k = _signed(v, 32)
    return _float_array(vec), k


def encode_query_response(labels, distances) -> bytes:
    return _ints(1, labels) + _floats(2, distances)


def decode_query_response(buf) -> tuple[np.ndarray, np.ndarray]:
    """(labels i64[k], distances f32[k])."""
    labels, dist = [], []
    for f, wt, v in _fields(buf):
        if f == 1:
            _add_ints(labels, wt, v, 32)
        elif f == 2:
            _add_floats(dist, wt, v)
    return np.asarray(labels, np.int64), _float_array(dist)


def encode_set_ef_request(ef_search: int) -> bytes:
    return _int(1, ef_search)


def decode_set_ef_request(buf) -> int:
    ef = 0
    for f, wt, v in _fields(buf):
        if f == 1 and wt == VARINT:
            ef = _signed(v, 32)
    return ef


def encode_set_ef_response(status: str, new_ef_search: int) -> bytes:
    s = status.encode()
    return (_bytes(1, s) if s else b"") + _int(2, new_ef_search)


def decode_set_ef_response(buf) -> tuple[str, int]:
    status, ef = "", 0
    for f, wt, v in _fields(buf):
        if f == 1 and wt == LEN:
            status = bytes(v).decode()
        elif f == 2 and wt == VARINT:
            ef = _signed(v, 32)
    return status, ef


def encode_vector_data(id_: int, vector) -> bytes:
    return _int(1, id_) + _floats(2, vector)


def decode_vector_data(buf) -> tuple[int, np.ndarray]:
    id_, vec = 0, []
    for f, wt, v in _fields(buf):
        if f == 1 and wt == VARINT:
            id_ = _signed(v, 64)
        elif f == 2:
            _add_floats(vec, wt, v)
    return id_, _float_array(vec)


def encode_update_index_request(ids, vectors) -> bytes:
    return b"".join(_bytes(1, encode_vector_data(i, v))
                    for i, v in zip(ids, vectors))


def decode_update_index_request(buf) -> tuple[list[int], list[np.ndarray]]:
    """(ids, vectors), one entry per VectorData, in order."""
    ids, vecs = [], []
    for f, wt, v in _fields(buf):
        if f == 1 and wt == LEN:
            i, vec = decode_vector_data(v)
            ids.append(i)
            vecs.append(vec)
    return ids, vecs

