"""The port's proto3 codec (serve/wire.py) against protobuf's generated
``hnsw_slim_tpu/serve/query_pb2.py``: the bytes of each of the six messages
of query.proto equal protobuf's both ways, with -1 labels, empty vectors,
large and negative ids and default values; unpacked repeated fields and
unknown fields decode as protobuf decodes them. Skips where protobuf does
not import."""

import numpy as np
import pytest

from hnsw_slim_tpu_torch.serve import wire

pb = pytest.importorskip("hnsw_slim_tpu.serve.query_pb2")

VECS = [[], [0.0], [1.0, -2.5, 3.25e-8, float("inf"), -0.0],
        list(np.random.default_rng(0).standard_normal(128).astype(np.float32))]


def _f32(v):
    return np.asarray(v, np.float32)


@pytest.mark.parametrize("vec", VECS, ids=["empty", "zero", "awkward", "d128"])
@pytest.mark.parametrize("k", [0, 10, -1, 2**31 - 1])
def test_query_request_bytes(vec, k):
    blob = pb.QueryRequest(vector=vec, k=k).SerializeToString()
    assert wire.encode_query_request(vec, k) == blob
    got_v, got_k = wire.decode_query_request(blob)
    assert got_k == k and np.array_equal(got_v, _f32(vec))


@pytest.mark.parametrize("labels,dist", [
    ([], []), ([3, -1, 9], [0.5, 1.5, float("inf")]),
    ([-1] * 10, [float("inf")] * 10), ([2**31 - 1, -(2**31)], [0.0, -0.0])])
def test_query_response_bytes(labels, dist):
    blob = pb.QueryResponse(labels=labels, distances=dist).SerializeToString()
    assert wire.encode_query_response(np.asarray(labels, np.int64),
                                      _f32(dist)) == blob
    got_l, got_d = wire.decode_query_response(blob)
    assert got_l.tolist() == labels
    assert np.array_equal(got_d.view(np.uint32), _f32(dist).view(np.uint32))


@pytest.mark.parametrize("ef", [0, 64, 320, -5])
def test_set_ef_messages_bytes(ef):
    blob = pb.SetEfRequest(ef_search=ef).SerializeToString()
    assert wire.encode_set_ef_request(ef) == blob
    assert wire.decode_set_ef_request(blob) == ef
    for status in ("ok", "", "error: ü"):
        blob = pb.SetEfResponse(status=status,
                                new_ef_search=ef).SerializeToString()
        assert wire.encode_set_ef_response(status, ef) == blob
        assert wire.decode_set_ef_response(blob) == (status, ef)


@pytest.mark.parametrize("ids", [[0], [42, 0, 7], [-1, 2**40, -(2**62)],
                                 list(range(1000, 1004))])
def test_vector_data_and_update_request_bytes(ids):
    vecs = [VECS[i % len(VECS)] for i in range(len(ids))]
    for i, v in zip(ids, vecs):
        blob = pb.VectorData(id=i, vector=v).SerializeToString()
        assert wire.encode_vector_data(i, v) == blob
        got_i, got_v = wire.decode_vector_data(blob)
        assert got_i == i and np.array_equal(got_v, _f32(v))
    msg = pb.UpdateIndexRequest(
        vectors=[pb.VectorData(id=i, vector=v) for i, v in zip(ids, vecs)])
    blob = msg.SerializeToString()
    assert wire.encode_update_index_request(ids, vecs) == blob
    got_ids, got_vecs = wire.decode_update_index_request(blob)
    assert got_ids == ids
    assert all(np.array_equal(a, _f32(b)) for a, b in zip(got_vecs, vecs))
    assert wire.encode_update_index_request([], []) == \
        pb.UpdateIndexRequest().SerializeToString()


def test_unpacked_and_unknown_fields_decode_as_protobuf():
    """A writer may send repeated scalars unpacked and fields this schema
    does not know; both parsers take the same values from such bytes."""
    raw = (wire._key(1, wire.VARINT) + wire._varint(5)
           + wire._key(1, wire.VARINT) + wire._varint(-1)
           + wire._key(9, wire.LEN) + wire._varint(2) + b"zz"
           + wire._key(2, wire.I32) + _f32([1.5]).tobytes()
           + wire._key(2, wire.LEN) + wire._varint(8)
           + _f32([2.0, 3.0]).tobytes())
    ref = pb.QueryResponse()
    ref.ParseFromString(raw)
    labels, dist = wire.decode_query_response(raw)
    assert labels.tolist() == list(ref.labels) == [5, -1]
    assert dist.tolist() == list(ref.distances) == [1.5, 2.0, 3.0]
