"""The port's stdlib protobuf codec (``protoconv.py``) against
``google.protobuf`` with the JAX package's ``prediction_pb2``, both ways,
on seeded payloads: every data kind (tensor, ndarray nested with strings,
bools and nulls, strData, binData), FAILURE statuses, tags of every Value
kind, routing, requestPath, SeldonMessageList and Feedback; and the gRPC
fast lane's wire scan (``native/protowire.py``) against the reference's,
byte for byte."""

import base64
import json

import numpy as np
import pytest

from seldon_core_tpu import protoconv as ref
from seldon_core_tpu.messages import Feedback as JaxFeedback
from seldon_core_tpu.messages import SeldonMessage as JaxMessage
from seldon_core_tpu.messages import SeldonMessageError as JaxMessageError
from seldon_core_tpu.messages import SeldonMessageList as JaxMessageList
from seldon_core_tpu.native import protowire as ref_protowire
from seldon_core_tpu.proto_gen import prediction_pb2 as pb
from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.messages import (
    Feedback,
    SeldonMessage,
    SeldonMessageError,
    SeldonMessageList,
)
from seldon_core_tpu_torch.native import protowire

SEEDS = range(24)


def _text(rng) -> str:
    alphabet = "abcxyz_-. 0123456789é€漢"
    return "".join(rng.choice(list(alphabet), size=int(rng.integers(0, 9))))


def _value(rng, depth=0):
    kind = int(rng.integers(0, 6 if depth < 2 else 4))
    if kind == 0:
        return None
    if kind == 1:
        return float(np.round(rng.standard_normal() * 100, 3))
    if kind == 2:
        return _text(rng)
    if kind == 3:
        return bool(rng.integers(0, 2))
    if kind == 4:
        return {_text(rng) + str(i): _value(rng, depth + 1) for i in range(int(rng.integers(0, 3)))}
    return [_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]


def _doc(seed: int) -> dict:
    """A seeded SeldonMessage JSON document: one payload kind of six, a meta
    with tags of every Value kind, routing and requestPath, and sometimes a
    status (FAILURE among them)."""
    rng = np.random.default_rng(seed)
    doc: dict = {"meta": {"puid": _text(rng)}}
    if rng.random() < 0.8:
        doc["meta"]["tags"] = {f"t{i}": _value(rng) for i in range(int(rng.integers(0, 5)))}
        doc["meta"]["routing"] = {f"r{i}": int(rng.integers(-2, 5))
                                  for i in range(int(rng.integers(0, 3)))}
        doc["meta"]["requestPath"] = {f"n{i}": _text(rng) for i in range(int(rng.integers(0, 3)))}
    if rng.random() < 0.4:
        failure = rng.random() < 0.5
        doc["status"] = {"code": int(rng.choice([200, 400, 500, 503])) if failure else 200,
                         "info": _text(rng) if failure else "",
                         "status": "FAILURE" if failure else "SUCCESS"}
    kind = seed % 6
    shape = tuple(int(d) for d in rng.integers(1, 5, size=int(rng.integers(1, 4))))
    if kind == 0:
        x = np.round(rng.standard_normal(shape), 4)
        doc["data"] = {"tensor": {"shape": list(shape), "values": x.ravel().tolist()}}
    elif kind == 1:
        doc["data"] = {"ndarray": np.round(rng.standard_normal(shape), 4).tolist()}
    elif kind == 2:  # nested, strings, bools and nulls: an object ndarray
        doc["data"] = {"ndarray": [[_text(rng), bool(rng.integers(0, 2)), None, 1.5],
                                   [_value(rng, 1), "x"]]}
    elif kind == 3:
        doc["strData"] = _text(rng)
    elif kind == 4:
        doc["binData"] = base64.b64encode(rng.bytes(int(rng.integers(0, 40)))).decode()
    if "data" in doc and rng.random() < 0.5:
        doc["data"]["names"] = [_text(rng) for _ in range(int(rng.integers(1, 4)))]
    return doc


def _same(ours_json: str, theirs_json: str) -> bool:
    # map order is not part of the protobuf contract: compare parsed
    return json.loads(ours_json) == json.loads(theirs_json)


@pytest.mark.parametrize("seed", SEEDS)
def test_port_bytes_parse_to_the_reference_proto(seed):
    doc = _doc(seed)
    ours = protoconv.msg_to_proto(SeldonMessage.from_json_dict(doc))
    assert pb.SeldonMessage.FromString(ours) == ref.msg_to_proto(JaxMessage.from_json_dict(doc))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_bytes_decode_to_the_reference_message(seed):
    wire = ref.msg_to_proto(JaxMessage.from_json_dict(_doc(seed)))
    ours = protoconv.msg_from_proto(wire.SerializeToString())
    assert _same(ours.to_json(), ref.msg_from_proto(wire).to_json())
    if ours.data is not None:
        assert ours.data.kind == wire.data.WhichOneof("data_oneof")


def test_values_of_every_kind_round_trip():
    tags = {"null": None, "num": -2.5, "int": 7, "str": "s", "bool": True,
            "struct": {"a": [1, {"b": None}], "c": "d"}, "list": [False, "x", 3.0, []],
            "empty_struct": {}, "empty_list": []}
    msg = SeldonMessage.from_json_dict({"meta": {"puid": "v", "tags": tags}, "strData": ""})
    want = ref.msg_to_proto(JaxMessage.from_json_dict(
        {"meta": {"puid": "v", "tags": tags}, "strData": ""}))
    assert pb.SeldonMessage.FromString(protoconv.msg_to_proto(msg)) == want
    back = protoconv.msg_from_proto(want.SerializeToString())
    assert back.meta.tags == ref.msg_from_proto(want).meta.tags
    assert back.str_data == "" and back.data is None


@pytest.mark.parametrize("seed", range(6))
def test_message_lists_and_feedback_both_ways(seed):
    docs = [_doc(seed * 7 + i) for i in range(3)]
    ml = protoconv.msg_list_to_proto(SeldonMessageList.from_json_dict(
        {"seldonMessages": docs}))
    want = ref.msg_list_to_proto(JaxMessageList.from_json_dict({"seldonMessages": docs}))
    assert pb.SeldonMessageList.FromString(ml) == want
    back = protoconv.msg_list_from_proto(want.SerializeToString())
    assert _same(back.to_json(), ref.msg_list_from_proto(want).to_json())
    reward = [0.0, -0.0, 0.1, 3.5, -1e-3, 1e30][seed]
    fb_doc = {"request": docs[0], "response": docs[1], "reward": reward, "truth": docs[2]}
    if seed % 2:
        del fb_doc["truth"]
    fb = protoconv.feedback_to_proto(Feedback.from_json_dict(fb_doc))
    fb_want = ref.feedback_to_proto(JaxFeedback.from_json_dict(fb_doc))
    assert pb.Feedback.FromString(fb) == fb_want
    fb_back = protoconv.feedback_from_proto(fb_want.SerializeToString())
    fb_ref = ref.feedback_from_proto(fb_want)
    assert fb_back.reward == fb_ref.reward  # the float32 value, as a Python float
    assert _same(fb_back.to_json(), fb_ref.to_json())


@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_numeric_rows_are_the_reference_bytes(kind):
    """Numeric payloads (the lanes' common case) are written exactly as
    upb writes them, so the bytes compare whole."""
    x = np.random.default_rng(9).standard_normal((3, 5))
    doc = {"meta": {"puid": "b"}, "data": {"names": list("abcde"), kind: (
        {"shape": [3, 5], "values": x.ravel().tolist()} if kind == "tensor" else x.tolist())}}
    ours = protoconv.msg_to_proto(SeldonMessage.from_json_dict(doc))
    assert ours == ref.msg_to_proto(JaxMessage.from_json_dict(doc)).SerializeToString()
    back = protoconv.msg_from_proto(ours)
    assert back.data.kind == kind and np.array_equal(back.array(), x)


@pytest.mark.parametrize("name,body", [
    ("truncated_len", b"\x1a\x05\x12"),
    ("truncated_varint", b"\x0a\xff"),
    ("varint_too_long", b"\x08" + b"\xff" * 11),
    ("wire_type_7", b"garbage!"),
    ("invalid_utf8", b"\x2a\x02\xc3\x28"),
    ("field_zero", b"\x00\x01"),
])
def test_malformed_bytes_are_a_typed_400(name, body):
    with pytest.raises(Exception):
        pb.SeldonMessage.FromString(body)
    with pytest.raises(protoconv.ProtoDecodeError) as e:
        protoconv.msg_from_proto(body)
    assert e.value.http_code == 400


def test_merge_rules_of_repeated_fields():
    """A repeated singular message merges, the last scalar and the last
    oneof member win, unknown fields are skipped, as protobuf parses."""
    a = ref.msg_to_proto(JaxMessage.from_json_dict(
        {"meta": {"puid": "one", "tags": {"a": 1}}, "strData": "s"}))
    b = ref.msg_to_proto(JaxMessage.from_json_dict(
        {"meta": {"tags": {"b": 2}}, "data": {"tensor": {"shape": [1], "values": [4]}}}))
    body = a.SerializeToString() + b.SerializeToString() + b"\xa0\x06\x05"  # field 100
    want = pb.SeldonMessage.FromString(body)
    got = protoconv.msg_from_proto(body)
    assert _same(got.to_json(), ref.msg_from_proto(want).to_json())
    assert got.meta.puid == "one" and got.meta.tags == {"a": 1.0, "b": 2.0}


def test_a_shape_that_disagrees_is_a_seldon_error():
    body = pb.SeldonMessage()
    body.data.tensor.shape.extend([2, 3])
    body.data.tensor.values.extend([1.0, 2.0])
    with pytest.raises(JaxMessageError) as want:
        ref.msg_from_proto(body)
    with pytest.raises(SeldonMessageError) as got:
        protoconv.msg_from_proto(body.SerializeToString())
    assert str(got.value) == str(want.value) and got.value.http_code == 400


@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("names", [[], ["c0", "c1"]])
def test_tensor_fast_lane_bytes_match_the_reference(rows, names):
    """``build_tensor_response`` writes the reference's bytes and
    ``parse_tensor_request`` scans a request to the same puid and rows."""
    y = np.random.default_rng(rows).random((rows, 10))
    frag = protowire.names_fragment(names)
    assert frag == ref_protowire.names_fragment(names)
    ours = protowire.build_tensor_response("puid-x", y, frag)
    assert ours == ref_protowire.build_tensor_response("puid-x", y, frag)
    assert pb.SeldonMessage.FromString(ours).data.names == names
    req = ref.msg_to_proto(JaxMessage.from_json_dict(
        {"meta": {"puid": "q"}, "data": {"tensor": {"shape": [rows, 10],
                                                    "values": y.ravel().tolist()}}}))
    got = protowire.parse_tensor_request(req.SerializeToString())
    want = ref_protowire.parse_tensor_request(req.SerializeToString())
    assert got[0] == want[0] == "q" and np.array_equal(got[1], want[1])
    # anything unusual declines to the object lane in both
    tagged = req.SerializeToString() + b"\x12\x0b\x12\x09\n\x01k\x12\x04\x1a\x02vv"
    assert protowire.parse_tensor_request(tagged) is None
    assert ref_protowire.parse_tensor_request(tagged) is None
