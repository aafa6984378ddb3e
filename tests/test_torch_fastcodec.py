"""The port's native JSON codec (seldon_core_tpu_torch/native/csrc/
fastcodec.cpp through native/fastcodec.py and the messages.py hooks):
the cases of tests/test_fastcodec.py through the port's binding, its parse
held to the JAX package's codec and to json.loads on the same bytes, and
its one change: NaN and the infinities written as Python's json writes
them, where the reference's formatter writes ``nan``."""

import json
import shutil

import numpy as np
import pytest
import torch

from seldon_core_tpu.native import fastcodec as jax_fastcodec
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.native import fastcodec
from seldon_core_tpu_torch.native.fastcodec import (
    codec_status,
    format_data_fragment,
    native_available,
    parse_message_fast,
)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the codec")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def pyparse(s):
    return SeldonMessage.from_json_dict(json.loads(s))


# tests/test_fastcodec.py's cases
CASES = [
    '{"data":{"ndarray":[[1.0,2.5],[3.0,-4.25]]}}',
    '{"data":{"names":["a","b"],"tensor":{"shape":[2,2],"values":[1,2,3,4.5e-3]}}}',
    '{"meta":{"puid":"x","tags":{"k":"v","n":1.5},"routing":{"r":0}},"data":{"ndarray":[1,2,3]}}',
    '{"strData":"hello"}',
    '{"binData":"aGVsbG8="}',
    '{"data":{"ndarray":[[1,2],[3]]}}',
    '{"data":{"ndarray":[1,[2]]}}',
    '{"data":{"ndarray":[[1],[[2]]]}}',
    '{"data":{"ndarray":[NaN,1]}}',
    '{"data":{"ndarray":[]}}',
    '{"data":{"ndarray":[[]]}}',
    '{"data":{"tensor":{"shape":[0],"values":[]}}}',
    '{"status":{"code":500,"status":"FAILURE","info":"boom"},"meta":{"puid":"p"}}',
    '{"data":null,"strData":"s"}',
    '{  "data" : { "ndarray" : [ 1 , 2 ] } }',
    '{"data":{"ndarray":[1e308,-1e-308,0.1,123456789012345678901234567890.5]}}',
    '{"meta":{"tags":{"weird":{"nested":[1,"two"]}}},"data":{"ndarray":[7]}}',
    '{"meta":{"tags":{"trick":"\\"__payload__\\":0"}},"data":{"ndarray":[1,2]}}',
]


def test_the_codec_builds_and_loads_the_extension():
    assert native_available()
    assert codec_status() == {"binding": "extension", "errors": {}}


@pytest.mark.parametrize("s", CASES)
def test_parse_matches_python_path(s):
    a = SeldonMessage.from_json(s)
    b = pyparse(s)
    assert a.data is None if b.data is None else a.data is not None
    if a.data is not None:
        na, nb = a.data.numpy(), b.data.numpy()
        assert a.data.kind == b.data.kind and a.data.names == b.data.names
        assert na.shape == nb.shape
        if na.dtype != object:
            np.testing.assert_array_equal(na.astype(np.float64), nb.astype(np.float64))
    assert a.meta == b.meta and a.status == b.status
    assert (a.str_data, a.bin_data) == (b.str_data, b.bin_data)


@pytest.mark.parametrize("s", CASES)
def test_parse_matches_the_jax_codec_and_json_loads(s):
    """The port's parse of the same bytes is the reference codec's: the
    same envelope, kind and float64 payload bits, both declining the same
    documents; a taken payload equals json.loads's numbers."""
    got, ref = parse_message_fast(s), jax_fastcodec.parse_message_fast(s)
    assert (got is None) == (ref is None)
    if got is None:
        return
    assert got[0] == ref[0] and got[1] == ref[1]
    if got[2] is not None:
        assert got[2].dtype == ref[2].dtype == np.float64
        assert got[2].shape == ref[2].shape
        assert got[2].tobytes() == ref[2].tobytes()
        data = json.loads(s)["data"]
        want = data["ndarray"] if "ndarray" in data else data["tensor"]["values"]
        np.testing.assert_array_equal(got[2].reshape(-1), np.asarray(want, dtype=np.float64)
                                      .reshape(-1))


@pytest.mark.parametrize("s", CASES)
def test_serialize_reparses_identically(s):
    m = SeldonMessage.from_json(s)
    back = SeldonMessage.from_json(m.to_json())
    assert back.data is None if m.data is None else back.data.kind == m.data.kind
    if m.data is not None and m.data.numpy().dtype != object:
        np.testing.assert_array_equal(back.array().astype(np.float64),
                                      m.array().astype(np.float64))
    assert back.meta == m.meta


@pytest.mark.parametrize("bad", ["{", '{"data":{"ndarray":[1,}}', "null", "[1,2]", "",
                                 '{"data":{"tensor":{"shape":[3],"values":[1,2]}}}'])
def test_invalid_inputs_still_raise(bad):
    with pytest.raises(Exception):
        SeldonMessage.from_json(bad)


def test_fuzz_roundtrip_exact():
    rng = np.random.default_rng(0)
    for trial in range(100):
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(x) for x in rng.integers(1, 6, ndim))
        arr = rng.standard_normal(shape) * 10.0 ** rng.integers(-200, 200)
        m = SeldonMessage.from_array(arr, kind=["tensor", "ndarray"][trial % 2])
        s = m.to_json()
        np.testing.assert_array_equal(SeldonMessage.from_json(s).array(), arr)
        np.testing.assert_array_equal(pyparse(s).array(), arr)
        s2 = json.dumps(m.to_json_dict(), separators=(",", ":"))
        np.testing.assert_array_equal(SeldonMessage.from_json(s2).array(), arr)


def test_float32_tails_roundtrip():
    arr = np.float32(np.random.default_rng(3).standard_normal((8, 16))).astype(np.float64)
    m = SeldonMessage.from_array(arr)
    np.testing.assert_array_equal(SeldonMessage.from_json(m.to_json()).array(), arr)


def test_fragment_formatter_direct():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    assert json.loads("{%s}" % format_data_fragment(a, "ndarray").decode()) == {
        "ndarray": a.tolist()}
    d = json.loads("{%s}" % format_data_fragment(a, "tensor").decode())
    assert d["tensor"] == {"shape": [2, 3], "values": a.reshape(-1).tolist()}


def test_parser_declines_exotics():
    assert parse_message_fast('{"data":{"ndarray":[[1,2],[3]]}}') is None
    assert parse_message_fast('{"data":{"ndarray":["a"]}}') is None
    assert parse_message_fast("not json") is None


@pytest.mark.parametrize("bad_number", ["+1", ".5", "1.", "01", "0 1", "1e", "--1"])
def test_strict_number_grammar_matches_json_loads(bad_number):
    s = '{"data":{"ndarray":[%s]}}' % bad_number
    assert parse_message_fast(s) is None
    with pytest.raises(Exception):
        SeldonMessage.from_json(s)


def test_escaped_keys_fall_back_to_python():
    s = '{"data":{"\\u006edarray":[1.0,2.0]}}'
    assert parse_message_fast(s) is None
    np.testing.assert_array_equal(SeldonMessage.from_json(s).array(), [1.0, 2.0])


def test_int_bool_ndarray_wire_form_preserved():
    for arr in (np.arange(64), np.ones(64, dtype=bool)):
        m = SeldonMessage.from_array(arr, kind="ndarray")
        assert json.loads(m.to_json())["data"]["ndarray"] == arr.tolist()


def test_payload_placeholder_key_in_tags():
    m = SeldonMessage.from_array(np.arange(64, dtype=np.float64))
    m.meta.tags = {"__payload__": 0}
    d = json.loads(m.to_json())
    assert d["meta"]["tags"] == {"__payload__": 0}
    np.testing.assert_array_equal(np.asarray(d["data"]["tensor"]["values"]), np.arange(64.0))


def test_format_negative_zero_keeps_sign():
    frag = format_data_fragment(np.array([[-0.0] * 4]), "ndarray")
    assert frag is not None and b"-0.0" in frag


def test_format_empty_array_nesting_matches_numpy():
    for shape in ((2, 0), (0, 5), (2, 3, 0), (1, 0, 4)):
        frag = format_data_fragment(np.empty(shape), "ndarray")
        want = json.dumps(np.empty(shape).tolist(), separators=(",", ":"))
        assert frag == ('"ndarray":%s' % want).encode(), (shape, frag)


def test_parse_duplicate_data_key_defers_to_python():
    assert parse_message_fast('{"data":{"ndarray":[1,2]},"data":null}') is None
    r = parse_message_fast('{"data":null,"data":{"ndarray":[1.0,2.0]}}')
    assert r is not None and r[2].tolist() == [1.0, 2.0]
    assert SeldonMessage.from_json('{"data":{"ndarray":[1,2]},"data":null}').data is None
    assert SeldonMessage.from_json(
        '{"data":null,"data":{"ndarray":[1.0,2.0]}}').array().tolist() == [1.0, 2.0]


# -- the port's own: NaN, the infinities and -0.0 ------------------------------

SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -5e-324])


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_nan_and_infinities_are_json_s_spelling_and_read_back_bit_exact(kind):
    """NaN, +-Infinity and -0.0 from the port's formatter parse back (with
    json.loads and with the codec) to the same float64 bits (a NaN as a
    NaN: json writes no sign of one), and the fragment is the json module's
    text; the reference's formatter writes ``nan``, which json.loads does
    not read."""
    frag = format_data_fragment(SPECIALS.reshape(1, -1), kind)
    assert b"nan" not in frag and b"inf" not in frag
    assert b"NaN" in frag and b"-Infinity" in frag and b"Infinity" in frag
    doc = json.loads("{%s}" % frag.decode())
    vals = doc["ndarray"][0] if kind == "ndarray" else doc["tensor"]["values"]
    back = np.asarray(vals, dtype=np.float64)
    finite = ~np.isnan(SPECIALS)
    assert back[finite].tobytes() == SPECIALS[finite].tobytes()
    assert np.isnan(back[~finite]).all()
    ref = jax_fastcodec.format_data_fragment(SPECIALS.reshape(1, -1), kind)
    assert b"nan" in ref  # the reference's spelling, no JSON
    with pytest.raises(json.JSONDecodeError):
        json.loads("{%s}" % ref.decode())
    # a whole message through the codec's writer reads back as json's does
    msg = SeldonMessage.from_array(np.tile(SPECIALS, (4, 1)), kind=kind)
    text = msg.to_json()
    assert b"NaN" in text.encode() and text != json.dumps(msg.to_json_dict())  # the C++ writer
    back = pyparse(text).array()
    assert back[:, finite].tobytes() == np.tile(SPECIALS, (4, 1))[:, finite].tobytes()
    assert np.isnan(back[:, ~finite]).all()


def test_a_codec_that_cannot_build_is_recorded_and_the_json_path_serves(monkeypatch):
    """A failed build is recorded with its error (``codec_status``), never
    dropped, and every call falls back to the json path."""
    def broken(name):
        raise RuntimeError(f"g++ failed to build {name} (exit 1):\nfatal error: Python.h")

    monkeypatch.setattr(fastcodec._build, "build", broken)
    monkeypatch.setattr(fastcodec, "_attempted", False)
    monkeypatch.setattr(fastcodec, "_ext", None)
    monkeypatch.setattr(fastcodec, "_lib", None)
    monkeypatch.setattr(fastcodec, "_ERRORS", {})
    status = codec_status()
    assert status["binding"] is None
    assert set(status["errors"]) == {"fastcodec_pymod", "fastcodec"}
    assert "Python.h" in status["errors"]["fastcodec_pymod"]
    assert parse_message_fast('{"data":{"ndarray":[1]}}') is None
    assert SeldonMessage.from_json('{"data":{"ndarray":[1.5]}}').array().tolist() == [1.5]
