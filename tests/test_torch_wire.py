"""The port's wire-v3 codec (``znicz_torch/parallel/wire.py``) against the
reference's (``znicz_tpu/parallel/wire.py``) on the CPU.

One format for both packages: the same message gives the same frames
byte for byte (the tensor slot is pickled under the reference's global
name), each package decodes the other's, undecodable stacks raise
``WireError`` with the same words, ``DeltaEncoder``'s error feedback
keeps the same bits, and a port process decodes a reference frame stack
without the JAX package ever entering ``sys.modules``.  Every comparison
is exact: the codec copies bits."""

import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from znicz_torch.parallel import wire as tw
from znicz_tpu.parallel import wire as jw

REPO = pathlib.Path(__file__).resolve().parent.parent


def _message(mod, seed=0):
    """A message with raw, bf16, int8 and compressible tensors, 0-d and
    empty arrays, nested lists and tuples, built with ``mod``'s
    quantizer."""
    rng = np.random.default_rng(seed)
    return {
        "cmd": "infer", "req_id": 17, "deadline_ms": 250.0,
        "client": "c-1", "trace_id": "abc-17",
        "x": rng.normal(size=(3, 5, 2)).astype(np.float32),
        "u8": rng.integers(0, 255, size=(4, 7), dtype=np.uint8),
        "zeros": np.zeros((64, 32), np.float32),      # compresses
        "scalar": np.array(2.5, np.float64),
        "empty": np.zeros((0, 3), np.int32),
        "bf16": mod.quantize(rng.normal(size=(6, 4)), "bfloat16"),
        "int8": mod.quantize(rng.normal(size=(9,)), "int8"),
        "nested": [np.arange(5, dtype=np.int64),
                   (np.ones((2, 2), np.float16), {"k": [1, 2.0, None]}),
                   "text", True],
    }


def _frames(frames):
    return [bytes(f) for f in frames]


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("compress", [None, "zlib", "lz4"])
def test_frames_byte_identical_both_ways(compress):
    port, pinfo = tw.encode_message(_message(tw), compress=compress)
    ref, rinfo = jw.encode_message(_message(jw), compress=compress)
    assert _frames(port) == _frames(ref)
    assert pinfo == rinfo and pinfo["tensors"] == 9
    assert b"znicz_tpu.parallel.wire" in _frames(port)[0]
    assert b"znicz_torch" not in _frames(port)[0]
    if compress == "zlib":
        assert pinfo["wire_bytes"] < pinfo["raw_bytes"]
    # each package decodes the other's frames to the same message
    got_p, info_p = tw.decode_message(_frames(ref))
    got_j, info_j = jw.decode_message(_frames(port))
    _same(got_p, got_j)
    assert info_p == info_j and not info_p["legacy"]
    assert got_p["scalar"].shape == () and got_p["empty"].shape == (0, 3)
    np.testing.assert_array_equal(got_p["x"], _message(tw)["x"])
    np.testing.assert_array_equal(got_p["bf16"],
                                  tw.dequantize(_message(tw)["bf16"]))


@pytest.mark.parametrize("wire_dtype", ["float32", "bf16", "int8"])
def test_delta_encoder_error_feedback_same_bits(wire_dtype):
    """Ten updates through each package's ``DeltaEncoder``: the encoded
    frames and the residuals are the same bits, and the sum of what was
    shipped tracks the true sum within one step's quantization error."""
    rng = np.random.default_rng(5)
    encoders = (tw.DeltaEncoder(wire_dtype), jw.DeltaEncoder(wire_dtype))
    assert encoders[0].wire_dtype == encoders[1].wire_dtype
    shipped, true = np.zeros((8, 3)), np.zeros((8, 3))
    for step in range(10):
        deltas = {"fc": {"weights": rng.normal(size=(8, 3)).astype(
            np.float32) * 1e-2, "bias": rng.normal(size=(3,)).astype(
                np.float32)}}
        if step == 4:
            deltas["fc"]["bias"][1] = np.nan       # ships raw
        frames = [_frames(mod.encode_message(enc.encode(deltas))[0])
                  for mod, enc in zip((tw, jw), encoders)]
        assert frames[0] == frames[1]
        for key in encoders[1].residuals:
            assert encoders[0].residuals[key].tobytes() \
                == encoders[1].residuals[key].tobytes()
        dec, _ = tw.decode_message(frames[0])
        shipped += dec["fc"]["weights"]
        true += deltas["fc"]["weights"]
    assert ("fc", "weights") in encoders[0].residuals \
        or wire_dtype == "float32"
    step_err = {"float32": 0.0, "bf16": 2e-4, "int8": 3e-4}[wire_dtype]
    assert np.abs(shipped - true).max() <= step_err


def _corruptions():
    good = _frames(tw.encode_message(_message(tw))[0])
    return {
        "empty_stack": [],
        "torn_meta": [good[0][:len(good[0]) // 2]] + good[1:],
        "short_tensor": good[:1] + [good[1][:-4]] + good[2:],
        "long_tensor": good[:1] + [good[1] + b"\0"] + good[2:],
        "missing_frame": good[:-1],
        "extra_frame": good + [b"x"],
        "magic_only": [jw.MAGIC],
        "garbage_multi": [b"\xff garbage", b"more"],
        "bad_encoding": [jw.MAGIC + pickle.dumps(
            {"m": {}, "t": [{"w": "float8", "shape": (1,), "d": "<f4",
                             "n": 4}]}), b"\0" * 4],
        "bad_tag": [jw.MAGIC + pickle.dumps(
            {"m": {}, "t": [{"w": "raw", "shape": (1,), "d": "<f4",
                             "n": 4, "c": "brotli"}]}), b"\0" * 4],
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_corrupted_and_short_frames_raise_the_same_words(case):
    frames = _corruptions()[case]
    errors = []
    for mod in (tw, jw):
        with pytest.raises(mod.WireError) as info:
            mod.decode_message(list(frames))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_legacy_frames_decode_and_refuse_alike():
    """A one-frame v2 pickle decodes as ``legacy`` in both packages; a
    non-v3 stack is refused by ``peek_message`` and ``restamp_message``
    in the same words, and so is undecodable legacy garbage."""
    legacy = [pickle.dumps({"cmd": "ping", "req_id": 3,
                            "x": np.arange(3)})]
    out = [mod.decode_message(legacy) for mod in (tw, jw)]
    _same(out[0][0], out[1][0])
    assert out[0][1]["legacy"] and out[1][1]["legacy"]
    for fn in ("peek_message", "restamp_message"):
        words = []
        for mod in (tw, jw):
            with pytest.raises(mod.WireError) as info:
                getattr(mod, fn)(legacy)
            words.append(str(info.value))
        assert words[0] == words[1] and "magic" in words[0]
    words = []
    for mod in (tw, jw):
        with pytest.raises(mod.WireError) as info:
            mod.decode_message([b"\x80\x05not a pickle"])
        words.append(str(info.value).split(":")[0])
    assert words[0] == words[1] == "bad frame"


def test_peek_and_restamp_match_the_reference():
    frames = _frames(tw.encode_message(_message(tw))[0])
    skel = tw.peek_message(frames)
    assert isinstance(skel["x"], tw._Slot) and skel["req_id"] == 17
    assert jw.peek_message(frames)["req_id"] == 17
    port = _frames(tw.restamp_message(frames, req_id=99, client=None,
                                      lb="b1"))
    ref = _frames(jw.restamp_message(frames, req_id=99, client=None,
                                     lb="b1"))
    assert port == ref and port[1:] == frames[1:]
    msg, _ = tw.decode_message(port)
    assert msg["req_id"] == 99 and msg["lb"] == "b1" and "client" not in msg


@pytest.mark.parametrize("stack", [
    [b"id", b"", jw.MAGIC + b"meta", b"t0"],
    [b"id", b"req", b"", jw.MAGIC + b"meta", b"", b"t1"],
    [jw.MAGIC + b"meta", b"", b"t1"],
    [b"id", jw.MAGIC + b"meta"],
    [b"id", b"garbage"],
    [b""],
    [],
], ids=["router_dealer", "req_envelope", "no_delimiter_empty_tensor",
        "identity_then_meta", "no_magic_no_delimiter", "delimiter_only",
        "empty"])
def test_split_envelope_edges(stack):
    assert tw.split_envelope(stack) == jw.split_envelope(stack)


def test_the_port_unpickler_refuses_other_reference_globals():
    bad = jw.MAGIC + pickle.dumps({"m": jw.QuantizedTensor(
        "int8", np.zeros(1, np.int8), 1.0, (1,)), "t": []})
    with pytest.raises(tw.WireError, match="refusing the global "
                       "znicz_tpu.parallel.wire.QuantizedTensor"):
        tw.decode_message([bad])


def test_codec_counts_as_the_reference():
    """The same traffic through both codecs: the same frames and the same
    nine counters; a refusal is counted and legacy-framed."""
    codecs = (tw.Codec(), jw.Codec())
    msg = {"cmd": "infer", "req_id": 7,
           "x": np.arange(12, dtype=np.float32).reshape(3, 4)}
    framed = [_frames(c.encode(msg)) for c in codecs]
    assert framed[0] == framed[1] == _frames(tw.encode_message(msg)[0])
    for c in codecs:
        dec, info = c.decode(framed[0])
        assert info["message_bytes"] == c.bytes_in
        np.testing.assert_array_equal(dec["x"], msg["x"])
        rep = pickle.loads(c.refusal("torn")[0])
        assert rep == {"ok": False, "bad_frame": True,
                       "error": "bad frame: torn"}
        c.count_bad_frame()
    for name in jw.Codec.COUNTERS:
        assert getattr(codecs[0], name) == getattr(codecs[1], name), name
    assert set(tw.Codec.COUNTERS) == set(jw.Codec.COUNTERS)
    assert codecs[0].bad_frames == 2
    assert codecs[0].compression_ratio("in") == pytest.approx(1.0)
    codecs[0].bytes_in = 123                      # writable by name
    assert codecs[0].bytes_in == 123


def test_canonical_wire_dtype_and_bf16_bits():
    for name in ("", "f32", "bf16", "BFloat16", "int8", "none"):
        assert tw.canonical_wire_dtype(name) == jw.canonical_wire_dtype(name)
    with pytest.raises(ValueError):
        tw.canonical_wire_dtype("fp8")
    a = np.array([0.0, -0.0, 1.0, 1.00390625, 3.4e38, np.inf, -np.inf,
                  np.nan, 1e-40], np.float32)
    assert tw.f32_to_bf16(a).tobytes() == jw.f32_to_bf16(a).tobytes()
    u = np.arange(0, 65536, 257, dtype=np.uint16)
    assert tw.bf16_to_f32(u).tobytes() == jw.bf16_to_f32(u).tobytes()


def test_a_port_process_decodes_reference_frames_without_jax(tmp_path):
    """The reference encodes; a fresh port process decodes the frames
    (passed as bytes in a file), and neither jax nor the JAX package
    enters its sys.modules."""
    frames = _frames(jw.encode_message(_message(jw), compress="zlib")[0])
    path = tmp_path / "frames.pickle"
    path.write_bytes(pickle.dumps(frames))
    code = (
        "import pickle, sys\n"
        "import numpy as np\n"
        "from znicz_torch.parallel import wire\n"
        f"frames = pickle.loads(open({str(path)!r}, 'rb').read())\n"
        "msg, info = wire.decode_message(frames)\n"
        "assert msg['req_id'] == 17 and msg['x'].shape == (3, 5, 2)\n"
        "assert info['tensors'] == 9\n"
        "assert msg['nested'][1][1] == {'k': [1, 2.0, None]}\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('decoded')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "decoded"
