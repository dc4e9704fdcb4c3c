"""Wire protocol v3 codec (port of ``znicz_tpu/parallel/wire.py``).

Every message is a ZMQ multipart:

    frame 0:  b"ZNW3" + pickle of (message skeleton, tensor manifest)
    frame 1+: one raw buffer per tensor, in manifest order

The skeleton is the message dict with every ndarray replaced by a
:class:`_Slot` index; the manifest records each tensor's shape, logical
dtype, wire encoding (``raw`` / ``bfloat16`` / ``int8`` + per-tensor
absmax scale), optional compression and the exact frame length, so a torn
or corrupted tensor frame is refused at decode (length mismatch), never
reshaped into garbage.  Tensor bytes go to ZMQ as memoryviews of the
arrays themselves (zero copy); metadata stays pickle (a trusted cluster).

**One format for both packages.**  The slot is pickled under the JAX
package's global name, ``znicz_tpu.parallel.wire._Slot``, by a pickler
that writes that name without importing it; :class:`_Unpickler` resolves
the name to this module's class and refuses any other ``znicz_tpu``
global.  So a message gives the same frames, byte for byte, in both
packages, each decodes the other's, and decoding here never imports the
JAX package.

:class:`DeltaEncoder` quantizes weight deltas to bf16 or int8 with an
error-feedback residual per tensor (the quantization error of update N is
added back into update N+1), so the long-run sum tracks the float32 sum.
Non-finite deltas ship raw.  Per-tensor compression (zlib, or lz4 when it
imports) is kept only where it shrinks the frame.

A peer still speaking v2 framing (one pickled frame) is detected by the
missing magic; :func:`decode_message` returns it with ``legacy=True``.

Optional metadata keys ride the skeleton: ``trace_id``, ``deadline_ms``
(a budget: budgets cross the wire, never timestamps), ``client``,
``policy``, ``scope`` and ``gen``.
"""

from __future__ import annotations

import io
import pickle
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from znicz_torch.telemetry.metrics import registered_property

#: v3 metadata-frame magic; a frame without it is legacy (v2) pickle
MAGIC = b"ZNW3"

#: supported delta encodings (root.common.engine.wire_dtype)
WIRE_DTYPES = ("float32", "bfloat16", "int8")

#: per-tensor compression is skipped below this many bytes and dropped
#: when it does not shrink the frame
MIN_COMPRESS_BYTES = 512

#: the module the slot's global name is written under: the JAX package's
#: wire module, so both packages write the same bytes
SLOT_MODULE = "znicz_tpu.parallel.wire"

try:                                    # optional: lz4 may be missing
    import lz4.frame as _lz4
except Exception:                       # pragma: no cover - env dependent
    _lz4 = None


class WireError(ValueError):
    """A frame stack that is not a decodable v3 (or legacy v2) message."""


def canonical_wire_dtype(name: str) -> str:
    """Normalize config spellings (``bf16`` -> ``bfloat16``; ``f32``/empty
    -> ``float32``); unknown names raise."""
    alias = {"": "float32", "f32": "float32", "fp32": "float32",
             "bf16": "bfloat16", "none": "float32"}
    out = alias.get(str(name).lower(), str(name).lower())
    if out not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {name!r}; "
                         f"expected one of {WIRE_DTYPES}")
    return out


class _Slot:
    """Placeholder left in the pickled skeleton where tensor *i* goes."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_Slot, (self.i,))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler (whose bytes equal the C pickler's) with
    :class:`_Slot` written as the global ``SLOT_MODULE._Slot``, as the
    reference's class is named; the C pickler would import the module
    to check the name."""

    def save_global(self, obj, name=None):
        if obj is _Slot:
            self.save(SLOT_MODULE)
            self.save("_Slot")
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _Unpickler(pickle.Unpickler):
    """Reads the slot's global name as this module's :class:`_Slot` and
    refuses every other global of the JAX package."""

    def find_class(self, module, name):
        if module == SLOT_MODULE and name == "_Slot":
            return _Slot
        if module.split(".")[0] == "znicz_tpu":
            raise pickle.UnpicklingError(
                f"refusing the global {module}.{name}")
        return super().find_class(module, name)


def _dumps(obj) -> bytes:
    f = io.BytesIO()
    _Pickler(f, pickle.HIGHEST_PROTOCOL).dump(obj)
    return f.getvalue()


def _loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()


# -- bf16 <-> f32 (bit-level; no ml_dtypes dependency) -------------------------


def f32_to_bf16(a: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation of float32 to bfloat16 bits
    (uint16); NaN is pinned to the canonical quiet NaN."""
    a32 = np.ascontiguousarray(a, np.float32)
    bits = a32.view(np.uint32)
    rounded = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & 1))) >> 16
    out = rounded.astype(np.uint16)
    nan = np.isnan(a32)
    if nan.any():
        out = np.where(nan, np.uint16(0x7FC0), out)
    return out


def bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(u16, np.uint16).astype(np.uint32)
            << 16).view(np.float32)


# -- quantized tensors ---------------------------------------------------------


class QuantizedTensor:
    """A delta tensor encoded for the wire: ``data`` is the raw uint16
    (bf16) or int8 payload, ``scale`` the int8 absmax scale, ``shape`` the
    logical float32 shape.  The decoder dequantizes back to float32."""

    __slots__ = ("wire", "data", "scale", "shape")

    def __init__(self, wire: str, data: np.ndarray, scale: float,
                 shape: Tuple[int, ...]):
        self.wire = wire
        self.data = data
        self.scale = float(scale)
        self.shape = tuple(shape)


def quantize(arr: np.ndarray, wire_dtype: str):
    """Encode a float delta for the wire: a QuantizedTensor, or the array
    itself on the float32 wire or for a non-finite payload."""
    wire_dtype = canonical_wire_dtype(wire_dtype)
    # asarray, not ascontiguousarray: the latter makes 0-d arrays 1-d
    a = np.asarray(arr, np.float32)
    if wire_dtype == "float32" or not np.all(np.isfinite(a)):
        return a
    if wire_dtype == "bfloat16":
        return QuantizedTensor("bfloat16", f32_to_bf16(a), 0.0, a.shape)
    absmax = float(np.max(np.abs(a))) if a.size else 0.0
    scale = absmax / 127.0
    if scale == 0.0:
        data = np.zeros(a.shape, np.int8)
    else:
        data = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return QuantizedTensor("int8", data, scale, a.shape)


def dequantize(qt: QuantizedTensor) -> np.ndarray:
    if qt.wire == "bfloat16":
        return bf16_to_f32(qt.data).reshape(qt.shape)
    return (qt.data.astype(np.float32) * np.float32(qt.scale)).reshape(
        qt.shape)


class DeltaEncoder:
    """Per-peer delta quantizer with error feedback: the quantization
    error of each shipped delta is added back into the next delta of the
    same tensor before quantizing."""

    def __init__(self, wire_dtype: str = "float32"):
        self.wire_dtype = canonical_wire_dtype(wire_dtype)
        self.residuals: Dict[tuple, np.ndarray] = {}

    def encode(self, deltas: Optional[Dict]) -> Optional[Dict]:
        """{layer: {param: f32 array}} -> the same structure with
        QuantizedTensor leaves (float32 wire: returned untouched)."""
        if not deltas or self.wire_dtype == "float32":
            return deltas
        out: Dict[str, Dict[str, Any]] = {}
        for name, layer in deltas.items():
            enc: Dict[str, Any] = {}
            for k, d in (layer or {}).items():
                d = np.asarray(d, np.float32)
                key = (name, k)
                r = self.residuals.get(key)
                if r is not None and r.shape == d.shape:
                    d = d + r
                qt = quantize(d, self.wire_dtype)
                if isinstance(qt, QuantizedTensor):
                    self.residuals[key] = d - dequantize(qt)
                else:
                    # raw (non-finite): nothing lost, nothing fed back
                    self.residuals.pop(key, None)
                enc[k] = qt
            out[name] = enc
        return out


# -- message <-> frames --------------------------------------------------------


def _compress(buf, comp: Optional[str]):
    """(payload, tag): compressed bytes when it helps, else the original
    buffer with no tag."""
    n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
    if comp in (None, "", "none") or n < MIN_COMPRESS_BYTES:
        return buf, None
    if comp == "zlib":
        packed = zlib.compress(bytes(buf), 1)
    elif comp == "lz4":
        if _lz4 is None:
            return buf, None
        packed = _lz4.compress(bytes(buf))
    else:
        raise ValueError(f"unknown wire compression {comp!r}")
    return (packed, comp) if len(packed) < n else (buf, None)


def _decompress(buf: bytes, tag: Optional[str]) -> bytes:
    if tag is None:
        return buf
    if tag == "zlib":
        return zlib.decompress(buf)
    if tag == "lz4":
        if _lz4 is None:
            raise WireError("peer sent lz4 frames but lz4 is unavailable")
        return _lz4.decompress(buf)
    raise WireError(f"unknown frame compression {tag!r}")


def encode_message(msg: Any, compress: Optional[str] = None
                   ) -> Tuple[List[Any], Dict[str, int]]:
    """Message -> ``[meta_frame, tensor_frame, ...]`` plus an info dict:
    ``raw_bytes`` (float32-equivalent logical tensor bytes),
    ``wire_bytes`` (actual tensor frame bytes) and ``tensors``.  ndarray
    and QuantizedTensor leaves anywhere in dicts/lists/tuples become
    frames; everything else rides the pickled skeleton."""
    manifest: List[dict] = []
    buffers: List[Any] = []
    info = {"raw_bytes": 0, "wire_bytes": 0, "tensors": 0}

    def _put(x) -> _Slot:
        if isinstance(x, QuantizedTensor):
            data = np.ascontiguousarray(x.data)
            entry = {"w": x.wire, "s": x.scale, "shape": x.shape,
                     "d": "<f4"}
            raw_bytes = int(np.prod(x.shape, dtype=np.int64)) * 4
        else:
            # the manifest keeps the original shape: ascontiguousarray
            # makes 0-d arrays 1-d
            data = np.ascontiguousarray(x)
            entry = {"w": "raw", "shape": x.shape, "d": data.dtype.str}
            raw_bytes = data.nbytes
        payload, tag = _compress(memoryview(data.reshape(-1)), compress)
        if tag is not None:
            entry["c"] = tag
            entry["rn"] = data.nbytes       # decompressed length check
        n = payload.nbytes if isinstance(payload, memoryview) \
            else len(payload)
        entry["n"] = n                      # exact frame length check
        manifest.append(entry)
        buffers.append(payload)
        info["raw_bytes"] += raw_bytes
        info["wire_bytes"] += n
        info["tensors"] += 1
        return _Slot(len(manifest) - 1)

    def _walk(obj):
        if isinstance(obj, QuantizedTensor):
            return _put(obj)
        if isinstance(obj, np.ndarray):
            if obj.dtype == object:         # not buffer-backed: pickle it
                return obj
            return _put(obj)
        if isinstance(obj, dict):
            return {k: _walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            walked = [_walk(v) for v in obj]
            return walked if isinstance(obj, list) else tuple(walked)
        return obj

    skeleton = _walk(msg)
    meta = MAGIC + _dumps({"m": skeleton, "t": manifest})
    return [meta] + buffers, info


def decode_message(frames: List[bytes]) -> Tuple[Any, Dict[str, Any]]:
    """``[meta, tensors...]`` (or one legacy v2 pickle frame) -> the
    message plus info (``legacy`` flag + the byte accounting of encode).
    Raises :class:`WireError` on anything undecodable, a tensor frame
    whose length disagrees with the manifest included."""
    if not frames:
        raise WireError("empty frame stack")
    head = bytes(frames[0])
    info: Dict[str, Any] = {"legacy": False, "raw_bytes": 0,
                            "wire_bytes": 0, "tensors": 0}
    if not head.startswith(MAGIC):
        # legacy (v2) framing: exactly one pickled frame
        if len(frames) != 1:
            raise WireError(f"no {MAGIC!r} magic on a "
                            f"{len(frames)}-frame message")
        try:
            obj = _loads(head)
        except Exception as exc:
            raise WireError(f"bad frame: {exc}") from None
        info["legacy"] = True
        return obj, info
    try:
        meta = _loads(head[len(MAGIC):])
        skeleton, manifest = meta["m"], meta["t"]
    except Exception as exc:
        raise WireError(f"bad v3 metadata frame: {exc}") from None
    if len(frames) != 1 + len(manifest):
        raise WireError(f"manifest lists {len(manifest)} tensors but "
                        f"{len(frames) - 1} buffer frames arrived")
    tensors: List[np.ndarray] = []
    for i, (entry, buf) in enumerate(zip(manifest, frames[1:])):
        buf = bytes(buf)
        if len(buf) != entry["n"]:
            raise WireError(f"tensor frame {i} is {len(buf)} bytes, "
                            f"manifest says {entry['n']}")
        raw = _decompress(buf, entry.get("c"))
        if "rn" in entry and len(raw) != entry["rn"]:
            raise WireError(f"tensor frame {i} decompressed to "
                            f"{len(raw)} bytes, expected {entry['rn']}")
        shape = tuple(entry["shape"])
        try:
            if entry["w"] == "raw":
                arr = np.frombuffer(raw, dtype=np.dtype(entry["d"])
                                    ).reshape(shape)
            elif entry["w"] in ("bfloat16", "int8"):
                data = np.frombuffer(
                    raw, np.uint16 if entry["w"] == "bfloat16"
                    else np.int8)
                arr = dequantize(QuantizedTensor(
                    entry["w"], data, entry.get("s", 0.0), shape))
            else:
                raise WireError(f"unknown wire encoding {entry['w']!r}")
        except WireError:
            raise
        except Exception as exc:
            raise WireError(f"tensor frame {i} undecodable: {exc}") \
                from None
        tensors.append(arr)
        info["raw_bytes"] += int(np.prod(shape, dtype=np.int64)) * (
            4 if entry["w"] != "raw" else np.dtype(entry["d"]).itemsize)
        info["wire_bytes"] += len(buf)
        info["tensors"] += 1

    def _unwalk(obj):
        if isinstance(obj, _Slot):
            return tensors[obj.i]
        if isinstance(obj, dict):
            return {k: _unwalk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            walked = [_unwalk(v) for v in obj]
            return walked if isinstance(obj, list) else tuple(walked)
        return obj

    return _unwalk(skeleton), info


def peek_message(frames: List[bytes]) -> Dict[str, Any]:
    """The v3 metadata skeleton of a multipart message, decoded without
    materializing a tensor byte (tensor frames are only length-checked
    against the manifest); ndarray leaves appear as :class:`_Slot`.
    Raises :class:`WireError` on anything undecodable, legacy v2 framing
    included."""
    if not frames:
        raise WireError("empty frame stack")
    head = bytes(frames[0])
    if not head.startswith(MAGIC):
        raise WireError(f"no {MAGIC!r} magic — not a v3 message")
    try:
        meta = _loads(head[len(MAGIC):])
        skeleton, manifest = meta["m"], meta["t"]
    except Exception as exc:
        raise WireError(f"bad v3 metadata frame: {exc}") from None
    if not isinstance(skeleton, dict):
        raise WireError(f"skeleton decodes to "
                        f"{type(skeleton).__name__}, not a message dict")
    if len(frames) != 1 + len(manifest):
        raise WireError(f"manifest lists {len(manifest)} tensors but "
                        f"{len(frames) - 1} buffer frames arrived")
    for i, (entry, buf) in enumerate(zip(manifest, frames[1:])):
        n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
        if n != entry.get("n"):
            raise WireError(f"tensor frame {i} is {n} bytes, manifest "
                            f"says {entry.get('n')}")
    return skeleton


def restamp_message(frames: List[bytes], **keys) -> List[bytes]:
    """Rewrite top-level skeleton keys of a v3 message without touching
    its tensor frames; a key set to None is removed.  Undecodable
    metadata raises :class:`WireError`."""
    head = bytes(frames[0])
    if not head.startswith(MAGIC):
        raise WireError(f"no {MAGIC!r} magic — cannot restamp a "
                        f"non-v3 message")
    try:
        meta = _loads(head[len(MAGIC):])
        skeleton = meta["m"]
    except Exception as exc:
        raise WireError(f"bad v3 metadata frame: {exc}") from None
    if not isinstance(skeleton, dict):
        raise WireError("skeleton is not a message dict")
    for k, v in keys.items():
        if v is None:
            skeleton.pop(k, None)
        else:
            skeleton[k] = v
    new_head = MAGIC + _dumps(meta)
    return [new_head] + list(frames[1:])


class Codec:
    """Stateful message codec: the v3 encode/decode pair plus the byte and
    tensor accounting every peer keeps (the frames equal those of
    :func:`encode_message`).  The counters of :data:`COUNTERS` are
    registry counters of the ``owner`` scope (``master``, ``serving``,
    ``balancer``...), readable and writable by name; with telemetry on,
    each decode and encode is a ``wire`` span carrying the message's
    ``trace_id``.  One thread owns a codec's sockets (the serving
    frontend's router thread)."""

    #: the counters each codec keeps: name -> meaning
    COUNTERS = {
        "bytes_in": "wire bytes received (all frames)",
        "bytes_out": "wire bytes sent (all frames)",
        "messages_in": "messages decoded",
        "messages_out": "messages encoded",
        "bad_frames": "undecodable/garbage frames refused",
        "tensor_bytes_raw_in": "f32-equivalent tensor bytes received",
        "tensor_bytes_wire_in": "actual tensor bytes received",
        "tensor_bytes_raw_out": "f32-equivalent tensor bytes sent",
        "tensor_bytes_wire_out": "actual tensor bytes sent",
    }

    def __init__(self, compress: Optional[str] = None, owner: str = "wire"):
        #: per-tensor compression applied by :meth:`encode` (None = off)
        from znicz_torch import telemetry

        self.compress = None if compress in (None, "", "none") else compress
        self.owner = owner
        sc = telemetry.scope(owner)
        self._m = {name: sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        self._tracer = telemetry.tracer()

    def _inc(self, **deltas) -> None:
        for name, n in deltas.items():
            self._m[name].inc(int(n))

    @staticmethod
    def frames_bytes(frames: List) -> int:
        return sum(f.nbytes if isinstance(f, memoryview) else len(f)
                   for f in frames)

    def decode(self, frames: List[bytes]) -> Tuple[Any, Dict[str, Any]]:
        """:func:`decode_message` plus inbound accounting; the info dict
        gains ``message_bytes``.  Raises :class:`WireError` as the bare
        function does."""
        n = self.frames_bytes(frames)
        self._inc(bytes_in=n)
        if self._tracer.enabled:
            t0 = time.perf_counter()
            msg, info = decode_message(frames)
            self._tracer.add("wire", "decode", t0, time.perf_counter() - t0,
                             {"bytes": n, "tensors": info.get("tensors", 0),
                              "trace_id": msg.get("trace_id")
                              if isinstance(msg, dict) else None})
        else:                   # the disabled hot path reads no clock
            msg, info = decode_message(frames)
        info["message_bytes"] = n
        self._inc(messages_in=1,
                  tensor_bytes_raw_in=info.get("raw_bytes", 0),
                  tensor_bytes_wire_in=info.get("wire_bytes", 0))
        return msg, info

    def encode(self, msg: Any, legacy: bool = False) -> List[Any]:
        """Message -> frames plus outbound accounting.  ``legacy``
        answers a v2-framed peer in kind: one pickled frame."""
        t0 = time.perf_counter() if self._tracer.enabled else None
        if legacy:
            frames = [pickle.dumps(msg)]
        else:
            frames, enc = encode_message(msg, compress=self.compress)
            self._inc(tensor_bytes_raw_out=enc["raw_bytes"],
                      tensor_bytes_wire_out=enc["wire_bytes"])
        n = self.frames_bytes(frames)
        if t0 is not None:
            self._tracer.add("wire", "encode", t0, time.perf_counter() - t0,
                             {"bytes": n, "legacy": legacy,
                              "trace_id": msg.get("trace_id")
                              if isinstance(msg, dict) else None})
        self._inc(bytes_out=n, messages_out=1)
        return frames

    def count_message_in(self, frames: List) -> None:
        """Inbound accounting for a message that was peeked, not
        decoded."""
        self._inc(bytes_in=self.frames_bytes(frames), messages_in=1)

    def count_bad_frame(self) -> None:
        """Tick ``bad_frames`` for a request that decoded but tripped the
        owner's handler."""
        self._inc(bad_frames=1)

    def refusal(self, cause, legacy: bool = True, **extra) -> List:
        """The counted bad-frame refusal reply (legacy framing by default:
        an undecodable request's peer format is unknown); its payload is
        the transport core's ``bad_frame_reply``."""
        from znicz_torch.transport.core import bad_frame_reply

        self._inc(bad_frames=1)
        return self.encode(dict(bad_frame_reply(cause), **extra),
                           legacy=legacy)

    def compression_ratio(self, direction: str = "both"
                          ) -> Optional[float]:
        """float32-equivalent tensor bytes / tensor bytes on the wire —
        ``"in"``, ``"out"`` or ``"both"``; None before any tensor traffic
        in that direction."""
        raw = ((self.tensor_bytes_raw_in if direction != "out" else 0)
               + (self.tensor_bytes_raw_out if direction != "in" else 0))
        cooked = ((self.tensor_bytes_wire_in if direction != "out" else 0)
                  + (self.tensor_bytes_wire_out if direction != "in"
                     else 0))
        if not cooked:
            return None
        return raw / cooked


for _name, _help in Codec.COUNTERS.items():
    setattr(Codec, _name, registered_property(_name, _help))
del _name, _help


def split_envelope(frames: List[bytes]
                   ) -> Tuple[List[bytes], List[bytes]]:
    """ROUTER-side framing helper: (routing envelope incl. the empty
    delimiter, payload frames).  The payload starts after the first empty
    frame; a v3 metadata frame seen before any delimiter means the stack
    has none (and an empty tensor frame later must not be taken for
    one).  A stack with neither is all payload."""
    for i, f in enumerate(frames):
        if bytes(f[:len(MAGIC)]) == MAGIC:
            return list(frames[:i]), list(frames[i:])
        if len(f) == 0:
            return list(frames[:i + 1]), list(frames[i + 1:])
    return [], list(frames)
