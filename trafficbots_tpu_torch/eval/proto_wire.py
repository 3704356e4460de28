"""Minimal protobuf wire-format encoder (proto2/3 compatible subset).

A copy of `trafficbots_tpu/eval/proto_wire.py`, kept by the port instead
of importing the JAX package (tests/test_torch_eval.py holds the bytes
equal).

Self-contained replacement for the protobuf runtime when serializing the
WOMD MotionChallengeSubmission messages (the upstream TrafficBots depends
on waymo_open_dataset's generated pb2 modules in its src/utils/
submission.py:8). Supports exactly what the submission messages need:
varint, 32-bit floats, length-delimited strings/bytes/sub-messages, and
packed repeated floats.
"""
from __future__ import annotations

import struct
from typing import Iterable, List, Union


def _varint(value: int) -> bytes:
    out = bytearray()
    if value < 0:
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def enc_varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def enc_float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def enc_bytes_field(field: int, value: Union[str, bytes]) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _tag(field, 2) + _varint(len(value)) + value


def enc_message_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def enc_packed_floats(field: int, values: Iterable[float]) -> bytes:
    payload = b"".join(struct.pack("<f", float(v)) for v in values)
    return _tag(field, 2) + _varint(len(payload)) + payload


class Message:
    """Tiny append-only message builder."""

    def __init__(self):
        self._parts: List[bytes] = []

    def varint(self, field: int, value: int) -> "Message":
        self._parts.append(enc_varint_field(field, value))
        return self

    def float32(self, field: int, value: float) -> "Message":
        self._parts.append(enc_float_field(field, value))
        return self

    def string(self, field: int, value: Union[str, bytes]) -> "Message":
        self._parts.append(enc_bytes_field(field, value))
        return self

    def message(self, field: int, sub: "Message") -> "Message":
        self._parts.append(enc_message_field(field, sub.serialize()))
        return self

    def packed_floats(self, field: int, values: Iterable[float]) -> "Message":
        self._parts.append(enc_packed_floats(field, values))
        return self

    def serialize(self) -> bytes:
        return b"".join(self._parts)
