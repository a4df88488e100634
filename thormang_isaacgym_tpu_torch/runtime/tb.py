"""Minimal TensorBoard scalar-event writer, dependency-free. The port's
own copy of ``thormang_isaacgym_tpu/runtime/tb.py``.

Hand-encoded ``tf.Event`` protobuf records (Event{wall_time:1, step:2,
summary:5{value:1{tag:1, simple_value:2}}}) framed in TFRecord envelopes
with masked CRC32C, so ``tensorboard --logdir runs/`` reads the scalars of
``runtime/train.py``'s ``summaries/``. JSONL logging stays primary.
"""
from __future__ import annotations

import os
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers (varint + length-delimited)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double_field(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _scalar_event(step: int, tag: str, value: float,
                  wall_time: float) -> bytes:
    val = _len_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _len_field(1, val)
    event = (_double_field(1, wall_time) + _int_field(2, int(step))
             + _len_field(5, summary))
    return event


class SummaryWriter:
    """Append-only scalar writer: `add_scalar(tag, value, step)`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.thormang"
        self._f = open(os.path.join(logdir, fname), "ab")
        # file-version header event
        ver = _double_field(1, time.time()) + _len_field(3, b"brain.Event:2")
        self._write_record(ver)

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(step, tag, value, time.time()))

    def add_scalars(self, metrics: dict, step: int, prefix: str = ""):
        for k, v in metrics.items():
            try:
                self.add_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
