"""Dependency-free TensorBoard scalar event writer.

The replacement for the reference's ``tf.summary.FileWriter``
(SURVEY.md §5 "Metrics / logging") without importing TensorFlow or torch —
those imports cost ~10 s and a multi-GB dependency for what is, for
scalars, a ~60-line wire format:

  * an event file is a TFRecord stream: each record is
    ``[uint64 length][masked crc32c(length)][payload][masked crc32c(payload)]``;
  * each payload is a serialized ``tensorflow.Event`` protobuf; scalars only
    need fields Event{wall_time=1(double), step=2(int64),
    file_version=3(string) | summary=5{Value{tag=1(string),
    simple_value=2(float)}}}.

The output is read by stock TensorBoard (validated once against
``tensorboard.backend.event_processing.event_accumulator`` — byte-level
framing and CRCs are checked by that reader, so this is not a best-effort
format).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- crc32c (Castagnoli), table-driven, as TFRecord requires ---------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- minimal protobuf wire encoding -----------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _double(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _float(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _int64(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(num: int, value: bytes) -> bytes:
    return _field(num, 2) + _varint(len(value)) + value


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    summary_value = _bytes(1, tag.encode()) + _float(2, value)
    summary = _bytes(1, summary_value)
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, summary)


class EventWriter:
    """Writes TensorBoard scalar event files (``events.out.tfevents.*``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.0"
        )
        self._file = open(os.path.join(log_dir, name), "ab")
        # file-version header event, as every TB writer emits
        self._write_record(
            _double(1, time.time()) + _bytes(3, b"brain.Event:2")
        )

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._write_record(
            _scalar_event(time.time(), int(global_step), tag, float(value))
        )
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
