"""Dependency-free TensorBoard event-file writer, and a PNG encoder from the standard library (the
port's copy of the JAX package's utils/tb_writer.py; images are encoded with zlib and struct, so
nothing here needs PIL).

Event files are TFRecord-framed ``Event`` protobufs, written by hand (varint protobuf encoding and
masked CRC32C framing), as ``events.out.tfevents.*`` files that TensorBoard reads:
  record  = uint64le(len) crc32c_masked(len_bytes) data crc32c_masked(data)
  Event   = {1: wall_time (double), 2: step (int64), 3: file_version (string, first record only),
             5: Summary}
  Summary = {1: repeated Value}; Value = {1: tag, 2: simple_value (float), 4: Image};
  Image   = {1: height, 2: width, 3: colorspace, 4: encoded_image_string (PNG)}
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

# -- CRC32C (Castagnoli, reflected polynomial 0x82F63B78) --------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding -------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


# -- PNG ----------------------------------------------------------------------------------------------


def to_uint8(image) -> np.ndarray:
    """uint8 arrays pass through; floats are clipped to [0, 1] and scaled to 0..255."""
    img = np.asarray(image)
    return img if img.dtype == np.uint8 else (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def encode_png(image) -> bytes:
    """An 8-bit PNG (grey for [H, W], RGB for [H, W, 3]) of a uint8 or [0, 1] float image."""
    img = to_uint8(image)
    if img.ndim != 2 and not (img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(img))  # filter type 0 per row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


class TBEventWriter:
    """Writes scalars and images that stock TensorBoard reads."""

    def __init__(self, log_dir: Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "host"
        self.path = log_dir / f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
        self._f = open(self.path, "ab")
        self._write_event(_field_double(1, time.time()) + _field_bytes(3, b"brain.Event:2"))  # file_version

    def _write_event(self, event_bytes: bytes) -> None:
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int, wall_time: Optional[float] = None) -> None:
        v = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
        self._write_event(
            _field_double(1, wall_time if wall_time is not None else time.time())
            + _field_varint(2, int(step))
            + _field_bytes(5, _field_bytes(1, v))
        )

    def add_image(self, tag: str, image, step: int) -> None:
        """image: uint8 [H, W, 3] or float in [0, 1] -> a PNG image summary."""
        img = to_uint8(image)
        image_pb = (_field_varint(1, img.shape[0]) + _field_varint(2, img.shape[1]) + _field_varint(3, 3)
                    + _field_bytes(4, encode_png(img)))
        v = _field_bytes(1, tag.encode()) + _field_bytes(4, image_pb)
        self._write_event(
            _field_double(1, time.time()) + _field_varint(2, int(step)) + _field_bytes(5, _field_bytes(1, v))
        )

    def close(self) -> None:
        self._f.close()
