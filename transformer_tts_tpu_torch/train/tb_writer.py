"""Minimal TensorBoard event writer — zero dependencies (the port's own
copy of transformer_tts_tpu/train/tb_writer.py, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package).

The reference's documented workflow is ``tensorboard --logdir
<save_dir>/logs`` (reference README.md:12; live SummaryWriter in the
legacy trainer, train_Fastspeech2.py:15,101). This writes standard
``events.out.tfevents.*`` files readable by TensorBoard without
depending on tensorflow/tensorboardX: scalars are hand-encoded with the
protobuf wire format (Event/Summary messages) inside TFRecord framing
with masked CRC32C checksums.

Wire formats implemented here:

* TFRecord: u64-LE length, u32 masked-crc32c(length), payload,
  u32 masked-crc32c(payload); mask(c) = ((c>>15 | c<<17) + 0xa282ead8).
* Event proto: 1=wall_time(double) 2=step(int64) 3=file_version(string)
  5=summary(message); Summary: repeated 1=value; Summary.Value:
  1=tag(string) 2=simple_value(float) 4=image(message);
  Summary.Image: 1=height 2=width 3=colorspace
  4=encoded_image_string (a hand-encoded grayscale PNG — zlib is
  stdlib; filter-0 scanlines).

Image summaries serve the reference's intended visual-debugging
workflow (attention-map dumps, train.py:227-234 commented;
utils/plot_alingment.py) without matplotlib in the loop.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78                 # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: str = None,
           scalars: dict = None) -> bytes:
    msg = bytearray()
    msg += b"\x09" + struct.pack("<d", wall_time)        # 1: double
    if step is not None:
        msg += b"\x10" + _varint(step)                   # 2: int64
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())    # 3: string
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            val = (_field_bytes(1, tag.encode())         # Value.tag
                   + b"\x15" + struct.pack("<f", float(value)))
            summary += _field_bytes(1, val)              # Summary.value
        msg += _field_bytes(5, bytes(summary))           # 5: summary
    return bytes(msg)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    raw = kind + payload
    return (struct.pack(">I", len(payload)) + raw
            + struct.pack(">I", zlib.crc32(raw) & 0xFFFFFFFF))


def encode_png_gray(img: "np.ndarray") -> bytes:
    """(H, W) float/int array -> 8-bit grayscale PNG bytes.

    Floats are min-max normalized; uint8 passes through.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = img.astype(np.float64)
        lo, hi = float(img.min()), float(img.max())
        scale = (hi - lo) if hi > lo else 1.0
        img = ((img - lo) / scale * 255.0).round().astype(np.uint8)
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # gray, 8-bit
    scanlines = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(scanlines, 6))
            + _png_chunk(b"IEND", b""))


def _image_event(wall_time: float, step: int, tag: str,
                 img: "np.ndarray") -> bytes:
    png = encode_png_gray(img)
    h, w = np.asarray(img).shape
    image_msg = (b"\x08" + _varint(h)            # Image.height
                 + b"\x10" + _varint(w)          # Image.width
                 + b"\x18" + _varint(1)          # colorspace: grayscale
                 + _field_bytes(4, png))         # encoded_image_string
    val = _field_bytes(1, tag.encode()) + _field_bytes(4, image_msg)
    summary = _field_bytes(1, val)
    msg = (b"\x09" + struct.pack("<d", wall_time)
           + b"\x10" + _varint(int(step))
           + _field_bytes(5, summary))
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """Append-only scalar event file, TensorBoard-compatible."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "ab")
        self._fh.write(_record(_event(time.time(), None,
                                      file_version="brain.Event:2")))
        self._fh.flush()

    def add_scalars(self, step: int, scalars: dict):
        self._fh.write(_record(_event(time.time(), int(step),
                                      scalars=scalars)))
        self._fh.flush()

    def add_image(self, step: int, tag: str, img) -> None:
        """Log a 2-D array (mel, attention map) as a grayscale image."""
        self._fh.write(_record(_image_event(time.time(), int(step),
                                            tag, img)))
        self._fh.flush()

    def close(self):
        self._fh.close()
