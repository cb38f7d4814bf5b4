"""TensorBoard integration: tfevents writing + storage sync.

A copy of ``determined_tpu/tensorboard.py``: trials write scalar
summaries as tfevents files and a manager syncs them to checkpoint
storage (the port's ``storage`` managers) for a TensorBoard to read.

The tfevents format is implemented directly (no TensorFlow dependency):
TFRecord framing (length + masked CRC32C + payload + masked CRC32C)
around hand-encoded Event protos — only the fields TensorBoard's scalar
plugin reads (wall_time, step, Summary.Value{tag, simple_value}). The
bytes equal the reference's, so either package reads the other's files.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional

from determined_tpu_torch.storage.base import StorageManager

# -- CRC32C (Castagnoli), table-based --------------------------------------
_CRC_TABLE = []
for _n in range(256):
    _c = _n
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


# -- minimal protobuf wire encoding ----------------------------------------
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag_len(field: int, payload: bytes) -> bytes:
    return bytes([(field << 3) | 2]) + _varint(len(payload)) + payload


def _encode_value(tag: str, value: float) -> bytes:
    payload = _tag_len(1, tag.encode())              # Value.tag = 1 (string)
    payload += bytes([0x15]) + struct.pack("<f", value)  # simple_value = 2 (f32)
    return payload


def _encode_event(
    wall_time: float,
    step: int = 0,
    scalars: Optional[Dict[str, float]] = None,
    file_version: Optional[str] = None,
) -> bytes:
    ev = bytes([0x09]) + struct.pack("<d", wall_time)   # wall_time = 1 (double)
    if step:
        ev += bytes([0x10]) + _varint(step)              # step = 2 (int64)
    if file_version is not None:
        ev += _tag_len(3, file_version.encode())         # file_version = 3
    if scalars:
        summary = b"".join(
            _tag_len(1, _encode_value(tag, v)) for tag, v in scalars.items()
        )
        ev += _tag_len(5, summary)                       # summary = 5
    return ev


def _frame(record: bytes) -> bytes:
    header = struct.pack("<Q", len(record))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + record
        + struct.pack("<I", _masked_crc(record))
    )


class EventFileWriter:
    """One tfevents file of scalar summaries."""

    def __init__(self, logdir: str, suffix: str = "") -> None:
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}{suffix}"
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(_frame(_encode_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        clean = {
            k: float(v) for k, v in scalars.items()
            if isinstance(v, (int, float))
        }
        if not clean:
            return
        self._f.write(_frame(_encode_event(time.time(), step, clean)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


def read_scalars(path: str) -> List[Dict]:
    """Decode a scalars-only tfevents file (tests + debugging)."""
    out: List[Dict] = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        record = data[pos + 12: pos + 12 + length]
        pos += 12 + length + 4
        ev: Dict = {"scalars": {}}
        i = 0
        while i < len(record):
            key = record[i]
            field, wt = key >> 3, key & 7
            i += 1
            if wt == 1:
                (val,) = struct.unpack_from("<d", record, i)
                i += 8
                if field == 1:
                    ev["wall_time"] = val
            elif wt == 0:
                val = 0
                shift = 0
                while True:
                    b = record[i]
                    i += 1
                    val |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    ev["step"] = val
            elif wt == 2:
                ln = 0
                shift = 0
                while True:
                    b = record[i]
                    i += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                payload = record[i: i + ln]
                i += ln
                if field == 5:  # summary: parse Values
                    j = 0
                    while j < len(payload):
                        if payload[j] != 0x0A:
                            break
                        j += 1
                        vlen = 0
                        shift = 0
                        while True:
                            b = payload[j]
                            j += 1
                            vlen |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        vrec = payload[j: j + vlen]
                        j += vlen
                        tag, simple = None, None
                        k = 0
                        while k < len(vrec):
                            vkey = vrec[k]
                            k += 1
                            if vkey == 0x0A:
                                tlen = vrec[k]
                                k += 1
                                tag = vrec[k: k + tlen].decode()
                                k += tlen
                            elif vkey == 0x15:
                                (simple,) = struct.unpack_from("<f", vrec, k)
                                k += 4
                            else:
                                break
                        if tag is not None and simple is not None:
                            ev["scalars"][tag] = simple
            else:
                break
        out.append(ev)
    return out


class TensorboardManager:
    """Sync a local tfevents dir to storage (ref: tensorboard/base.py:20).

    Upload target is `tensorboard/<task_id>` in the checkpoint storage
    backend; only new or grown files re-upload (tfevents are append-only).
    """

    def __init__(self, storage: StorageManager, task_id: str, logdir: str) -> None:
        self.storage = storage
        self.task_id = task_id
        self.logdir = logdir
        self._synced_bytes: Dict[str, int] = {}

    def sync(self) -> List[str]:
        uploaded = []
        if not os.path.isdir(self.logdir):
            return uploaded
        sizes: Dict[str, int] = {}
        for root, _, files in os.walk(self.logdir):
            for fname in files:
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, self.logdir)
                size = os.path.getsize(full)
                if self._synced_bytes.get(rel) == size:
                    continue
                sizes[rel] = size
                uploaded.append(rel)
        if uploaded:
            # One batched call per tick; manifest=False — tfevents syncs
            # are an append-only mirror on a hot loop, not a checkpoint
            # commit, so the manifest read-modify-write would only add
            # object-store round trips.
            self.storage.upload(
                self.logdir, f"tensorboard/{self.task_id}", paths=uploaded,
                manifest=False,
            )
            self._synced_bytes.update(sizes)
        return uploaded
