"""TensorBoard event-file writer (no tensorboard/tensorflow dependency)
— the port of ``bigdl_tpu.utils.tbwriter``: the same framing and CRCs, so
either package reads the other's event files.

The event-file format is a TFRecord stream:
    [uint64 length][uint32 masked-crc32c(length)][payload][uint32 masked-crc32c(payload)]
where payload is an ``Event`` protobuf.  The tiny subset of proto fields
needed (Event.wall_time=1 double, Event.step=2 int64, Event.file_version=3
string, Event.summary=5 message; Summary.value=1 repeated message;
Summary.Value.tag=1 string, .simple_value=2 float) is hand-encoded below —
pulling in protobuf codegen for five fields would be the tail wagging the
dog.
"""

import os
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode())


def _event(wall: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    out = _pb_double(1, wall)
    if step is not None:
        out += _pb_int64(2, step)
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _pb_str(1, tag) + _pb_float(2, value)
    return _pb_bytes(1, val)


def _packed_doubles(field: int, vals) -> bytes:
    body = struct.pack(f"<{len(vals)}d", *map(float, vals))
    return _key(field, 2) + _varint(len(body)) + body


def _histogram_summary(tag: str, values, bins: int = 30) -> bytes:
    """Summary.Value with a HistogramProto (tensorflow/core/framework/
    summary.proto: min=1, max=2, num=3, sum=4, sum_squares=5,
    bucket_limit=6, bucket=7) — the parameter-histogram stream the
    reference's TrainSummary emits when 'Parameters' is enabled."""
    import numpy as np

    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]  # diverged params must not kill the monitoring
    if v.size == 0:
        v = np.zeros((1,))
    counts, edges = np.histogram(v, bins=bins)
    histo = (_pb_double(1, float(v.min())) + _pb_double(2, float(v.max()))
             + _pb_double(3, float(v.size)) + _pb_double(4, float(v.sum()))
             + _pb_double(5, float((v * v).sum()))
             + _packed_doubles(6, edges[1:]) + _packed_doubles(7, counts))
    val = _pb_str(1, tag) + _pb_bytes(5, histo)
    return _pb_bytes(1, val)


class TensorBoardWriter:
    """Write ``events.out.tfevents.*`` scalar streams stock TensorBoard can
    read.  API mirrors the reference FileWriter surface used by
    TrainSummary/ValidationSummary."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.getpid()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._record(_event(time.time(), step=step,
                            summary=_scalar_summary(tag, float(value))))

    def add_histogram(self, tag: str, values, step: int, bins: int = 30):
        self._record(_event(time.time(), step=step,
                            summary=_histogram_summary(tag, values, bins)))

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_scalars(path: str):
    """Parse an event file written by TensorBoardWriter back into
    (step, tag, value) tuples — used by tests and by ``TrainSummary.
    read_scalar`` (reference API)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12: pos + 12 + length]
        pos += 12 + length + 4
        step, tag, value = 0, None, None
        # walk top-level Event fields
        p = 0
        while p < len(payload):
            key = payload[p]
            field, wire = key >> 3, key & 7
            p += 1
            if wire == 1:
                p += 8
            elif wire == 5:
                p += 4
            elif wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = v
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                sub = payload[p:p + ln]
                p += ln
                if field == 5:  # summary -> value submessage
                    sp = 1
                    sln = 0
                    shift = 0
                    while sp < len(sub):
                        b = sub[sp]
                        sp += 1
                        sln |= (b & 0x7F) << shift
                        shift += 7
                        if not b & 0x80:
                            break
                    vmsg = sub[sp:sp + sln]
                    vp = 0
                    while vp < len(vmsg):
                        k = vmsg[vp]
                        f_, w_ = k >> 3, k & 7
                        vp += 1
                        if w_ == 2:
                            l2 = 0
                            shift2 = 0
                            while True:  # length is a varint (tags >= 128 B)
                                b2 = vmsg[vp]
                                vp += 1
                                l2 |= (b2 & 0x7F) << shift2
                                shift2 += 7
                                if not b2 & 0x80:
                                    break
                            if f_ == 1:
                                tag = vmsg[vp:vp + l2].decode()
                            vp += l2
                        elif w_ == 5:
                            if f_ == 2:
                                (value,) = struct.unpack_from("<f", vmsg, vp)
                            vp += 4
                        elif w_ == 0:
                            while vmsg[vp] & 0x80:
                                vp += 1
                            vp += 1
                        elif w_ == 1:
                            vp += 8
        if tag is not None:
            out.append((step, tag, value))
    return out
