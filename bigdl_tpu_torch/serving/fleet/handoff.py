"""Serialized KV-page transfer — the prefill/decode split's wire format;
a copy of ``bigdl_tpu.serving.fleet.handoff``, so a blob written by
either package is read by the other, byte for byte.

A prefill worker runs the whole chunked prefill (selecting the first
token during the final chunk, exactly as a local request would), then
ships the finished pages to a decode worker as ``pack_handoff`` bytes:
a fixed magic + length-prefixed JSON header (tokens, first token and its
log-prob, sampling params, seed, array shape, ``kv_dtype``) followed by
the raw page images of K then V — float32, or int8 followed by the
per-(layer, page) float32 scale tables (K scales then V scales), ~4x
fewer wire bytes per page.  A header without ``kv_dtype`` is a blob
from before the field existed and is read as float32; an unrecognized
``kv_dtype`` is rejected BY NAME rather than misread as f32.

The format is deliberately *exact*: ``tobytes()``/``frombuffer`` round-
trips every float32 bit, and the first token's log-prob travels as a
Python float (binary64 superset of the engine's float32, and JSON's
shortest-repr round-trips binary64 exactly), so importing a handoff on
the decode worker reproduces byte-for-byte the state the prefill worker
would have continued from — the byte-identical-to-``static_generate``
parity invariant survives the process boundary.  tests/test_fleet.py
proves pack→unpack is an exact round-trip and that a cross-engine
handoff decode matches ``static_generate``.

K/V arrays are shaped ``(layers, pages, kv_heads, page_size, head_dim)``
— the engine's page-pool layout with the page axis narrowed to the pages
the prompt covers.  Positions in the last page at or beyond the prompt
length carry whatever the prefill padding wrote; the decode engine
overwrites each such position before ever attending to it (the same
argument that makes slot reuse aliasing-free), so they need no masking
here.
"""

import json
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["pack_handoff", "unpack_handoff", "HANDOFF_MAGIC",
           "HandoffError", "MAX_HANDOFF_BYTES"]

HANDOFF_MAGIC = b"BDLFKV1\n"

# header fields every handoff carries; anything else JSON-serializable
# rides along untouched (request_id, deadline, tenant...)
_REQUIRED = ("tokens", "first_token", "first_logp")

# hard ceiling on an accepted blob: a misbehaving (or chaos-injected)
# prefill worker must not be able to make a decode worker materialize an
# unbounded numpy array.  256 MiB covers every geometry this repo ships
# (the bench fleet's largest handoff is < 1 MiB) with 2+ orders of
# margin; callers with bigger pools pass max_bytes explicitly.
MAX_HANDOFF_BYTES = 256 * 1024 * 1024

# the JSON header is small (tokens + sampling meta); a multi-megabyte
# header length is corruption, not a big request
_MAX_HEADER_BYTES = 16 * 1024 * 1024


class HandoffError(ValueError):
    """A handoff blob failed validation — corrupt magic, truncated or
    lying header, payload shorter than the header promises, or a
    page/byte count over the caller's bound.  Subclasses ValueError so
    pre-existing ``pytest.raises(ValueError, ...)`` specs (and callers
    catching ValueError) keep working; raised *before* any page is
    allocated on the importing engine, so a rejected blob never leaves
    partially-imported state behind."""


def pack_handoff(h: Dict[str, Any]) -> bytes:
    """Serialize a handoff dict (as built by the engine's ``export_kv``
    path) to transfer bytes.  ``h["k"]``/``h["v"]`` are the page images
    in the engine's stored page dtype — float32, or int8 with the
    per-(layer, page) float32 ``k_scales``/``v_scales`` riding behind
    the V payload (an int8 blob is ~4x smaller on the wire); every
    other key must be JSON-serializable."""
    kv_dtype = str(h.get("kv_dtype", "float32"))
    if kv_dtype not in ("float32", "int8"):
        raise ValueError(f"unsupported handoff kv_dtype {kv_dtype!r}")
    dt = np.int8 if kv_dtype == "int8" else np.float32
    k = np.ascontiguousarray(np.asarray(h["k"], dt))
    v = np.ascontiguousarray(np.asarray(h["v"], dt))
    if k.shape != v.shape or k.ndim != 5:
        raise ValueError(f"handoff K/V must share a 5-d page-pool shape, "
                         f"got k={k.shape} v={v.shape}")
    payload = [k.tobytes(), v.tobytes()]
    if kv_dtype == "int8":
        ks = np.ascontiguousarray(np.asarray(h.get("k_scales"),
                                             np.float32))
        vs = np.ascontiguousarray(np.asarray(h.get("v_scales"),
                                             np.float32))
        if ks.shape != k.shape[:2] or vs.shape != k.shape[:2]:
            raise ValueError(
                f"int8 handoff needs (layers, pages) scale tables "
                f"{k.shape[:2]}, got k_scales={ks.shape} "
                f"v_scales={vs.shape}")
        payload += [ks.tobytes(), vs.tobytes()]
    header = {key: val for key, val in h.items()
              if key not in ("k", "v", "k_scales", "v_scales")}
    for key in _REQUIRED:
        if key not in header:
            raise ValueError(f"handoff missing required field {key!r}")
    header["tokens"] = [int(t) for t in header["tokens"]]
    header["first_token"] = int(header["first_token"])
    header["first_logp"] = float(header["first_logp"])
    header["shape"] = list(k.shape)
    # "dtype" is the pre-kv_dtype name for the same field: writing both
    # keeps an int8 blob REJECTED (not silently misread as f32) by
    # decoders from before kv_dtype existed, and f32 blobs bit-identical
    # to what those decoders always produced
    header["dtype"] = kv_dtype
    header["kv_dtype"] = kv_dtype
    header["version"] = 1
    hdr = json.dumps(header, sort_keys=True).encode()
    return b"".join([HANDOFF_MAGIC, len(hdr).to_bytes(8, "big"), hdr]
                    + payload)


def unpack_handoff(data: bytes, max_bytes: int = MAX_HANDOFF_BYTES,
                   max_pages: Optional[int] = None) -> Dict[str, Any]:
    """Exact inverse of :func:`pack_handoff`, hardened against corrupt
    or adversarial blobs: every structural violation raises
    :class:`HandoffError` before any array is materialized.

    ``max_bytes`` bounds the accepted blob size; ``max_pages`` (when
    given, e.g. the importing engine's ``prefix_cache_pages``) bounds
    the page axis of the declared shape so a bad prefill worker can't
    make the decode worker allocate pages it doesn't have."""
    if len(data) > max_bytes:
        raise HandoffError(f"handoff blob of {len(data)} bytes exceeds "
                           f"the {max_bytes}-byte bound")
    if not data.startswith(HANDOFF_MAGIC):
        raise HandoffError("not a KV handoff (bad magic)")
    off = len(HANDOFF_MAGIC)
    if len(data) < off + 8:
        raise HandoffError("handoff truncated: header length missing")
    hlen = int.from_bytes(data[off:off + 8], "big")
    off += 8
    if hlen > _MAX_HEADER_BYTES or off + hlen > len(data):
        raise HandoffError(f"handoff truncated: header claims {hlen} "
                           f"bytes, blob has {len(data) - off} after it")
    try:
        header = json.loads(data[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise HandoffError(f"handoff header is not valid JSON: {e}")
    if not isinstance(header, dict):
        raise HandoffError("handoff header must be a JSON object")
    off += hlen
    if header.get("version") != 1:
        raise HandoffError(f"unsupported handoff version "
                           f"{header.get('version')!r}")
    for key in _REQUIRED:
        if key not in header:
            raise HandoffError(f"handoff missing required field {key!r}")
    if (not isinstance(header["tokens"], list)
            or not all(isinstance(t, int) for t in header["tokens"])):
        raise HandoffError("handoff tokens must be a list of ints")
    raw_shape = header.pop("shape", None)
    if (not isinstance(raw_shape, list) or len(raw_shape) != 5
            or not all(isinstance(d, int) and d >= 0 for d in raw_shape)):
        raise HandoffError(f"handoff K/V must share a 5-d page-pool "
                           f"shape, got {raw_shape!r}")
    shape = tuple(raw_shape)
    legacy_dt = header.pop("dtype", None)
    kv_dtype = header.pop("kv_dtype", legacy_dt or "float32")
    if kv_dtype not in ("float32", "int8"):
        # NAME the dtype: a future blob must be rejected loudly (HTTP
        # 400 at the serving frontend), never misread as f32 pages
        raise HandoffError(f"unsupported handoff kv_dtype {kv_dtype!r} "
                           "(this build understands float32 and int8)")
    if legacy_dt is not None and legacy_dt != kv_dtype:
        raise HandoffError(f"handoff header dtype {legacy_dt!r} "
                           f"contradicts kv_dtype {kv_dtype!r}")
    if max_pages is not None and shape[1] > max_pages:
        raise HandoffError(f"handoff declares {shape[1]} pages, over the "
                           f"importer's {max_pages}-page bound")
    dt = np.int8 if kv_dtype == "int8" else np.float32
    itemsize = dt().itemsize
    elems = int(np.prod(shape, dtype=np.int64))
    nbytes = elems * itemsize
    n_scales = shape[0] * shape[1]          # one per (layer, page)
    scale_bytes = 2 * n_scales * 4 if kv_dtype == "int8" else 0
    total = 2 * nbytes + scale_bytes
    if total > max_bytes:
        raise HandoffError(f"handoff shape {shape} implies {total} "
                           f"payload bytes, over the {max_bytes}-byte "
                           "bound")
    if len(data) != off + total:
        raise HandoffError(f"handoff payload truncated: expected "
                           f"{off + total} bytes, got {len(data)}")
    k = np.frombuffer(data, dt, count=elems, offset=off).reshape(shape)
    v = np.frombuffer(data, dt, count=elems,
                      offset=off + nbytes).reshape(shape)
    out = dict(header)
    out["tokens"] = np.asarray(header["tokens"], np.int32)
    out["kv_dtype"] = kv_dtype
    out["k"] = k
    out["v"] = v
    if kv_dtype == "int8":
        so = off + 2 * nbytes
        out["k_scales"] = np.frombuffer(
            data, np.float32, count=n_scales,
            offset=so).reshape(shape[0], shape[1])
        out["v_scales"] = np.frombuffer(
            data, np.float32, count=n_scales,
            offset=so + n_scales * 4).reshape(shape[0], shape[1])
    return out
