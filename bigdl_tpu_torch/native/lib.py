"""Build-on-first-use loader, ctypes wrappers and numpy fallbacks of the
port's native host library (``bigdl_tpu_io.cpp`` beside this file).

The library is compiled by ``g++`` at first use into
``build/bigdl_tpu_torch/`` at the root of the checkout, named by a hash
of the source, the flags and the host's CPU (``-march=native`` code is
only good on the CPU that built it).  A build writes a file name unique
to its process and thread and lands with ``os.replace``, so test workers
that build at once never load a half-written library.  It links libjpeg
where the host has it and builds without it (``-DBTIO_NO_JPEG``) where it
does not; ``jpeg_available()`` says which, ``jpeg_unavailable_reason()``
why not.  Every entry point has a numpy fallback for hosts without
``g++``."""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "bigdl_tpu_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bigdl_tpu_torch"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")
_VERSION = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_jpeg_error: Optional[str] = None


def _cpu_identity() -> bytes:
    """The model and flags lines of /proc/cpuinfo (empty elsewhere)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def _target(variant: str, extra) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS + tuple(extra)).encode())
    h.update(_cpu_identity())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"bigdl_tpu_io-{variant}-{h.hexdigest()[:16]}.so"


def _compile(so: Path, extra) -> Optional[str]:
    """Build ``so``; None on success, else the compiler's complaint."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC), *extra]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (subprocess.SubprocessError, OSError) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (proc.stderr or proc.stdout).strip()[-400:]
    os.replace(tmp, so)
    return None


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _jpeg_error
    if not _SRC.exists():
        return None
    variants = (("jpeg", ("-lpthread", "-ljpeg")),
                ("nojpeg", ("-DBTIO_NO_JPEG", "-lpthread")))
    so = None
    for variant, extra in variants:
        so = _target(variant, extra)
        if so.exists():
            break
        err = _compile(so, extra)
        if err is None:
            break
        if variant == "jpeg":
            _jpeg_error = f"built without libjpeg: {err}"
        so = None
    if so is None:
        return None
    if so.name.startswith("bigdl_tpu_io-nojpeg") and _jpeg_error is None:
        _jpeg_error = "built without libjpeg (an earlier build found none)"
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.btio_resize_bilinear_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ctypes.c_int]
    lib.btio_crop_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.btio_hflip_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.btio_normalize_f32.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.btio_pipeline_create.argtypes = [ctypes.c_int]
    lib.btio_pipeline_create.restype = ctypes.c_void_p
    lib.btio_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.btio_process_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(u8p), i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.btio_gather_rows_f32.argtypes = [
        ctypes.c_void_p, f32p, i64p, ctypes.c_int, ctypes.c_int64, f32p]
    lib.btio_records_open.argtypes = [ctypes.c_char_p]
    lib.btio_records_open.restype = ctypes.c_void_p
    lib.btio_records_count.argtypes = [ctypes.c_void_p]
    lib.btio_records_count.restype = ctypes.c_int64
    lib.btio_records_bytes.argtypes = [ctypes.c_void_p]
    lib.btio_records_bytes.restype = ctypes.c_int64
    lib.btio_records_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64p, ctypes.c_int, u8p]
    lib.btio_records_close.argtypes = [ctypes.c_void_p]
    lib.btio_jpeg_available.restype = ctypes.c_int
    lib.btio_jpeg_dims.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i32p]
    lib.btio_jpeg_dims.restype = ctypes.c_int
    lib.btio_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int,
                                     ctypes.c_int]
    lib.btio_jpeg_decode.restype = ctypes.c_int
    lib.btio_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, u8p, ctypes.c_int64]
    lib.btio_jpeg_encode.restype = ctypes.c_int64
    lib.btio_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(u8p), i64p, i32p,
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, i32p]
    lib.btio_version.restype = ctypes.c_int
    if lib.btio_version() != _VERSION:
        return None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build_and_load()
                _tried = True
    return _lib


def available() -> bool:
    """True when the native library built (or was built) and loaded."""
    return _get() is not None


def jpeg_available() -> bool:
    """True when the native library was built against libjpeg."""
    lib = _get()
    return bool(lib is not None and lib.btio_jpeg_available())


def jpeg_unavailable_reason() -> Optional[str]:
    """Why the library has no JPEG decode (None when it has one)."""
    lib = _get()
    if lib is None:
        return "the native library did not build"
    return None if lib.btio_jpeg_available() else _jpeg_error


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# Single-image ops (uint8 HWC)
# ---------------------------------------------------------------------------

def resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if (h, w) == (oh, ow):
        return img
    lib = _get()
    if lib is not None:
        out = np.empty((oh, ow, c), np.uint8)
        lib.btio_resize_bilinear_u8(_u8p(img), h, w, c, _u8p(out), oh, ow)
        return out
    # numpy fallback (the same align-corners sampling as the C path)
    ys = (np.linspace(0, h - 1, oh) if oh > 1 else np.zeros(1))
    xs = (np.linspace(0, w - 1, ow) if ow > 1 else np.zeros(1))
    y0 = ys.astype(np.int64)
    x0 = xs.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return np.rint(top * (1 - wy) + bot * wy).astype(np.uint8)


def _check_crop(h, w, oy, ox, ch, cw):
    if oy < 0 or ox < 0 or oy + ch > h or ox + cw > w:
        raise ValueError(
            f"crop ({ch}x{cw} at {oy},{ox}) out of bounds for {h}x{w} image"
            " — resize up first (the C path would read out of bounds)")


def crop(img: np.ndarray, oy: int, ox: int, ch: int, cw: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    _check_crop(h, w, oy, ox, ch, cw)
    lib = _get()
    if lib is not None:
        out = np.empty((ch, cw, c), np.uint8)
        lib.btio_crop_u8(_u8p(img), h, w, c, oy, ox, _u8p(out), ch, cw)
        return out
    return img[oy:oy + ch, ox:ox + cw].copy()


def hflip(img: np.ndarray) -> np.ndarray:
    src = np.asarray(img)
    out = np.ascontiguousarray(src, np.uint8)
    if out is src:  # ascontiguousarray did not copy: keep the input intact
        out = out.copy()
    lib = _get()
    if lib is not None:
        h, w, c = out.shape
        lib.btio_hflip_u8(_u8p(out), h, w, c)
        return out
    return out[:, ::-1].copy()


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC -> float32 HWC, (x/255 - mean) / std per channel."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib = _get()
    if lib is not None:
        out = np.empty((h, w, c), np.float32)
        lib.btio_normalize_f32(_u8p(img), h, w, c, _f32p(mean), _f32p(std),
                               _f32p(out))
        return out
    return ((img.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)


# ---------------------------------------------------------------------------
# Threaded batch pipeline
# ---------------------------------------------------------------------------

def _resize_of(resize_hw, i):
    """Image ``i``'s intermediate size: ``resize_hw`` is one (rh, rw) for
    every image, or a list of them, one per image."""
    return resize_hw[i] if not np.isscalar(resize_hw[0]) else resize_hw


class BatchPipeline:
    """Threaded per-image transform into a contiguous NHWC float32 batch."""

    def __init__(self, num_threads: Optional[int] = None):
        self.num_threads = num_threads or max(1, (os.cpu_count() or 2) - 1)
        lib = _get()
        self._lib = lib
        self._pipe = (lib.btio_pipeline_create(self.num_threads)
                      if lib is not None else None)

    def close(self):
        if self._pipe is not None:
            self._lib.btio_pipeline_destroy(self._pipe)
            self._pipe = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _out_buffer(out, n, oh, ow, c) -> np.ndarray:
        """Validate a caller's output buffer (a ring slot) or allocate
        one."""
        if out is None:
            return np.empty((n, oh, ow, c), np.float32)
        if out.shape != (n, oh, ow, c) or out.dtype != np.float32 \
                or not out.flags.c_contiguous:
            raise ValueError(
                f"out buffer must be C-contiguous float32 {(n, oh, ow, c)}, "
                f"got {out.dtype} {out.shape}")
        return out

    def process_batch(self, images, out_hw, mean, std, resize_hw=None,
                      crops=None, flips=None, out=None) -> np.ndarray:
        """``images``: uint8 HWC arrays (one channel count).  ``out_hw``:
        the final (oh, ow).  ``resize_hw``: one (rh, rw), or one per
        image, resized to before the crop (None: no resize).  ``crops``:
        (cy, cx) per image (None: 0, 0).  ``flips``: a bool per image.
        ``out``: an (n, oh, ow, c) float32 destination (a ring slot), or
        None to allocate.  Returns the normalized batch."""
        n = len(images)
        oh, ow = out_hw
        c = images[0].shape[2]
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        images = [np.ascontiguousarray(im, np.uint8) for im in images]
        out = self._out_buffer(out, n, oh, ow, c)

        if self._pipe is not None:
            srcs = (ctypes.POINTER(ctypes.c_uint8) * n)(
                *[_u8p(im) for im in images])
            dims = np.empty((n, 2), np.int32)
            geom = np.zeros((n, 5), np.int32)
            for i, im in enumerate(images):
                dims[i] = im.shape[:2]
                eh, ew = im.shape[:2]  # size entering the crop stage
                if resize_hw is not None:
                    eh, ew = geom[i, 0], geom[i, 1] = _resize_of(
                        resize_hw, i)
                cy, cx = crops[i] if crops is not None else (0, 0)
                _check_crop(eh, ew, cy, cx, oh, ow)
                geom[i, 2], geom[i, 3] = cy, cx
                if flips is not None:
                    geom[i, 4] = int(bool(flips[i]))
            self._lib.btio_process_batch(
                self._pipe, n, srcs,
                dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                geom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                c, oh, ow, _f32p(mean), _f32p(std), _f32p(out))
            return out

        for i, im in enumerate(images):
            cur = im
            if resize_hw is not None:
                cur = resize_bilinear(cur, *_resize_of(resize_hw, i))
            cy, cx = crops[i] if crops is not None else (0, 0)
            _check_crop(cur.shape[0], cur.shape[1], cy, cx, oh, ow)
            cur = cur[cy:cy + oh, cx:cx + ow]
            if flips is not None and flips[i]:
                cur = cur[:, ::-1]
            out[i] = (cur.astype(np.float32) / 255.0 - mean) / std
        return out

    def decode_batch(self, encoded, out_hw, mean, std, resize_hw=None,
                     crops=None, flips=None, out=None) -> np.ndarray:
        """JPEG decode and transform, all in the C++ worker threads.
        ``encoded``: JPEG ``bytes``; the rest as in :meth:`process_batch`.
        Returns (n, oh, ow, 3) float32.  Without the native libjpeg it
        decodes one image at a time (PIL) and goes through
        :meth:`process_batch`.  Raises ValueError naming the failing
        indices."""
        n = len(encoded)
        oh, ow = out_hw
        if self._pipe is None or not jpeg_available():
            return self.process_batch([decode_jpeg(e) for e in encoded],
                                      out_hw, mean, std, resize_hw=resize_hw,
                                      crops=crops, flips=flips, out=out)
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        bufs = [np.frombuffer(e, np.uint8) for e in encoded]
        srcs = (ctypes.POINTER(ctypes.c_uint8) * n)(
            *[_u8p(b) for b in bufs])
        lens = np.asarray([len(e) for e in encoded], np.int64)
        geom = np.zeros((n, 5), np.int32)
        for i in range(n):
            if resize_hw is not None:
                geom[i, 0], geom[i, 1] = _resize_of(resize_hw, i)
            if crops is not None:
                geom[i, 2], geom[i, 3] = crops[i]
            if flips is not None:
                geom[i, 4] = int(bool(flips[i]))
        out = self._out_buffer(out, n, oh, ow, 3)
        status = np.empty((n,), np.int32)
        self._lib.btio_decode_batch(
            self._pipe, n, srcs,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            geom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            oh, ow, _f32p(mean), _f32p(std), _f32p(out),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        bad_decode = np.flatnonzero(status == -1)
        bad_crop = np.flatnonzero(status == -2)
        if len(bad_crop):
            raise ValueError(
                "crop out of bounds of the decoded/resized image for batch "
                f"indices {bad_crop.tolist()[:8]} — pass resize_hw or "
                "shrink the crop (geometry bug, not corrupt data)")
        if len(bad_decode):
            raise ValueError(
                f"JPEG decode failed for batch indices "
                f"{bad_decode.tolist()[:8]}")
        return out

    def gather_rows(self, src: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """Parallel ``src[idx]`` of a float32 array."""
        src = np.ascontiguousarray(src, np.float32)
        idx = np.ascontiguousarray(idx, np.int64)
        if self._pipe is None:
            return src[idx].copy()
        row = int(np.prod(src.shape[1:]))
        out = np.empty((len(idx),) + src.shape[1:], np.float32)
        self._lib.btio_gather_rows_f32(
            self._pipe, _f32p(src),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), row, _f32p(out))
        return out


class RecordReader:
    """Memory-mapped fixed-size-record reader with threaded batch gather;
    ``ok`` is False when the library is missing (callers fall back to
    ``np.memmap``)."""

    def __init__(self, path: str, pipeline: "BatchPipeline" = None):
        lib = _get()
        self._lib = lib
        self._h = lib.btio_records_open(
            os.fsencode(path)) if lib is not None else None
        if lib is not None and not self._h:
            raise ValueError(f"not a BTRECv1 record file: {path}")
        self._pipe = pipeline

    @property
    def ok(self) -> bool:
        return self._h is not None

    def count(self) -> int:
        return int(self._lib.btio_records_count(self._h))

    def record_bytes(self) -> int:
        return int(self._lib.btio_records_bytes(self._h))

    def gather(self, idx: np.ndarray, out=None) -> np.ndarray:
        """(n,) int64 indices -> (n, record_bytes) uint8, into ``out``
        when given (a reusable staging buffer)."""
        idx = np.ascontiguousarray(idx, np.int64)
        shape = (len(idx), self.record_bytes())
        if out is None:
            out = np.empty(shape, np.uint8)
        elif out.shape != shape or out.dtype != np.uint8 \
                or not out.flags.c_contiguous:
            raise ValueError(
                f"out buffer must be C-contiguous uint8 {shape}, got "
                f"{out.dtype} {out.shape}")
        self._lib.btio_records_gather(
            self._h, self._pipe._pipe if self._pipe is not None else None,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            _u8p(out))
        return out

    def close(self):
        if self._h is not None:
            self._lib.btio_records_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """(h, w, 3) RGB uint8 as JPEG bytes through the native libjpeg (it
    makes JPEG inputs where no imaging library is installed).  Raises
    RuntimeError when the library has no libjpeg."""
    if not jpeg_available():
        raise RuntimeError(f"no native JPEG encoder: "
                           f"{jpeg_unavailable_reason()}")
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"need (h, w, 3) RGB, got {img.shape}")
    out = np.empty(2 * img.size + (1 << 16), np.uint8)
    n = _get().btio_jpeg_encode(_u8p(img), h, w, int(quality), _u8p(out),
                                out.size)
    if n < 0:
        raise RuntimeError(f"JPEG encode failed ({n})")
    return out[:n].tobytes()


def decode_jpeg(data: bytes) -> np.ndarray:
    """One JPEG as (h, w, 3) RGB uint8 — the native libjpeg when the
    library has it, PIL otherwise.  Raises ValueError on corrupt input."""
    lib = _get()
    if lib is not None and lib.btio_jpeg_available():
        buf = np.frombuffer(data, np.uint8)
        h = ctypes.c_int32()
        w = ctypes.c_int32()
        c = ctypes.c_int32()
        if lib.btio_jpeg_dims(_u8p(buf), len(data), ctypes.byref(h),
                              ctypes.byref(w), ctypes.byref(c)) == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            if lib.btio_jpeg_decode(_u8p(buf), len(data), _u8p(out),
                                    h.value, w.value) == 0:
                return out
        raise ValueError("corrupt or unsupported JPEG")
    import io

    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    except Exception as e:
        raise ValueError(f"corrupt or unsupported JPEG: {e}") from None
