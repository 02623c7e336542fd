"""Vision pipeline: ImageFrame, the augmentation DSL and the streaming
image datasets — the port of ``bigdl_tpu.data.vision``.

Augmentation is host-CPU work; the hot loops run in the port's native
C++ library (``bigdl_tpu_torch.native``, threaded) with numpy fallbacks,
and ``ImageFrameToBatches`` / ``AugmentedRecordImages`` fuse
resize→crop→flip→normalize into ONE threaded pass per minibatch that
writes straight into the contiguous NHWC float32 batch the device feed
copies to the card.  The same (seed, epoch) gives the same bits as the
JAX package's datasets.
"""

import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.data.dataset import (
    DataSet, MiniBatch, _per_host_batch, batch_index_plan,
    resharded_batch_index_plan,
)
from bigdl_tpu_torch.data.transformer import Transformer


class ImageFeature(dict):
    """One image + metadata — reference ``ImageFeature.scala`` (a typed
    hashmap with well-known keys)."""

    KEY_IMAGE = "image"      # uint8 HWC
    KEY_LABEL = "label"
    KEY_URI = "uri"

    def __init__(self, image=None, label=None, uri=None, **kw):
        super().__init__(**kw)
        if image is not None:
            self[self.KEY_IMAGE] = np.asarray(image, np.uint8)
        if label is not None:
            self[self.KEY_LABEL] = label
        if uri is not None:
            self[self.KEY_URI] = uri

    @property
    def image(self) -> np.ndarray:
        return self[self.KEY_IMAGE]

    @image.setter
    def image(self, v):
        self[self.KEY_IMAGE] = v

    @property
    def label(self):
        return self.get(self.KEY_LABEL)


class ImageFrame:
    """Local collection of ImageFeatures — reference ``ImageFrame.scala``
    (``LocalImageFrame``; the distributed twin is an XShards of frames —
    see ``bigdl_tpu/data/shards.py``)."""

    def __init__(self, features: Sequence[ImageFeature]):
        self.features: List[ImageFeature] = list(features)

    @staticmethod
    def from_arrays(images, labels=None) -> "ImageFrame":
        labels = labels if labels is not None else [None] * len(images)
        return ImageFrame([ImageFeature(im, lb)
                           for im, lb in zip(images, labels)])

    @staticmethod
    def read(paths, labels=None) -> "ImageFrame":
        """Decode image files (host CPU, PIL) — reference
        ``ImageFrame.read``/``NNImageReader`` ingestion.  ``paths`` is a
        list of file paths, a directory, or a glob pattern; images come out
        HWC uint8 RGB."""
        from PIL import Image as _PILImage

        from bigdl_tpu_torch.data.shards import _expand

        if isinstance(paths, str):
            pattern = paths
            paths = [p for p in _expand(pattern) if os.path.isfile(p)]
            if not paths:
                raise ValueError(f"no images matched {pattern!r}")
        if labels is not None and len(labels) != len(paths):
            raise ValueError(
                f"{len(labels)} labels for {len(paths)} resolved images")
        imgs = []
        for p in paths:
            if p.lower().endswith((".jpg", ".jpeg")):
                # native libjpeg fast path; PIL rescues what libjpeg
                # rejects (CMYK/Adobe JPEGs, mislabeled PNGs)
                with open(p, "rb") as f:
                    data = f.read()
                try:
                    imgs.append(native.decode_jpeg(data))
                    continue
                except ValueError:
                    pass
            with _PILImage.open(p) as im:
                imgs.append(np.asarray(im.convert("RGB"), np.uint8))
        frame = ImageFrame.from_arrays(
            imgs, labels if labels is not None else [None] * len(imgs))
        for f, p in zip(frame.features, paths):
            f[ImageFeature.KEY_URI] = p
        return frame

    def transform(self, transformer: Transformer) -> "ImageFrame":
        return ImageFrame(list(transformer(iter(self.features))))

    def __len__(self):
        return len(self.features)

    def __iter__(self):
        return iter(self.features)


class _PerImage(Transformer):
    def apply(self, it: Iterator) -> Iterator:
        return (self.transform_one(f) for f in it)

    def transform_one(self, f: ImageFeature) -> ImageFeature:
        raise NotImplementedError


class BytesToMat(_PerImage):
    """Decode encoded image bytes into the uint8 HWC image slot —
    reference ``image/BytesToMat.scala`` (OpenCV imdecode).  Reads
    ``KEY_BYTES`` (JPEG via the native libjpeg path, anything else via
    PIL) and fills ``KEY_IMAGE``."""

    KEY_BYTES = "bytes"

    def transform_one(self, f):
        data = f.get(self.KEY_BYTES)
        if data is None:
            raise KeyError(
                "BytesToMat: feature has no 'bytes' entry "
                "(set ImageFeature(bytes=...) or load uris first)")
        try:
            f[ImageFeature.KEY_IMAGE] = native.decode_jpeg(data)
        except ValueError:
            import io

            from PIL import Image as _PILImage

            with _PILImage.open(io.BytesIO(data)) as im:
                f[ImageFeature.KEY_IMAGE] = np.asarray(
                    im.convert("RGB"), np.uint8)
        return f


class Resize(_PerImage):
    """Bilinear resize — reference ``augmentation/Resize.scala``."""

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def transform_one(self, f):
        f.image = native.resize_bilinear(f.image, self.height, self.width)
        return f


class ResizeShortSide(_PerImage):
    """Resize so the short side equals ``size`` (aspect preserved) —
    the reference ImageNet eval transform (``Resize(256) then crop``)."""

    def __init__(self, size: int):
        self.size = size

    def transform_one(self, f):
        h, w, _ = f.image.shape
        s = self.size / min(h, w)
        f.image = native.resize_bilinear(
            f.image, max(self.size, int(round(h * s))),
            max(self.size, int(round(w * s))))
        return f


class CenterCrop(_PerImage):
    """Reference ``augmentation/CenterCrop.scala``."""

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def transform_one(self, f):
        h, w, _ = f.image.shape
        oy = max(0, (h - self.height) // 2)
        ox = max(0, (w - self.width) // 2)
        f.image = native.crop(f.image, oy, ox, self.height, self.width)
        return f


class RandomCrop(_PerImage):
    """Reference ``augmentation/RandomCrop.scala``."""

    def __init__(self, height: int, width: int, seed: Optional[int] = None):
        self.height, self.width = height, width
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        h, w, _ = f.image.shape
        oy = int(self.rng.integers(0, max(1, h - self.height + 1)))
        ox = int(self.rng.integers(0, max(1, w - self.width + 1)))
        f.image = native.crop(f.image, oy, ox, self.height, self.width)
        return f


class HFlip(_PerImage):
    """Random horizontal flip — reference ``augmentation/HFlip.scala``
    (there unconditional; probability matches ``RandomTransformer(HFlip, p)``
    usage)."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        if self.rng.random() < self.p:
            f.image = native.hflip(f.image)
        return f


class ChannelNormalize(_PerImage):
    """uint8 → float32 (x/255 − mean)/std — reference
    ``augmentation/ChannelNormalize.scala`` (note: the reference operates on
    0-255 floats; here the conventional 0-1 scale, stated explicitly)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def transform_one(self, f):
        f.image = native.normalize(f.image, self.mean, self.std)
        return f


class MatToTensor(_PerImage):
    """Terminal stage: ensure float32 NHWC array — reference
    ``MatToTensor.scala`` (OpenCV Mat → Tensor; here a dtype/shape check)."""

    def transform_one(self, f):
        f.image = np.asarray(f.image, np.float32)
        return f


class ImageFrameToBatches:
    """Fused batch producer: one threaded native pass per minibatch doing
    resize→crop→flip→normalize into a contiguous (n, H, W, C) float32 batch."""

    def __init__(self, out_hw: Tuple[int, int], mean, std,
                 resize_hw: Optional[Tuple[int, int]] = None,
                 random_crop: bool = False, random_flip: bool = False,
                 seed: Optional[int] = None,
                 num_threads: Optional[int] = None):
        self.out_hw = out_hw
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.resize_hw = resize_hw
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)
        self.pipeline = native.BatchPipeline(num_threads)

    def __call__(self, frame: ImageFrame, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True
                 ) -> Iterator[MiniBatch]:
        n = len(frame)
        order = np.arange(n)
        if shuffle:
            self.rng.shuffle(order)
        stop = n - batch_size + 1 if drop_last else n
        for s in range(0, max(stop, 0), batch_size):
            idx = order[s:s + batch_size]
            feats = [frame.features[i] for i in idx]
            images = [f.image for f in feats]
            oh, ow = self.out_hw
            crops, flips = [], None
            for im in images:
                h, w = ((self.resize_hw or im.shape[:2]))
                if self.random_crop:
                    crops.append((
                        int(self.rng.integers(0, max(1, h - oh + 1))),
                        int(self.rng.integers(0, max(1, w - ow + 1)))))
                else:
                    crops.append((max(0, (h - oh) // 2),
                                  max(0, (w - ow) // 2)))
            if self.random_flip:
                flips = self.rng.random(len(images)) < 0.5
            batch = self.pipeline.process_batch(
                images, self.out_hw, self.mean, self.std,
                resize_hw=self.resize_hw, crops=crops, flips=flips)
            labels = [f.label for f in feats]
            target = (np.asarray(labels)
                      if all(l is not None for l in labels) else None)
            yield MiniBatch(input=batch, target=target)


# ---------------------------------------------------------------------------
# Streaming vision inputs: record-stored images and encoded
# JPEGs through the stage-parallel pipeline
# ---------------------------------------------------------------------------

def _index_geometry(seed, epoch, n, out_hw, resize_hw, random_crop,
                    random_flip):
    """Augmentation geometry for ALL ``n`` images of one (seed, epoch),
    keyed by DATASET INDEX: image ``i`` gets ``(cy[i], cx[i], flips[i])``
    no matter which host decodes it, which plan order reaches it, or
    whether the epoch resumed under a different process count.  This is
    what makes multi-host ingest reconstructible: N hosts' sharded
    streams concatenate byte-identically to the 1-process epoch, and a
    restart mid-epoch (the re-sharded remainder plan) re-applies the
    SAME crop/flip to every remaining image.  Drawn vectorized from one
    counter-based RNG — O(n) ints per epoch, microseconds at ImageNet
    scale."""
    oh, ow = out_hw
    rh, rw = resize_hw if resize_hw is not None else (oh, ow)
    rng = np.random.default_rng((seed, epoch))
    if random_crop:
        cy = rng.integers(0, max(1, rh - oh + 1), size=n)
        cx = rng.integers(0, max(1, rw - ow + 1), size=n)
    else:
        cy = np.full(n, max(0, (rh - oh) // 2), np.int64)
        cx = np.full(n, max(0, (rw - ow) // 2), np.int64)
    flips = (rng.random(n) < 0.5) if random_flip else None
    return cy, cx, flips


def _plan_with_geometry(index_plan, geometry):
    """Attach per-image geometry to an index plan: yields ``(sel, n_real,
    crops, flips)`` work items carrying everything decode needs, so output
    bytes are independent of worker count and host scheduling."""
    cy, cx, flips = geometry
    for sel, n_real in index_plan:
        sel = np.asarray(sel, np.int64)
        crops = list(zip(cy[sel].tolist(), cx[sel].tolist()))
        yield (sel, n_real, crops,
               None if flips is None else flips[sel])


class _ThreadLocalPipes:
    """One single-threaded native ``BatchPipeline`` per decode worker —
    the worker pool provides the parallelism, each native call keeps the
    GIL released for its sub-range."""

    def __init__(self):
        self._tls = threading.local()
        self._all: List[object] = []
        self._lock = threading.Lock()

    def get(self):
        pipe = getattr(self._tls, "pipe", None)
        if pipe is None:
            pipe = self._tls.pipe = native.BatchPipeline(num_threads=1)
            with self._lock:
                self._all.append(pipe)
        return pipe

    def close(self):
        with self._lock:
            pipes, self._all = self._all, []
        for p in pipes:
            p.close()


class AugmentedRecordImages(DataSet):
    """The ImageNet-style training input: uint8 images in a record file,
    augmented (resize → crop → flip → normalize) at batch-assembly time.

    ``batches()`` runs the stages serially in the caller's thread (kept
    for comparison and for ``host_prefetch=0``);
    ``stream_batches()`` runs them stage-parallel — mmap gather on a read
    thread, the fused native transform fanned over decode workers writing
    straight into buffer-ring slots — and is what the optimizer uses by
    default.  Both draw augmentation geometry from the same plan-order
    RNG, so they produce identical epochs."""

    def __init__(self, records, out_hw: Tuple[int, int], mean, std,
                 field: Optional[str] = None,
                 resize_hw: Optional[Tuple[int, int]] = None,
                 random_crop: bool = False, random_flip: bool = False,
                 num_threads: Optional[int] = None):
        from bigdl_tpu_torch.data.records import RecordDataSet

        if isinstance(records, str):
            records = RecordDataSet(records)
        self.records = records
        self.field = field or (
            records.feature if isinstance(records.feature, str)
            else records.feature[0])
        fld = next(f for f in records._fields if f["name"] == self.field)
        if len(fld["shape"]) != 3 or np.dtype(fld["dtype"]) != np.uint8:
            raise ValueError(
                f"field {self.field!r} is {fld['dtype']}{fld['shape']}, "
                "need uint8 HWC images")
        self.src_hw = tuple(fld["shape"][:2])
        self.channels = int(fld["shape"][2])
        self.out_hw = tuple(out_hw)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.resize_hw = tuple(resize_hw) if resize_hw is not None else None
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.num_threads = num_threads
        self._serial_pipe = None
        self._slot_cache: dict = {}
        self._geom_cache: dict = {}
        # direct view over the record region: the streaming decode reads
        # source pixels straight from the page cache — no gather memcpy,
        # no staging buffer (the read stage just plans; the OS does the IO
        # on the decode workers' first touch, still off the driver thread)
        n = int(self.records.manifest["n_records"])
        rb = int(self.records.manifest["record_bytes"])
        self._mm = np.memmap(self.records.path, np.uint8, "r", offset=24,
                             shape=(n, rb))

    def size(self) -> int:
        return self.records.size()

    def steps_per_epoch(self, batch_size: int, process_count: int = 1,
                        drop_last: bool = True) -> int:
        return self.records.steps_per_epoch(batch_size, process_count,
                                            drop_last)

    def close(self):
        self.records.close()
        self._mm = None  # drop the record-region mapping (fd + pages)
        if self._serial_pipe is not None:
            self._serial_pipe.close()
            self._serial_pipe = None

    # -- shared plumbing ---------------------------------------------------
    def _image_views(self, raw: np.ndarray, lo: int, hi: int):
        off, nbytes = self.records._offsets[self.field]
        h, w = self.src_hw
        return [raw[i, off:off + nbytes]
                .view(np.uint8).reshape(h, w, self.channels)
                for i in range(lo, hi)]

    def _label_into(self, raw, lo, hi, dst):
        label = self.records.label
        if label is None:
            return
        off, nbytes = self.records._offsets[label]
        np.copyto(dst[lo:hi].view(np.uint8).reshape(hi - lo, nbytes),
                  raw[lo:hi, off:off + nbytes])

    def _geometry(self, seed, epoch):
        """Per-image geometry of one (seed, epoch), cached ONE epoch deep
        (epochs advance monotonically; the arrays are O(n) ints)."""
        key = (seed, epoch)
        hit = self._geom_cache.get(key)
        if hit is None:
            hit = _index_geometry(seed, epoch, self.size(), self.out_hw,
                                  self.resize_hw, self.random_crop,
                                  self.random_flip)
            self._geom_cache = {key: hit}
        return hit

    def _plan(self, batch_size, shuffle, seed, epoch, drop_last,
              process_id, process_count):
        return _plan_with_geometry(
            batch_index_plan(
                self.size(), batch_size, shuffle=shuffle, seed=seed,
                epoch=epoch, drop_last=drop_last, process_id=process_id,
                process_count=process_count),
            self._geometry(seed, epoch))

    def _resharded_plan(self, batch_size, trained_batches,
                        old_process_count, shuffle, seed, epoch, drop_last,
                        process_id, process_count):
        # same geometry arrays as the interrupted epoch's plan: index-
        # keyed, so every remaining image keeps its crop/flip across the
        # process-count change
        return _plan_with_geometry(
            resharded_batch_index_plan(
                self.size(), batch_size, trained_batches=trained_batches,
                old_process_count=old_process_count, shuffle=shuffle,
                seed=seed, epoch=epoch, drop_last=drop_last,
                process_id=process_id, process_count=process_count),
            self._geometry(seed, epoch))

    def _label_spec(self):
        label = self.records.label
        if label is None:
            return None
        fld = next(f for f in self.records._fields if f["name"] == label)
        return np.dtype(fld["dtype"]), list(fld["shape"])

    # -- serial path -------------------------------------------------------
    def batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                drop_last=True, process_id=0, process_count=1):
        return self._serial(self._plan(
            batch_size, shuffle, seed, epoch, drop_last, process_id,
            process_count))

    def resharded_batches(self, batch_size, *, trained_batches,
                          old_process_count, shuffle=True, seed=0, epoch=0,
                          drop_last=True, process_id=0, process_count=1):
        """Finish an epoch interrupted under a different process count —
        the elastic resume plan with the SAME index-keyed augmentation
        geometry the interrupted epoch used."""
        return self._serial(self._resharded_plan(
            batch_size, trained_batches, old_process_count, shuffle, seed,
            epoch, drop_last, process_id, process_count))

    def _serial(self, plan):
        if self._serial_pipe is None:
            self._serial_pipe = native.BatchPipeline(self.num_threads)
        pipe = self._serial_pipe
        per_host = None
        for sel, n_real, crops, flips in plan:
            per_host = len(sel)
            raw = self.records._gather(sel)
            images = self._image_views(raw, 0, per_host)
            batch = pipe.process_batch(
                images, self.out_hw, self.mean, self.std,
                resize_hw=self.resize_hw, crops=crops,
                flips=None if flips is None else list(flips))
            mb = MiniBatch(input=batch)
            lspec = self._label_spec()
            if lspec is not None:
                dt, shape = lspec
                y = np.empty([per_host] + shape, dt)
                self._label_into(raw, 0, per_host, y)
                mb["target"] = y
            if n_real < per_host:
                w = np.zeros(per_host, np.float32)
                w[:n_real] = 1.0
                mb["weight"] = w
            yield mb

    # -- streaming path ----------------------------------------------------
    def stream_batches(self, batch_size, *, shuffle=True, seed=0, epoch=0,
                       drop_last=True, process_id=0, process_count=1,
                       workers=None, parts_per_batch=None,
                       raw_depth=None, ring_depth=None, metrics=None):
        """Stage-parallel epochs, sharded per host: with ``process_id``/
        ``process_count`` each host decodes ONLY its stride slice of the
        shared permutation, and augmentation geometry is index-keyed
        (:func:`_index_geometry`) so the N hosts' streams concatenate
        byte-identically to the 1-process epoch."""
        plan = self._plan(batch_size, shuffle, seed, epoch, drop_last,
                          process_id, process_count)
        return self._stream(plan, _per_host_batch(batch_size,
                                                  process_count),
                            workers, parts_per_batch, raw_depth,
                            ring_depth, metrics)

    def resharded_stream_batches(self, batch_size, *, trained_batches,
                                 old_process_count, shuffle=True, seed=0,
                                 epoch=0, drop_last=True, process_id=0,
                                 process_count=1, workers=None,
                                 parts_per_batch=None, raw_depth=None,
                                 ring_depth=None, metrics=None):
        """:meth:`resharded_batches` through the streaming pipeline — the
        elastic mid-epoch resume stays stage-parallel, with each image's
        geometry preserved across the process-count change."""
        plan = self._resharded_plan(
            batch_size, trained_batches, old_process_count, shuffle, seed,
            epoch, drop_last, process_id, process_count)
        return self._stream(plan, _per_host_batch(batch_size,
                                                  process_count),
                            workers, parts_per_batch, raw_depth,
                            ring_depth, metrics)

    def _stream(self, plan, per_host, workers, parts_per_batch, raw_depth,
                ring_depth, metrics):
        from bigdl_tpu_torch.data.pipeline import (
            StreamingPipeline, autotune_depths, autotune_workers,
            cached_slots, fill_pad_weights,
        )

        oh, ow = self.out_hw
        spec = {"input": ((per_host, oh, ow, self.channels), np.float32),
                "weight": ((per_host,), np.float32)}
        lspec = self._label_spec()
        if lspec is not None:
            dt, shape = lspec
            spec["target"] = (tuple([per_host] + shape), dt)

        # decode (resize+crop+flip+normalize) is the slow stage by
        # construction — the read stage only plans over the mmap — so the
        # pool takes every core the host can spare
        workers_eff = workers or autotune_workers()
        if raw_depth is None or ring_depth is None:
            tuned = autotune_depths(0, 0, workers_eff,
                                    parts_per_batch=parts_per_batch)
            raw_depth = raw_depth or tuned["raw_depth"]
            ring_depth = ring_depth or tuned["ring_depth"]
        slots = cached_slots(self._slot_cache, spec, ring_depth)
        pipes = _ThreadLocalPipes()
        mm = self._mm
        img_off, img_nbytes = self.records._offsets[self.field]
        h, w_, c = self.src_hw + (self.channels,)

        def fetch(item, slot):
            return None  # decode reads the mapped records directly

        def decode(item, raw, buffers, lo, hi, slot):
            sel, n_real, crops, flips = item
            images = [mm[int(i)][img_off:img_off + img_nbytes]
                      .reshape(h, w_, c) for i in sel[lo:hi]]
            pipes.get().process_batch(
                images, self.out_hw, self.mean, self.std,
                resize_hw=self.resize_hw, crops=crops[lo:hi],
                flips=None if flips is None else list(flips[lo:hi]),
                out=buffers["input"][lo:hi])
            if "target" in buffers:
                loff, lnbytes = self.records._offsets[self.records.label]
                dst = buffers["target"][lo:hi]
                dstv = dst.view(np.uint8).reshape(hi - lo, lnbytes)
                for j, i in enumerate(sel[lo:hi]):
                    dstv[j] = mm[int(i)][loff:loff + lnbytes]
            fill_pad_weights(buffers["weight"], n_real, lo, hi)
            return {"n": len(sel), "n_real": n_real}

        def finalize(buffers, meta):
            fields = {"input": buffers["input"]}
            if "target" in buffers:
                fields["target"] = buffers["target"]
            if meta["n_real"] < meta["n"]:
                fields["weight"] = buffers["weight"]
            return fields

        return StreamingPipeline(
            plan, fetch, decode, spec, rows=per_host, workers=workers_eff,
            parts_per_batch=parts_per_batch, raw_depth=raw_depth,
            ring_depth=ring_depth, slots=slots, finalize=finalize,
            on_close=pipes.close, metrics=metrics)


def stream_jpeg_batches(sources, batch_size, out_hw, mean, std, *,
                        labels=None, resize_hw=None, random_crop=False,
                        random_flip=False, shuffle=False, seed=0, epoch=0,
                        drop_last=True, process_id=0, process_count=1,
                        workers=None, parts_per_batch=None,
                        use_processes: object = "auto",
                        ring_depth=None, raw_depth=None, metrics=None):
    """Stream encoded JPEGs (file paths or ``bytes``) through the
    stage-parallel pipeline: file reads on the read thread, decode+augment
    fanned over workers — ``BatchPipeline.decode_batch`` sub-batches in
    parallel when the native libjpeg path is available, a shared-memory
    multiprocess PIL pool otherwise (``use_processes`` True/False/"auto").
    Yields :class:`~bigdl_tpu_torch.data.pipeline.RingBatch` with ``input`` (and
    ``target`` when ``labels`` is given).

    ``process_id``/``process_count`` shard the stream per host: each process reads and decodes ONLY its
    stride slice of the shared (seed, epoch) permutation, with
    augmentation geometry keyed by SOURCE INDEX so the hosts' streams
    concatenate byte-identically to the 1-process epoch."""
    from bigdl_tpu_torch.data.pipeline import (
        SharedMemoryDecodePool, StreamingPipeline, autotune_depths,
        autotune_workers, fill_pad_weights,
    )
    from bigdl_tpu_torch.native import lib as nat

    sources = list(sources)
    n = len(sources)
    labels = None if labels is None else np.asarray(labels)
    if labels is not None and len(labels) != n:
        raise ValueError(f"{len(labels)} labels for {n} images")
    if resize_hw is None:
        # decode dims are unknown before decode: crop geometry needs the
        # deterministic post-resize frame
        raise ValueError("stream_jpeg_batches requires resize_hw "
                         "(crop geometry is planned before decode)")
    per_host = _per_host_batch(batch_size, process_count)
    oh, ow = out_hw
    if use_processes == "auto":
        use_processes = not (nat.available() and nat.jpeg_available())

    workers_eff = workers or autotune_workers()
    if ring_depth is None or raw_depth is None:
        tuned = autotune_depths(0, 0, workers_eff)
        ring_depth = ring_depth or tuned["ring_depth"]
        raw_depth = raw_depth or tuned["raw_depth"]

    pool = None
    slots = None
    if use_processes:
        pool = SharedMemoryDecodePool(per_host, out_hw, depth=ring_depth,
                                      workers=workers_eff)
        slots = [dict(s, weight=np.empty((per_host,), np.float32))
                 for s in pool.ring_slots(("input",))]
    spec = {"input": ((per_host, oh, ow, 3), np.float32),
            "weight": ((per_host,), np.float32)}

    def plan_gen():
        return _plan_with_geometry(
            batch_index_plan(
                n, batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                drop_last=drop_last, process_id=process_id,
                process_count=process_count),
            _index_geometry(seed, epoch, n, out_hw, resize_hw,
                            random_crop, random_flip))

    def fetch(item, slot):
        sel = item[0]
        out = []
        for i in sel:
            s = sources[i]
            if isinstance(s, (bytes, bytearray)):
                out.append(bytes(s))
            else:
                with open(s, "rb") as f:
                    out.append(f.read())
        return out

    pipes = _ThreadLocalPipes()

    def decode(item, raw, buffers, lo, hi, slot):
        sel, n_real, crops, flips = item
        sub_flips = None if flips is None else list(flips[lo:hi])
        if pool is not None:
            pool.submit_rows(slot, lo, raw[lo:hi], mean, std,
                             resize_hw=resize_hw, crops=crops[lo:hi],
                             flips=sub_flips)
        else:
            pipes.get().decode_batch(
                raw[lo:hi], out_hw, mean, std, resize_hw=resize_hw,
                crops=crops[lo:hi], flips=sub_flips,
                out=buffers["input"][lo:hi])
        fill_pad_weights(buffers["weight"], n_real, lo, hi)
        meta = {"n": len(sel), "n_real": n_real}
        if labels is not None and lo == 0:
            meta["target"] = labels[np.asarray(sel)]
        return meta

    def finalize(buffers, meta):
        fields = {"input": buffers["input"]}
        if "target" in meta:
            fields["target"] = meta["target"]
        if meta["n_real"] < meta["n"]:
            fields["weight"] = buffers["weight"]
        return fields

    def on_close():
        pipes.close()
        if pool is not None:
            pool.close()

    return StreamingPipeline(
        plan_gen(), fetch, decode, spec, rows=per_host, workers=workers_eff,
        parts_per_batch=parts_per_batch, raw_depth=raw_depth,
        ring_depth=ring_depth, slots=slots, finalize=finalize,
        on_close=on_close, metrics=metrics)
