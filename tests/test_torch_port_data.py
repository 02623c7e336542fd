"""The port's data side against the JAX package on the CPU: the native
library (bit for bit, and against its numpy fallback), record files
written by either package and read by the other, record batches and
augmented image epochs, JPEG decode, the per-image vision transformers,
augmentation, segmentation, text, XShards, the dataset helpers, the
histogram, and summaries read across the packages.

Everything here is host code with the same arithmetic in both packages,
so the comparisons are exact unless a line says otherwise (the native
resize against its numpy fallback: within 1 level; normalize against
numpy: 1e-5, as ``tests/test_native_vision.py`` holds the JAX side)."""

import io
import json
import os
import struct

import numpy as np
import pytest

from bigdl_tpu import native as jnative
from bigdl_tpu.data import augmentation as jaug
from bigdl_tpu.data import dataset as jdataset
from bigdl_tpu.data import segmentation as jseg
from bigdl_tpu.data import shards as jshards
from bigdl_tpu.data import text as jtext
from bigdl_tpu.data import vision as jvision
from bigdl_tpu.data.records import RecordDataSet as JRecordDataSet
from bigdl_tpu.data.records import write_records as jwrite_records
from bigdl_tpu.native import lib as jlib
from bigdl_tpu.obs.hist import LogHistogram as JLogHistogram
from bigdl_tpu.optim.metrics import SummaryWriter as JSummaryWriter
from bigdl_tpu.utils import tbwriter as jtb
from bigdl_tpu_torch import native
from bigdl_tpu_torch.data import augmentation as aug
from bigdl_tpu_torch.data import dataset
from bigdl_tpu_torch.data import segmentation as seg
from bigdl_tpu_torch.data import shards
from bigdl_tpu_torch.data import text
from bigdl_tpu_torch.data import vision
from bigdl_tpu_torch.data.records import RecordDataSet, write_records
from bigdl_tpu_torch.native import lib
from bigdl_tpu_torch.obs.hist import LogHistogram
from bigdl_tpu_torch.optim.metrics import (Metrics, SummaryWriter,
                                           TrainSummary, ValidationSummary)
from bigdl_tpu_torch.utils import storage, tbwriter

MEAN = np.asarray([0.485, 0.456, 0.406], np.float32) * 255
STD = np.asarray([0.229, 0.224, 0.225], np.float32) * 255


def _img(rng, h=32, w=48, c=3):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def _jpeg(rs, h, w, quality=90):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native library built afresh by this process, as
    its loader builds it, into a directory of its own: a shared cache
    that test workers built at once may hold its no-libjpeg variant."""
    saved = jlib._CACHE_DIR, jlib._lib, jlib._tried
    jlib._CACHE_DIR = str(tmp_path_factory.mktemp("jax_native"))
    jlib._lib, jlib._tried = None, False
    try:
        assert jlib.available()
        yield jlib
    finally:
        jlib._CACHE_DIR, jlib._lib, jlib._tried = saved


class _Fallback:
    """The port's (and the JAX package's) numpy path: the loaded library
    hidden for the duration."""

    def __enter__(self):
        self.saved = lib._lib, jlib._lib
        lib._lib = jlib._lib = None

    def __exit__(self, *a):
        lib._lib, jlib._lib = self.saved


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

def test_native_library_builds_into_build_dir():
    assert native.available() and jnative.available()
    built = [p for p in os.listdir(lib.BUILD_DIR)
             if p.startswith("bigdl_tpu_io-") and p.endswith(".so")]
    assert built
    assert native.jpeg_available() == jnative.jpeg_available()
    assert (native.jpeg_unavailable_reason() is None) == \
        native.jpeg_available()


def test_concurrent_first_builds_land_whole(tmp_path, monkeypatch):
    """Three threads building at once (as test workers do) each land a
    whole library under the same name through their own temporary."""
    import threading

    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path)
    so = lib._target("nojpeg", ("-DBTIO_NO_JPEG", "-lpthread"))
    errs = []
    threads = [threading.Thread(target=lambda: errs.append(lib._compile(
        so, ("-DBTIO_NO_JPEG", "-lpthread")))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert errs == [None] * 3 and not any(t.is_alive() for t in threads)
    assert os.listdir(tmp_path) == [so.name]
    import ctypes

    assert ctypes.CDLL(str(so)).btio_version() == 4


@pytest.mark.parametrize("fallback", [False, True])
def test_single_image_ops_equal_jax(fallback):
    rng = np.random.default_rng(0)
    img = _img(rng)
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]
    ctx = _Fallback() if fallback else open(os.devnull)
    with ctx:
        for ours, theirs in (
                (native.resize_bilinear(img, 16, 24),
                 jnative.resize_bilinear(img, 16, 24)),
                (native.resize_bilinear(img, 50, 61),
                 jnative.resize_bilinear(img, 50, 61)),
                (native.crop(img, 2, 3, 10, 12),
                 jnative.crop(img, 2, 3, 10, 12)),
                (native.hflip(img), jnative.hflip(img)),
                (native.normalize(img, mean, std),
                 jnative.normalize(img, mean, std))):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
        with pytest.raises(ValueError, match="out of bounds"):
            native.crop(img, 0, 0, 40, 40)


def test_native_ops_match_their_numpy_fallback():
    rng = np.random.default_rng(1)
    img = _img(rng)
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]
    fast = (native.resize_bilinear(img, 16, 24), native.crop(img, 2, 3, 10,
                                                             12),
            native.hflip(img), native.normalize(img, mean, std))
    with _Fallback():
        slow = (native.resize_bilinear(img, 16, 24),
                native.crop(img, 2, 3, 10, 12), native.hflip(img),
                native.normalize(img, mean, std))
    assert np.abs(fast[0].astype(int) - slow[0].astype(int)).max() <= 1
    np.testing.assert_array_equal(fast[1], img[2:12, 3:15])
    np.testing.assert_array_equal(fast[1], slow[1])
    np.testing.assert_array_equal(fast[2], img[:, ::-1])
    np.testing.assert_array_equal(fast[2], slow[2])
    np.testing.assert_allclose(fast[3], slow[3], rtol=1e-5, atol=1e-5)


def test_process_batch_and_gather_rows_equal_jax():
    rng = np.random.default_rng(2)
    images = [_img(rng, 40, 50) for _ in range(7)]
    kw = dict(resize_hw=(32, 32), crops=[(4, 4), (0, 8)] * 3 + [(8, 0)],
              flips=[True, False] * 3 + [True])
    pipe, jpipe = native.BatchPipeline(2), jnative.BatchPipeline(2)
    try:
        out = pipe.process_batch(images, (24, 24), MEAN, STD, **kw)
        want = jpipe.process_batch(images, (24, 24), MEAN, STD, **kw)
        np.testing.assert_array_equal(out, want)
        # into a caller's buffer (a ring slot), per-image resize sizes
        slot = np.empty((7, 24, 24, 3), np.float32)
        per = [(32, 32), (30, 36)] * 3 + [(26, 26)]
        got = pipe.process_batch(images, (24, 24), MEAN, STD,
                                 resize_hw=per, out=slot)
        assert got is slot
        np.testing.assert_array_equal(slot, jpipe.process_batch(
            images, (24, 24), MEAN, STD, resize_hw=per))
        # image 1 (no flip), held to the single-image ops
        r = native.resize_bilinear(images[1], 32, 32)[0:24, 8:32]
        np.testing.assert_allclose(
            out[1], (r.astype(np.float32) / 255.0 - MEAN) / STD, atol=1e-5)
        with pytest.raises(ValueError, match="out buffer"):
            pipe.process_batch(images, (24, 24), MEAN, STD, out=slot[:3],
                               **kw)
        src = rng.standard_normal((20, 6, 4)).astype(np.float32)
        idx = np.array([3, 0, 19, 7], np.int64)
        np.testing.assert_array_equal(pipe.gather_rows(src, idx), src[idx])
        np.testing.assert_array_equal(pipe.gather_rows(src, idx),
                                      jpipe.gather_rows(src, idx))
    finally:
        pipe.close()
        jpipe.close()
    with _Fallback():
        slow = native.BatchPipeline(2).process_batch(images, (24, 24), MEAN,
                                                     STD, **kw)
    # the resize within 1 level of its numpy fallback
    np.testing.assert_allclose(out, slow, atol=1 / 255 / STD.min() + 1e-5)


def test_jpeg_decode_equals_jax():
    rs = np.random.RandomState(3)
    enc = [_jpeg(rs, 48, 64), _jpeg(rs, 40, 40), _jpeg(rs, 64, 48)]
    for e in enc:
        np.testing.assert_array_equal(native.decode_jpeg(e),
                                      jnative.decode_jpeg(e))
    kw = dict(resize_hw=(36, 36), crops=[(0, 0), (2, 2), (4, 4)],
              flips=[False, True, False])
    pipe, jpipe = native.BatchPipeline(2), jnative.BatchPipeline(2)
    try:
        out = pipe.decode_batch(enc, (32, 32), MEAN, STD, **kw)
        np.testing.assert_array_equal(
            out, jpipe.decode_batch(enc, (32, 32), MEAN, STD, **kw))
        np.testing.assert_allclose(out, pipe.process_batch(
            [native.decode_jpeg(e) for e in enc], (32, 32), MEAN, STD, **kw),
            atol=1e-5)
        with pytest.raises(ValueError):
            native.decode_jpeg(b"\xff\xd8\xff notajpeg")
        with pytest.raises(ValueError):
            pipe.decode_batch([b"\xff\xd8\xff junk"], (8, 8), MEAN, STD)
        if native.jpeg_available():
            with pytest.raises(ValueError, match="geometry bug"):
                pipe.decode_batch(enc[1:2], (48, 48), MEAN, STD)
    finally:
        pipe.close()
        jpipe.close()


def test_native_jpeg_encoder_round_trips():
    """The port's encoder (beyond the JAX ABI, for hosts without an
    imaging library): both packages' decoders read its bytes the same,
    PIL within a few levels, and all within a few levels of a smooth
    source."""
    from PIL import Image

    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([yy * 5, xx * 4, (yy + xx) * 2], -1).astype(np.uint8)
    data = native.encode_jpeg(img, quality=95)
    got = native.decode_jpeg(data)
    np.testing.assert_array_equal(got, jnative.decode_jpeg(data))
    # another IDCT may differ by a few levels (test_native_vision.py)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.int16)
    assert np.abs(got - pil).mean() < 2.0 and np.abs(got - pil).max() <= 32
    assert np.abs(got.astype(int) - img).mean() < 2.0
    with pytest.raises(ValueError, match="RGB"):
        native.encode_jpeg(img[..., :2])


# ---------------------------------------------------------------------------
# record files
# ---------------------------------------------------------------------------

@pytest.fixture
def rec_pair(tmp_path):
    rs = np.random.RandomState(0)
    x = rs.rand(100, 4, 4, 3).astype(np.float32)
    y = rs.randint(0, 5, 100).astype(np.int32)
    z = rs.randint(0, 9, (100, 2)).astype(np.int64)
    mine, theirs = str(tmp_path / "port.btrec"), str(tmp_path / "jax.btrec")
    write_records(mine, {"x": x, "y": y, "z": z})
    jwrite_records(theirs, {"x": x, "y": y, "z": z})
    return mine, theirs, (x, y, z)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for ma, mb in zip(a, b):
        assert sorted(ma) == sorted(mb)
        for k in ma:
            va, vb = ma[k], mb[k]
            if isinstance(va, tuple):
                for ua, ub in zip(va, vb):
                    np.testing.assert_array_equal(ua, ub)
            else:
                assert np.asarray(va).dtype == np.asarray(vb).dtype
                np.testing.assert_array_equal(va, vb)


def test_record_files_cross_packages(rec_pair):
    mine, theirs, (x, y, z) = rec_pair
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    with open(mine + ".json") as f, open(theirs + ".json") as g:
        assert json.load(f) == json.load(g)
    for path in (mine, theirs):
        ds, jds = RecordDataSet(path), JRecordDataSet(path)
        got = np.concatenate([mb["input"] for mb in ds.batches(
            20, shuffle=False)])
        np.testing.assert_array_equal(got, x)
        _same_batches(ds.batches(16, seed=3, epoch=1, drop_last=False),
                      jds.batches(16, seed=3, epoch=1, drop_last=False))
        ds.close()
        jds.close()


@pytest.mark.parametrize("pid", [0, 1])
def test_record_batches_equal_jax_per_process(rec_pair, pid):
    mine, _, _ = rec_pair
    ds, jds = RecordDataSet(mine), JRecordDataSet(mine)
    kw = dict(shuffle=True, seed=5, process_id=pid, process_count=2)
    _same_batches(ds.batches(32, **kw), jds.batches(32, **kw))
    _same_batches(ds.batches(32, drop_last=False, **kw),
                  jds.batches(32, drop_last=False, **kw))
    # the elastic remainder plan, and multi-field feature packs
    rkw = dict(trained_batches=1, old_process_count=1, **kw)
    _same_batches(ds.resharded_batches(16, **rkw),
                  jds.resharded_batches(16, **rkw))
    pack, jpack = (RecordDataSet(mine, feature=["x", "z"], label="y"),
                   JRecordDataSet(mine, feature=["x", "z"], label="y"))
    _same_batches(pack.batches(8, **kw), jpack.batches(8, **kw))
    assert ds.steps_per_epoch(32, 2) == jds.steps_per_epoch(32, 2)
    for d in (ds, jds, pack, jpack):
        d.close()


def test_record_files_refuse_bad_input(rec_pair, tmp_path, monkeypatch):
    mine, _, _ = rec_pair
    with pytest.raises(ValueError):
        write_records(str(tmp_path / "b.btrec"),
                      {"x": np.zeros((3, 2)), "y": np.zeros(4)})
    with pytest.raises(ValueError, match="at least one byte"):
        write_records(str(tmp_path / "w.btrec"), {"x": np.zeros((3, 0))})
    with pytest.raises(ValueError, match="not in manifest"):
        RecordDataSet(mine, feature="nope")
    for name, header in (("evil", (2 ** 32, 2 ** 32)), ("zero", (0, 5))):
        p = str(tmp_path / f"{name}.btrec")
        with open(p, "wb") as f:
            f.write(b"BTRECv1\0" + struct.pack("<QQ", *header) + b"\0" * 64)
        with pytest.raises(ValueError, match="not a BTRECv1 record file"):
            lib.RecordReader(p)
    with pytest.raises(ValueError, match="not a BTRECv1 record file"):
        lib.RecordReader(mine + ".json")
    with open(mine + ".json") as f:
        manifest = json.load(f)
    manifest["n_records"] = 10_000
    with open(mine + ".json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="does not match record header"):
        RecordDataSet(mine)
    monkeypatch.setattr(lib, "available", lambda: False)
    with pytest.raises(ValueError, match="does not match record header"):
        RecordDataSet(mine)


def test_record_dataset_numpy_fallback_and_remote_cache(rec_pair, tmp_path,
                                                        monkeypatch):
    """Without the native library the memmap path gives the same
    batches; a ``memory://`` record pair downloads into the local cache
    once and is fetched again when the remote changes."""
    mine, _, (x, y, _) = rec_pair
    native_batches = [dict(mb) for mb in RecordDataSet(mine).batches(
        16, seed=2)]
    monkeypatch.setattr(lib, "available", lambda: False)
    _same_batches(RecordDataSet(mine).batches(16, seed=2), native_batches)
    monkeypatch.undo()
    monkeypatch.setenv("BIGDL_TPU_RECORD_CACHE", str(tmp_path / "cache"))
    uri = "memory://port-records/train.btrec"
    write_records(uri, {"x": x, "y": y})
    ds = RecordDataSet(uri)
    assert ds.path.startswith(str(tmp_path / "cache"))
    np.testing.assert_array_equal(next(iter(ds.batches(
        100, shuffle=False)))["input"], x)
    write_records(uri, {"x": x[:50], "y": y[:50]})
    assert RecordDataSet(uri).size() == 50
    storage.remove_tree("memory://port-records")


# ---------------------------------------------------------------------------
# augmented record images
# ---------------------------------------------------------------------------

@pytest.fixture
def img_rec(tmp_path):
    rs = np.random.RandomState(7)
    xs = rs.randint(0, 255, (48, 40, 40, 3), np.uint8)
    ys = rs.randint(0, 10, 48).astype(np.int32)
    p = str(tmp_path / "imgs.btrec")
    write_records(p, {"image": xs, "label": ys})
    return p


def _snap(mb):
    return {k: np.array(v) for k, v in mb.items()}


@pytest.mark.parametrize("crop,flip", [(True, True), (False, False)])
def test_augmented_epochs_equal_jax(img_rec, crop, flip):
    kw = dict(resize_hw=(32, 32), random_crop=crop, random_flip=flip)
    ds = vision.AugmentedRecordImages(img_rec, (24, 24), MEAN, STD, **kw)
    jds = jvision.AugmentedRecordImages(img_rec, (24, 24), MEAN, STD, **kw)
    for epoch in (0, 2):
        ref = [_snap(mb) for mb in jds.batches(16, seed=5, epoch=epoch,
                                               drop_last=False)]
        _same_batches(ds.batches(16, seed=5, epoch=epoch, drop_last=False),
                      ref)
        for w in (1, 3):
            _same_batches((_snap(mb) for mb in ds.stream_batches(
                16, seed=5, epoch=epoch, drop_last=False, workers=w)), ref)
    rkw = dict(trained_batches=1, old_process_count=1, seed=5, epoch=1,
               process_id=1, process_count=2)
    ref = [_snap(mb) for mb in jds.resharded_batches(16, **rkw)]
    _same_batches(ds.resharded_batches(16, **rkw), ref)
    _same_batches((_snap(mb) for mb in ds.resharded_stream_batches(
        16, workers=2, **rkw)), ref)
    ds.close()
    jds.close()


def test_augmented_images_refuse_non_image_fields(tmp_path):
    p = str(tmp_path / "f.btrec")
    write_records(p, {"x": np.zeros((4, 3, 3, 3), np.float32)})
    with pytest.raises(ValueError, match="need uint8 HWC"):
        vision.AugmentedRecordImages(p, (2, 2), MEAN, STD)


def test_stream_jpeg_batches_equal_jax():
    rs = np.random.RandomState(4)
    enc = [_jpeg(rs, 40, 44) for _ in range(20)]
    labels = rs.randint(0, 10, 20)
    kw = dict(labels=labels, resize_hw=(32, 32), random_crop=True,
              random_flip=True, shuffle=True, seed=1, epoch=1,
              drop_last=False)
    want = [_snap(mb) for mb in jvision.stream_jpeg_batches(
        enc, 8, (24, 24), MEAN, STD, workers=2, use_processes=False, **kw)]
    for w in (1, 3):
        _same_batches((_snap(mb) for mb in vision.stream_jpeg_batches(
            enc, 8, (24, 24), MEAN, STD, workers=w, use_processes=False,
            **kw)), want)
    with pytest.raises(ValueError, match="requires resize_hw"):
        vision.stream_jpeg_batches(enc, 8, (24, 24), MEAN, STD)


# ---------------------------------------------------------------------------
# per-image transformers, augmentation, segmentation
# ---------------------------------------------------------------------------

def _frames(rng, n=4, h=40, w=44):
    imgs = [_img(rng, h, w) for _ in range(n)]
    return (vision.ImageFrame.from_arrays(imgs, list(range(n))),
            jvision.ImageFrame.from_arrays(imgs, list(range(n))))


def _same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.image.dtype == fb.image.dtype
        np.testing.assert_array_equal(fa.image, fb.image)
        assert fa.label == fb.label


def test_vision_transformers_equal_jax():
    rng = np.random.default_rng(5)
    ours, theirs = _frames(rng)

    def chain(m):
        return (m.ResizeShortSide(36) >> m.RandomCrop(30, 30, seed=3)
                >> m.HFlip(0.5, seed=4) >> m.Resize(28, 28)
                >> m.CenterCrop(24, 24)
                >> m.ChannelNormalize([0.5] * 3, [0.25] * 3)
                >> m.MatToTensor())

    _same_frames(ours.transform(chain(vision)),
                 theirs.transform(chain(jvision)))
    o2, t2 = _frames(np.random.default_rng(6), n=10)
    kw = dict(resize_hw=(32, 32), random_crop=True, random_flip=True,
              seed=0)
    _same_batches(vision.ImageFrameToBatches((24, 24), MEAN, STD, **kw)(
        o2, batch_size=4, shuffle=True), jvision.ImageFrameToBatches(
        (24, 24), MEAN, STD, **kw)(t2, batch_size=4, shuffle=True))
    enc = _jpeg(np.random.RandomState(0), 30, 40)
    got = vision.ImageFrame([vision.ImageFeature(bytes=enc, label=1)]
                            ).transform(vision.BytesToMat()
                                        >> vision.Resize(16, 16))
    want = jvision.ImageFrame([jvision.ImageFeature(bytes=enc, label=1)]
                              ).transform(jvision.BytesToMat()
                                          >> jvision.Resize(16, 16))
    _same_frames(got, want)
    with pytest.raises(KeyError, match="bytes"):
        vision.ImageFrame([vision.ImageFeature(image=np.zeros(
            (4, 4, 3)))]).transform(vision.BytesToMat())


def test_image_frame_read_equals_jax(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(8)
    for i in range(3):
        Image.fromarray((rs.rand(20, 24, 3) * 255).astype(np.uint8)).save(
            str(tmp_path / f"im{i}.jpg"), quality=90)
    Image.fromarray((rs.rand(18, 22, 3) * 255).astype(np.uint8)).save(
        str(tmp_path / "im3.png"))
    got = vision.ImageFrame.read(str(tmp_path))
    want = jvision.ImageFrame.read(str(tmp_path))
    _same_frames(got, want)
    assert [f["uri"] for f in got] == [f["uri"] for f in want]


@pytest.mark.parametrize("name,args", [
    ("Brightness", (-32.0, 32.0, 1)), ("Contrast", (0.5, 1.5, 2)),
    ("Saturation", (0.5, 1.5, 3)), ("Hue", (18.0, 4)),
    ("ChannelOrder", ()), ("Grayscale", ()),
    ("Expand", (2.0, (123, 117, 104), 5)),
    ("Filler", (0.1, 0.2, 0.6, 0.7, 9)), ("FixedCrop", (0.1, 0.2, 0.6, 0.9)),
    ("AspectScale", (20, 60)), ("RandomAspectScale", ([16, 24, 30], 60, 6)),
])
def test_augmentation_equals_jax(name, args):
    ours, theirs = _frames(np.random.default_rng(9))
    _same_frames(ours.transform(getattr(aug, name)(*args)),
                 theirs.transform(getattr(jaug, name)(*args)))


def test_composite_augmentation_equals_jax():
    ours, theirs = _frames(np.random.default_rng(10), n=6)
    _same_frames(
        ours.transform(aug.ColorJitter(hue=10.0, seed=1)
                       >> aug.RandomTransformer(vision.HFlip(1.0), 0.5, 2)
                       >> aug.PixelNormalizer(np.full((40, 44, 3), 100.0))),
        theirs.transform(jaug.ColorJitter(hue=10.0, seed=1)
                         >> jaug.RandomTransformer(jvision.HFlip(1.0), 0.5, 2)
                         >> jaug.PixelNormalizer(np.full((40, 44, 3),
                                                         100.0))))


def test_segmentation_equals_jax():
    rng = np.random.default_rng(11)
    mask = (rng.random((13, 17)) > 0.6).astype(np.uint8)
    rle = seg.rle_encode(mask)
    assert rle == jseg.rle_encode(mask)
    np.testing.assert_array_equal(seg.rle_decode(rle), mask)
    assert seg.rle_area(rle) == jseg.rle_area(rle) == int(mask.sum())
    compressed = {"counts": "52203", "size": [4, 4]}  # pycocotools' form
    np.testing.assert_array_equal(seg.rle_decode(compressed),
                                  jseg.rle_decode(compressed))
    assert seg.rle_area(compressed) == jseg.rle_area(compressed)
    polys = [[2.0, 2.0, 14.0, 3.0, 9.0, 11.0], [1.0, 1.0, 3.0, 1.0]]
    np.testing.assert_array_equal(seg.polygons_to_mask(polys, 13, 17),
                                  jseg.polygons_to_mask(polys, 13, 17))
    assert seg.mask_to_bbox(mask) == jseg.mask_to_bbox(mask)
    assert seg.mask_to_bbox(np.zeros((3, 3))) == [0.0] * 4
    for ann in ({"segmentation": rle}, {"segmentation": polys}):
        np.testing.assert_array_equal(seg.annotation_to_mask(ann, 13, 17),
                                      jseg.annotation_to_mask(ann, 13, 17))


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

CORPUS = ["the cat sat on the mat", "a dog ran", "the dog sat",
          "line\nbreak tok\\en", "on on on the the mat mat"]


def test_vocabulary_round_trips_across_packages(tmp_path):
    toks = [s.split(" ") for s in CORPUS]
    v = text.Vocabulary.build(toks, max_size=8)
    jv = jtext.Vocabulary.build(toks, max_size=8)
    assert v.itos == jv.itos and v.stoi == jv.stoi
    ids = v.encode(toks[0] + ["unseen"], add_bos=True, add_eos=True)
    assert ids == jv.encode(toks[0] + ["unseen"], add_bos=True,
                            add_eos=True)
    assert v.decode(ids) == jv.decode(ids)
    mine, theirs = str(tmp_path / "v.txt"), str(tmp_path / "jv.txt")
    v.save(mine)
    jv.save(theirs)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert jtext.Vocabulary.load(mine).itos == v.itos
    assert text.Vocabulary.load(theirs).itos == jv.itos
    legacy = str(tmp_path / "legacy.txt")
    with open(legacy, "w") as f:
        f.write("<pad>\n<unk>\nx\\ny\n")
    assert text.Vocabulary.load(legacy).itos == \
        jtext.Vocabulary.load(legacy).itos


def test_text_batches_and_lm_arrays_equal_jax():
    rng = np.random.default_rng(12)
    encoded = [list(rng.integers(4, 50, rng.integers(1, 40)))
               for _ in range(30)]
    labels = list(rng.integers(0, 3, 30))
    kw = dict(buckets=(8, 16, 32), batch_size=4, shuffle=True, seed=3)
    _same_batches(text.TextBatcher(**kw)(encoded, labels),
                  jtext.TextBatcher(**kw)(encoded, labels))
    corpus = " ".join(CORPUS) * 3
    x, y, v = text.language_model_arrays(corpus, None, 7)
    jx, jy, jv = jtext.language_model_arrays(corpus, None, 7)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert v.itos == jv.itos
    wx, _, _ = text.language_model_arrays(corpus, v, 3,
                                          tokenizer=text.word_tokenize)
    np.testing.assert_array_equal(wx, jtext.language_model_arrays(
        corpus, jv, 3, tokenizer=jtext.word_tokenize)[0])
    with pytest.raises(ValueError, match="too short"):
        text.language_model_arrays("ab", None, 8)


# ---------------------------------------------------------------------------
# XShards, datasets, storage
# ---------------------------------------------------------------------------

def test_xshards_equal_jax(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(13)
    data = {"x": rng.standard_normal((23, 3)), "y": np.arange(23)}
    xs = shards.XShards.partition(data, num_shards=4)
    jxs = jshards.XShards.partition(data, num_shards=4)
    assert xs.num_partitions() == jxs.num_partitions() == 4
    for a, b in zip(xs.collect(), jxs.collect()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    t = xs.transform_shard(lambda s, k: {**s, "x": s["x"] * k}, 2.0)
    np.testing.assert_array_equal(t.concat()["x"], data["x"] * 2.0)
    np.testing.assert_array_equal(xs.repartition(3).owned_concat()["y"],
                                  data["y"])
    # one process without a process group owns every shard
    assert len(xs.owned()) == 4
    # the default shard count: the process and device counts, at least 1
    assert shards.XShards.partition(data).num_partitions() >= 1
    for i in range(3):
        pd.DataFrame({"a": np.arange(i * 5, i * 5 + 5),
                      "b": np.arange(5) * 0.5}).to_csv(
            tmp_path / f"part-{i}.csv", index=False)
        np.save(tmp_path / f"arr-{i}.npy", np.arange(4) + 10 * i)
        pd.DataFrame({"c": [i, i + 1]}).to_parquet(
            tmp_path / f"p-{i}.parquet")
    pat = str(tmp_path / "part-*.csv")
    pd.testing.assert_frame_equal(
        shards.read_csv(pat, num_shards=2).concat(),
        jshards.read_csv(pat, num_shards=2).concat())
    np.testing.assert_array_equal(
        shards.read_npy(str(tmp_path / "arr-*.npy")).concat(),
        jshards.read_npy(str(tmp_path / "arr-*.npy")).concat())
    pd.testing.assert_frame_equal(
        shards.read_parquet(str(tmp_path / "p-*.parquet")).concat(),
        jshards.read_parquet(str(tmp_path / "p-*.parquet")).concat())
    mine = shards.read_csv(pat, process_id=1, process_count=2)
    theirs = jshards.read_csv(pat, process_id=1, process_count=2)
    assert mine.owned()[0].equals(theirs.owned()[0])
    with pytest.raises(ValueError, match="owns no files"):
        shards.read_csv(pat, process_id=4, process_count=5)


def test_dataset_helpers_equal_jax():
    rs = np.random.RandomState(14)
    for kw in (dict(trained_batches=2, old_process_count=2, process_id=1,
                    process_count=3, seed=4, epoch=2),
               dict(trained_batches=0, old_process_count=1,
                    drop_last=False, seed=1)):
        got = list(dataset.resharded_batch_index_plan(100, 12, **kw))
        want = list(jdataset.resharded_batch_index_plan(100, 12, **kw))
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    samples = [dataset.Sample(rs.rand(3), i % 2) for i in range(7)]
    jsamples = [jdataset.Sample(s.feature, s.label) for s in samples]
    _same_batches(dataset.SampleToMiniBatch(3)(iter(samples)),
                  jdataset.SampleToMiniBatch(3)(iter(jsamples)))
    ads = dataset.DataSet.from_samples(samples)
    jads = jdataset.DataSet.from_samples(jsamples)
    kw = dict(trained_batches=1, old_process_count=1, seed=2)
    _same_batches(ads.resharded_batches(2, **kw),
                  jads.resharded_batches(2, **kw))
    x = np.arange(40, dtype=np.float32).reshape(40, 1)
    y = np.arange(40, dtype=np.int32)
    local = dataset.ProcessLocalDataSet(dataset.ArrayDataSet(x, y))
    jlocal = jdataset.ProcessLocalDataSet(jdataset.ArrayDataSet(x, y))
    kw = dict(shuffle=False, process_id=0, process_count=2)
    _same_batches(local.batches(8, **kw), jlocal.batches(8, **kw))
    assert local.size() == 40
    with pytest.raises(ValueError, match="not divisible"):
        list(local.batches(7, process_count=2))


def test_storage_local_and_memory(tmp_path):
    for root in (str(tmp_path), "file://" + str(tmp_path),
                 "memory://port-storage"):
        d = storage.join(root, "a", "b")
        storage.makedirs(d)
        storage.write_json(storage.join(d, "m.json"), {"k": [1, 2]})
        with storage.open_file(storage.join(d, "n.npz"), "wb") as f:
            np.savez(f, w=np.arange(3))
        assert storage.read_json(storage.join(d, "m.json")) == {"k": [1, 2]}
        np.testing.assert_array_equal(
            storage.load_npz(storage.join(d, "n.npz"))["w"], np.arange(3))
        assert storage.list_files(d) == ["m.json", "n.npz"]
        assert sorted(storage.listdir(d)) == ["m.json", "n.npz"]
        assert storage.isfile(storage.join(d, "m.json"))
        assert storage.exists(d) and storage.basename(d) == "b"
        assert len(storage.glob(storage.join(d, "*.json"))) == 1
        assert storage.fingerprint(storage.join(d, "m.json")) is not None
        assert storage.fingerprint(storage.join(d, "missing")) is None
        storage.remove_tree(storage.join(root, "a"))
        assert not storage.exists(storage.join(d, "m.json"))
    assert storage.is_remote("gs://b/x") and not storage.is_remote(
        "file:///x")
    with pytest.raises(FileNotFoundError):
        storage.remove_tree(str(tmp_path / "none"), ignore_errors=False)


# ---------------------------------------------------------------------------
# the histogram, metrics and summaries
# ---------------------------------------------------------------------------

def test_log_histogram_equals_jax():
    clock = [1000.0]
    h = LogHistogram(clock=lambda: clock[0])
    jh = JLogHistogram(clock=lambda: clock[0])
    rng = np.random.default_rng(15)
    for v in list(rng.exponential(0.01, 300)) + [0.0, -1.0, float("inf")]:
        clock[0] += 0.37
        h.observe(v)
        jh.observe(v)
    assert h.snapshot() == jh.snapshot()
    for q in (50, 95, 99):
        assert h.percentile(q) == jh.percentile(q)
        assert h.window_percentile(q) == jh.window_percentile(q)
    assert h.window_count() == jh.window_count()
    assert h.window_fraction_over(0.01) == jh.window_fraction_over(0.01)
    assert np.isnan(LogHistogram().percentile(50))
    m = Metrics()
    for v in (0.001, 0.002, 0.5):
        m.observe("train.data_wait_s", v)
    m.inc("data.read_batches", 3)
    m.gauge("data.queue_depth.ring", 2)
    s = m.summary()
    assert s["train.data_wait_s.count"] == 3 and s["data.read_batches"] == 3
    assert m.snapshot()["hists"]["train.data_wait_s"]["n"] == 3


def test_event_files_cross_packages_with_their_crcs(tmp_path):
    w = tbwriter.TensorBoardWriter(str(tmp_path / "port"))
    jw = jtb.TensorBoardWriter(str(tmp_path / "jax"))
    long_tag = "metrics/" + "x" * 200
    for writer in (w, jw):
        writer.add_scalar("loss", 1.5, 1)
        writer.add_scalar(long_tag, 0.75, 2)
        writer.add_histogram("Parameters/0_Linear/weight",
                             np.linspace(-1, 1, 50), 2)
        writer.close()
    want = [(1, "loss", 1.5), (2, long_tag, 0.75)]
    for path in (w.path, jw.path):
        assert [r for r in jtb.read_scalars(path) if r[2] is not None] == want
        assert [r for r in tbwriter.read_scalars(path)
                if r[2] is not None] == want
    for path in (w.path, jw.path):
        data = open(path, "rb").read()
        pos, n = 0, 0
        while pos < len(data):
            header = data[pos:pos + 8]
            (length,) = struct.unpack("<Q", header)
            assert struct.unpack_from("<I", data, pos + 8)[0] == \
                jtb._masked_crc(header) == tbwriter._masked_crc(header)
            payload = data[pos + 12:pos + 12 + length]
            assert struct.unpack_from("<I", data, pos + 12 + length)[0] \
                == tbwriter._masked_crc(payload)
            pos += 12 + length + 4
            n += 1
        assert n == 4  # file_version + two scalars + one histogram


def test_summary_writers_cross_packages(tmp_path):
    for make, jmake, name in ((TrainSummary, None, "train"),
                              (ValidationSummary, None, "validation")):
        with make(str(tmp_path), "app") as s:
            s.add_scalar("Loss", 0.5, 3)
            s.add_scalar("Loss", 0.25, 4)
        assert s.path.endswith(os.path.join("app", f"{name}.jsonl"))
        j = JSummaryWriter(os.path.dirname(s.path), name, tensorboard=False)
        assert j.read_scalar("Loss") == [(3, 0.5), (4, 0.25)]
        j.close()
    with JSummaryWriter(str(tmp_path / "j"), "train") as j:
        j.add_scalar("throughput", 12.0, 1)
    mine = SummaryWriter(str(tmp_path / "j"), "train", tensorboard=False)
    assert mine.read_scalar("throughput") == [(1, 12.0)]
    mine.close()
