"""The port's streaming pipeline, its device feed on the CPU and the
driver's input side, against the JAX package's specs
(``tests/test_pipeline_stream.py``, ``tests/test_records.py``) and the
JAX driver.

The pipeline specs: batches byte-identical to the serial path for any
worker count, a crash in fetch or decode raised at the consumer (never a
hang), an abandoned consumer stopping the stage threads, a ring that
never lends a slot in flight, and the feed's CPU detach surviving heavy
slot reuse.  The driver: a small classifier trained from a
``RecordDataSet`` and ``resnet_cifar(depth=8)`` from an
``AugmentedRecordImages``, streaming on, through the port's and the JAX
Optimizer (one data replica, ``init_engine(data=1)``) from the same
variables: the classifier's losses within 1e-5, the ResNet's first
within 1e-5 and the rest within 1e-4 (as
``test_torch_port_resnet_train.py``); ``train.data_wait_s`` recorded; summaries
the JAX reader reads; a resume in the middle of an epoch continuing the
same batches and closing the pipeline it abandons."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data.records import RecordDataSet as JRecordDataSet
from bigdl_tpu.data.vision import AugmentedRecordImages as JAugmented
from bigdl_tpu.models.resnet import resnet_cifar as jresnet_cifar
from bigdl_tpu.native import lib as jlib
from bigdl_tpu.optim.metrics import SummaryWriter as JSummaryWriter
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu.utils.tbwriter import read_scalars as jread_scalars
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data.pipeline import (BufferRing, PipelineError,
                                          RingBatch, StreamingPipeline,
                                          autotune_depths, autotune_workers,
                                          bundle_batches, dispatch_to_device)
from bigdl_tpu_torch.data.prefetch import prefetch_to_device, thread_prefetch
from bigdl_tpu_torch.data.records import RecordDataSet, write_records
from bigdl_tpu_torch.data.vision import (AugmentedRecordImages,
                                         stream_jpeg_batches)
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.optim.metrics import Metrics

CPU = "cpu"
RS = np.random.RandomState(7)


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native library built by this process into a
    directory of its own, as in ``test_torch_port_data.py``: its loader
    builds into one shared cache through one shared temporary name, and
    test workers that build there at once may leave its no-libjpeg
    variant."""
    saved = jlib._CACHE_DIR, jlib._lib, jlib._tried
    jlib._CACHE_DIR = str(tmp_path_factory.mktemp("jax_native"))
    jlib._lib, jlib._tried = None, False
    try:
        yield jlib
    finally:
        jlib._CACHE_DIR, jlib._lib, jlib._tried = saved


@pytest.fixture
def rec(tmp_path):
    x = RS.rand(100, 4, 4, 3).astype(np.float32)
    y = RS.randint(0, 5, 100).astype(np.int32)
    p = str(tmp_path / "train.btrec")
    write_records(p, {"x": x, "y": y})
    return p, x, y


def _snap(mb):
    # ring batches are views over reusable slots: copy before the next pull
    return {k: np.array(v) for k, v in mb.items()}


def _stage_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("bigdl-tpu-torch-") and t.is_alive()]


def _wait_no_stage_threads(timeout=10.0):
    deadline = time.time() + timeout
    while _stage_threads() and time.time() < deadline:
        time.sleep(0.05)
    return _stage_threads()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 3])
def test_stream_matches_serial_any_worker_count(rec, workers):
    p, _, _ = rec
    ds = RecordDataSet(p)
    ref = [_snap(mb) for mb in ds.batches(16, shuffle=True, seed=3,
                                          epoch=1, drop_last=False)]
    got = [_snap(mb) for mb in ds.stream_batches(
        16, shuffle=True, seed=3, epoch=1, drop_last=False,
        workers=workers)]
    assert len(got) == len(ref) == 7
    for a, b in zip(ref, got):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    ds.close()


def test_decode_crash_propagates_not_hangs():
    def bad_decode(item, raw, bufs, lo, hi, slot):
        if item >= 2:
            raise RuntimeError("decoder exploded")
        bufs["x"][lo:hi] = item
        return {"n": 4}

    pl = StreamingPipeline(iter(range(8)), lambda i, s: i, bad_decode,
                           {"x": ((4, 2), np.float32)}, rows=4, workers=2)
    t0 = time.time()
    with pytest.raises(PipelineError) as ei:
        for _ in pl:
            pass
    assert time.time() - t0 < 30
    assert "exploded" in str(ei.value.__cause__)


def test_fetch_crash_propagates():
    def fetch(item, slot):
        raise OSError("disk fell off")

    pl = StreamingPipeline(iter(range(3)), fetch, lambda *a: None,
                           {"x": ((2,), np.float32)}, rows=2, workers=1)
    with pytest.raises(PipelineError) as ei:
        next(iter(pl))
    assert isinstance(ei.value.__cause__, OSError)


def test_empty_and_dry_plans_terminate_not_hang(rec):
    p, _, _ = rec
    ds = RecordDataSet(p)
    t0 = time.time()
    assert list(ds.stream_batches(128, shuffle=False, workers=2)) == []
    ds.close()

    def slow_plan():
        yield 0
        time.sleep(0.3)  # the consumer parks in pop(seq=1) first

    def decode(item, raw, bufs, lo, hi, slot):
        bufs["x"][lo:hi] = item
        return {"n": 2}

    pl = StreamingPipeline(slow_plan(), lambda i, s: i, decode,
                           {"x": ((2,), np.float32)}, rows=2, workers=1)
    assert len(list(pl)) == 1
    assert time.time() - t0 < 30


def test_abandoned_consumer_stops_stage_threads(rec):
    p, _, _ = rec
    ds = RecordDataSet(p)
    it = iter(ds.stream_batches(16, workers=2))
    next(it)
    assert _stage_threads()
    it.close()  # the driver's generator-close path
    assert _wait_no_stage_threads() == []
    ds.close()


def test_ring_never_lends_slot_in_flight():
    ring = BufferRing({"x": ((2,), np.float32)}, depth=2)
    stop = threading.Event()
    s0 = ring.assign(0, 1, stop)
    s1 = ring.assign(1, 1, stop)
    assert {s0, s1} == {0, 1}
    got = []
    t = threading.Thread(target=lambda: got.append(
        ring.assign(2, 1, stop, timeout=0.01)))
    stop2 = threading.Event()
    ring.part_done(s0, {"n": 2})
    slot, bufs, meta = ring.pop(0, stop2, lambda: None)
    assert slot == s0 and meta["n"] == 2
    ring.part_done(s1)
    t.start()
    ring.pop(1, stop2, lambda: None)
    ring.release(s1)
    t.join(5)
    assert not t.is_alive() and got == [s1]  # never the LENT s0
    with pytest.raises(PipelineError):
        ring.release(s1)  # not lent anymore
    ring.release(s0)
    with pytest.raises(PipelineError):
        ring.release(s0)  # double release
    with pytest.raises(PipelineError):
        ring.part_done(s0)  # not assigned
    with pytest.raises(ValueError, match=">= 2"):
        BufferRing({"x": ((2,), np.float32)}, depth=1)


def test_ring_reuse_no_allocation_and_no_corruption(rec):
    p, x, _ = rec
    ds = RecordDataSet(p)
    seen, total = set(), 0
    for e in range(3):
        got = []
        for mb in ds.stream_batches(20, shuffle=False, epoch=e, workers=2):
            seen.add(id(mb["input"].base) if mb["input"].base is not None
                     else id(mb["input"]))
            got.append(np.array(mb["input"]))
            total += 1
            time.sleep(0.002)  # let producers run ahead into the ring
        np.testing.assert_array_equal(np.concatenate(got), x)
    assert total == 15 and len(seen) <= 8
    ds.close()


def test_ring_batch_release_idempotent_and_deferred():
    calls = []
    rb = RingBatch(lambda: calls.append(1), input=np.zeros(2))
    rb.release()
    rb.release()
    assert calls == [1]
    rb2 = RingBatch(lambda: calls.append(2), input=np.zeros(2))
    rel = rb2.defer_release()
    rb2.release()  # the pipeline's auto-release: now a no-op
    assert calls == [1]
    rel()
    assert calls == [1, 2]


# ---------------------------------------------------------------------------
# the device feed on the CPU, prefetch, bundles
# ---------------------------------------------------------------------------

def test_dispatch_to_device_survives_slot_reuse(rec):
    """The feed's tensors keep their batch's data after the ring slot
    they came from has been refilled many times (a released slot refilled
    under a live tensor would corrupt training silently): a depth-2 ring
    and many batches force heavy reuse."""
    p, _, _ = rec
    ds = RecordDataSet(p)
    m = Metrics()
    for epoch in range(3):
        stream = ds.stream_batches(10, shuffle=True, seed=7, epoch=epoch,
                                   workers=2, ring_depth=2, raw_depth=1)
        devs = list(dispatch_to_device(
            stream, lambda mb: (mb["input"], mb["target"]), size=2,
            metrics=m, device=CPU))
        ref = list(ds.batches(10, shuffle=True, seed=7, epoch=epoch))
        assert len(devs) == len(ref) == 10
        for (xd, yd), mb in zip(devs, ref):
            assert isinstance(xd, torch.Tensor) and xd.dtype == torch.float32
            np.testing.assert_array_equal(xd.numpy(), mb["input"])
            np.testing.assert_array_equal(yd.numpy(), mb["target"])
    s = m.summary()
    assert s["data.dispatch_overlapped_total"] == 27  # 9 an epoch
    assert s["data.dispatch.in_flight"] == 0
    ds.close()


def test_dispatch_to_device_plain_batches_and_refusals():
    batches = [{"input": np.full((2, 3), i, np.float64),
                "target": (np.arange(2), np.ones(2, np.int32))}
               for i in range(5)]
    out = list(dispatch_to_device(iter(batches), lambda mb: mb, size=3,
                                  inflight=1, device=CPU))
    assert [float(b["input"][0, 0]) for b in out] == [0, 1, 2, 3, 4]
    assert out[0]["input"].dtype == torch.float32  # as JAX without x64
    assert out[0]["target"][1].dtype == torch.int32
    batches[0]["input"][:] = 9  # a copy, never a view of the host array
    assert float(out[0]["input"][0, 0]) == 0
    with pytest.raises(ValueError, match="inflight"):
        dispatch_to_device(iter(batches), lambda mb: mb, inflight=0,
                           device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dispatch_to_device(iter(batches), lambda mb: mb)


class _ClosableIter:
    def __init__(self, n):
        self._it = iter(range(n))
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self):
        self.closed = True


def test_prefetch_and_bundles_close_upstream_on_abandonment():
    src = _ClosableIter(100)
    it = prefetch_to_device(src, lambda b: b, size=3)
    assert next(it) == 0
    it.close()
    assert src.closed
    src2 = _ClosableIter(3)
    assert list(prefetch_to_device(src2, lambda b: b, size=2)) == [0, 1, 2]
    assert not src2.closed
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter([1]), lambda b: b, size=0))
    src3 = _ClosableIter(7)
    spans = iter([2, 3, 1, 5, 5])
    assert list(bundle_batches(src3, lambda: next(spans))) == [
        [0, 1], [2, 3, 4], [5], [6]]
    assert src3.closed


def test_thread_prefetch_overlap_errors_and_abandonment():
    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield i

    t0 = time.time()
    out = []
    for b in thread_prefetch(slow(), depth=2):
        time.sleep(0.05)  # consumer work overlaps producer work
        out.append(b)
    assert out == [0, 1, 2, 3] and time.time() - t0 < 0.35

    def bad():
        yield 1
        raise RuntimeError("producer boom")

    it = thread_prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)
    with pytest.raises(ValueError):
        list(thread_prefetch(iter([1]), depth=0))
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    it = thread_prefetch(endless(), depth=1)
    assert next(it) == 0
    it.close()
    assert _wait_no_stage_threads() == [] and closed


def test_stage_metrics_and_autotune(rec):
    p, _, _ = rec
    ds = RecordDataSet(p)
    m = Metrics()
    stream = ds.stream_batches(20, shuffle=False, metrics=m, workers=2)
    for _ in stream:
        pass
    s = m.summary()
    assert s["data.read_batches"] == 5
    assert s["data.decoded_images"] == 100
    assert "data.queue_depth.ring" in s and "data.rate.shard_img_per_s" in s
    rates = stream.stage_rates()
    assert rates["read_batches"] == 5 and rates["decode_batches"] == 5
    ds.close()
    assert autotune_depths(100.0, 5.0, 4)["raw_depth"] == 1
    slow_read = autotune_depths(5.0, 100.0, 4)
    assert slow_read == {"raw_depth": 4, "ring_depth": 4}
    assert autotune_depths(5.0, 100.0, 4, parts_per_batch=1)[
        "ring_depth"] == 7
    assert autotune_workers(host_cores=2) == 2
    assert autotune_workers(host_cores=16) == 14
    assert autotune_workers(decode_rate=10.0, target_rate=35.0,
                            host_cores=16) == 4


def test_shared_memory_decode_pool_matches_native():
    import io

    from PIL import Image

    rs = np.random.RandomState(1)
    xs = rs.randint(0, 255, (24, 40, 40, 3), np.uint8)
    enc = []
    for i in range(24):
        buf = io.BytesIO()
        Image.fromarray(xs[i]).save(buf, "JPEG", quality=90)
        enc.append(buf.getvalue())
    mean, std = (0.5 * 255,) * 3, (0.25 * 255,) * 3
    kw = dict(labels=np.arange(24), resize_hw=(32, 32), random_crop=True,
              random_flip=True, seed=1, workers=2)
    a = [_snap(mb) for mb in stream_jpeg_batches(
        enc, 8, (24, 24), mean, std, use_processes=False, **kw)]
    b = [_snap(mb) for mb in stream_jpeg_batches(
        enc, 8, (24, 24), mean, std, use_processes=True, **kw)]
    assert len(a) == len(b) == 3
    for x1, x2 in zip(a, b):
        np.testing.assert_array_equal(x1["target"], x2["target"])
        np.testing.assert_allclose(x1["input"], x2["input"], atol=1e-5)


# ---------------------------------------------------------------------------
# the driver, against the JAX Optimizer
# ---------------------------------------------------------------------------

def _jax_losses(model, ds, criterion, method, batch, n_iter, init, summary,
                seed=3):
    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(model, ds, criterion, batch_size=batch,
                               seed=seed)
        opt.set_optim_method(method)
        opt.set_end_when(joptim.Trigger.max_iteration(n_iter))
        opt.set_initial_variables(init)
        opt.set_train_summary(summary)
        assert opt.streaming and opt.host_prefetch == 2
        opt.optimize()
        return [v for _, v in opt._train_summary.read_scalar("loss")]
    finally:
        Engine.reset()


def _jax_init(model, sample):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  model.init(jax.random.PRNGKey(0), sample))


@pytest.fixture
def clf_rec(tmp_path):
    rs = np.random.RandomState(0)
    x = rs.rand(200, 6).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.int32)
    p = str(tmp_path / "clf.btrec")
    write_records(p, {"x": x, "y": y})
    return p, x


def test_classifier_from_records_matches_jax_with_summaries(clf_rec,
                                                            tmp_path):
    p, x = clf_rec
    jm = jnn.Sequential([jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 2)])
    init = _jax_init(jm, x[:1])
    want = _jax_losses(jm, JRecordDataSet(p), jnn.CrossEntropyCriterion(),
                       joptim.Adam(learning_rate=0.02), 40, 12, init,
                       str(tmp_path / "jsum"))
    model = nn.Sequential([nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 2)])
    ds = RecordDataSet(p)
    opt = optim.Optimizer(model, ds, nn.CrossEntropyCriterion(),
                          batch_size=40, seed=3, device=CPU)
    assert (opt.streaming, opt.host_prefetch, opt.prefetch) == (True, 2, 2)
    summary = str(tmp_path / "sum")
    opt.set_optim_method(optim.Adam(learning_rate=0.02))
    opt.set_end_when(optim.Trigger.max_iteration(12))
    opt.set_initial_variables(init)
    opt.set_train_summary(summary).set_val_summary(summary)
    opt.set_validation(optim.Trigger.every_epoch(), ds,
                       [optim.Top1Accuracy()], batch_size=50)
    opt.set_summary_trigger("Parameters", optim.Trigger.every_epoch())
    opt.optimize()
    assert len(want) == len(opt.losses) == 12
    np.testing.assert_allclose(opt.losses, want, rtol=0, atol=1e-5)
    snap = opt.metrics.snapshot()
    assert snap["hists"]["train.data_wait_s"]["n"] >= 12
    assert snap["counters"]["data.read_batches"] == 15  # 3 epochs of 5
    assert snap["counters"]["data.dispatch_overlapped_total"] > 0
    # the JAX package reads the port's summaries: a loss, an lr and a
    # throughput a step, a validation an epoch, histograms an epoch
    with JSummaryWriter(summary, "train", tensorboard=False) as j:
        assert [s for s, _ in j.read_scalar("loss")] == list(range(1, 13))
        np.testing.assert_allclose([v for _, v in j.read_scalar("loss")],
                                   opt.losses, rtol=1e-6)
        assert len(j.read_scalar("throughput")) == 12
        assert all(v > 0 for _, v in j.read_scalar("throughput"))
        np.testing.assert_allclose([v for _, v in j.read_scalar("lr")],
                                   [0.02] * 12)
    with JSummaryWriter(summary, "validation", tensorboard=False) as j:
        assert [s for s, _ in j.read_scalar("Top1Accuracy")] == [5, 10]
    (events,) = [os.path.join(summary, "train", f)
                 for f in os.listdir(os.path.join(summary, "train"))]
    recs = jread_scalars(events)
    assert sum(1 for _, tag, _ in recs if tag == "loss") == 12
    hist_tags = {tag for _, tag, v in recs if v is None}
    assert hist_tags == {"Parameters/0_Linear/weight",
                         "Parameters/0_Linear/bias",
                         "Parameters/2_Linear/weight",
                         "Parameters/2_Linear/bias"}
    ds.close()


def test_resnet_cifar_from_augmented_records_matches_jax(tmp_path):
    rs = np.random.RandomState(2)
    xs = rs.randint(0, 255, (32, 32, 32, 3), np.uint8)
    ys = rs.randint(0, 10, 32).astype(np.int32)
    p = str(tmp_path / "cifar.btrec")
    write_records(p, {"image": xs, "label": ys})
    mean, std = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)
    kw = dict(resize_hw=(36, 36), random_crop=True, random_flip=True)
    jm = jresnet_cifar(depth=8, classes=10)
    init = _jax_init(jm, np.zeros((1, 32, 32, 3), np.float32))

    def sgd(m):
        return m.SGD(learning_rate=0.05)

    want = _jax_losses(jm, JAugmented(p, (32, 32), mean, std, **kw),
                       jnn.CrossEntropyCriterion(), sgd(joptim), 8, 4, init,
                       str(tmp_path / "jsum"), seed=1)
    ds = AugmentedRecordImages(p, (32, 32), mean, std, **kw)
    opt = optim.Optimizer(resnet_cifar(depth=8, classes=10), ds,
                          nn.CrossEntropyCriterion(), batch_size=8, seed=1,
                          device=CPU)
    opt.set_optim_method(sgd(optim))
    opt.set_end_when(optim.Trigger.max_iteration(4))
    opt.set_initial_variables(init)
    opt.optimize()
    assert len(want) == len(opt.losses) == 4
    # as test_torch_port_resnet_train.py: the first step within 1e-5, the
    # later ones within 1e-4 (float32 sums in another order, carried
    # through the BatchNorm statistics)
    np.testing.assert_allclose(opt.losses[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(opt.losses[1:], want[1:], rtol=0, atol=1e-4)
    assert opt.metrics.snapshot()["hists"]["train.data_wait_s"]["n"] == 4
    assert _wait_no_stage_threads() == []
    ds.close()


def test_serial_feed_equals_streaming_and_resume_mid_epoch(clf_rec,
                                                           tmp_path):
    """``streaming=False, host_prefetch=0`` (the serial feed) trains the
    same losses as the streaming default; a run stopped mid-epoch by its
    checkpoint trigger resumes in a fresh Optimizer with the epoch's next
    batch, and every pipeline an abandoned epoch leaves is closed."""
    p, _ = clf_rec
    ds = RecordDataSet(p)

    def run(end, ckpt=None, **attrs):
        model = nn.Sequential([
            nn.Linear(6, 16, generator=torch.Generator().manual_seed(0)),
            nn.ReLU(),
            nn.Linear(16, 2, generator=torch.Generator().manual_seed(1))])
        opt = optim.Optimizer(model, ds, nn.CrossEntropyCriterion(),
                              batch_size=40, seed=3, device=CPU)
        opt.set_optim_method(optim.Adam(learning_rate=0.02))
        opt.set_end_when(optim.Trigger.max_iteration(end))
        for k, v in attrs.items():
            setattr(opt, k, v)
        if ckpt:
            opt.set_checkpoint(ckpt, optim.Trigger.several_iteration(3))
        opt.optimize()
        assert _wait_no_stage_threads() == []
        return opt

    full = run(8).losses
    assert run(8, streaming=False, host_prefetch=0).losses == full
    assert run(8, host_prefetch=0).losses == full
    d = str(tmp_path / "ck")
    first = run(3, ckpt=d)       # stops at iteration 3 of epoch 1's 5
    assert first.losses == full[:3]
    second = run(8, ckpt=d)      # skips 3, trains 2, then 3 of epoch 2
    assert second.final_state["epoch"] == 2
    np.testing.assert_allclose(second.losses, full[3:], rtol=0, atol=1e-6)
    ds.close()
