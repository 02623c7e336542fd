"""The port's ``ServingPool`` (``bigdl_tpu_torch.serving.pool``): worker
subprocesses (``python -m bigdl_tpu_torch.serving.pool --worker``) on
the CPU (``BIGDL_TPU_POOL_CPU``) behind the proxy.

The specs of tests/test_serving_chaos.py's and
tests/test_serving_continuous.py's pool tests and of
tests/test_fleet_chaos.py's failover run, trimmed to one pool of two
multi-tenant workers (a tiny LM as the default tenant, a linear model,
a slow callable): predictions under an injected ``serving_worker_kill``
answer correctly or shed explicitly while the supervisor respawns; the
breaker opens, probes half-open and closes; a request to the slow
tenant fires one bounded hedge; the federated ``/metrics`` carries both
workers' series; and streams on a worker killed mid-flight fail over to
the other, their greedy and seeded tokens equal to the no-fault run of
the same model in this process.  A worker whose loader defaults to the
card, with the card hidden, exits and the supervisor reports it.

Worker processes import the port and this module, never JAX."""

import http.client
import json
import os
import threading
import time
from urllib import request as urlreq
from urllib.error import HTTPError

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.obs import flight
from bigdl_tpu_torch.obs.export import parse_exposition
from bigdl_tpu_torch.serving import (DecodeConfig, DecodeRequest,
                                     InferenceModel, ServingPool)
from bigdl_tpu_torch.serving.pool import _Breaker, _Worker

LM_GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                   max_new_tokens=16, eos_id=1, prefill_batch=2,
                   prefix_cache_pages=8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slow_double(x):
    time.sleep(0.6)
    return np.asarray(x) * 2.0


def _lm_model():
    torch.manual_seed(0)
    return Transformer(32, 16, 2, num_layers=2, dropout=0.0, seed=0)


def _linear_model():
    torch.manual_seed(1)
    return nn.Sequential([nn.Linear(8, 4)])


def _loader():
    """Worker-side factory (``tests.test_torch_port_pool:_loader``): the
    LM under a decode throttle so a kill lands mid-stream, the linear
    model and the slow callable, all on the CPU."""
    im = InferenceModel(_lm_model(), device="cpu",
                        decode=DecodeConfig(**LM_GEOMETRY)).warmup()
    eng = im.decode_engine
    step = eng._decode_step

    def slow_step():
        time.sleep(0.05)
        return step()

    eng._decode_step = slow_step
    return {"default": im,
            "linear": InferenceModel(_linear_model(), device="cpu",
                                     batch_buckets=(2, 4, 8)),
            "slow": InferenceModel(predict_fn=_slow_double)}


def _card_loader():
    """A loader that asks for no device: the card, hidden from a CPU
    worker."""
    return InferenceModel(_linear_model())


def _env(extra=None):
    path = os.pathsep.join(p for p in [ROOT, os.environ.get("PYTHONPATH")]
                           if p)
    return dict({"PYTHONPATH": path, "BIGDL_TPU_POOL_CPU": "1"},
                **(extra or {}))


def _post(url, payload, timeout=30.0):
    req = urlreq.Request(url, data=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
    with urlreq.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def pool():
    p = ServingPool("tests.test_torch_port_pool:_loader", workers=2,
                    batch_size=8,
                    worker_env=_env({"BIGDL_TPU_FAULTS":
                                     "serving_worker_kill:every=5:max=1"}),
                    supervise_interval_s=0.3, breaker_cooldown_s=0.2,
                    breaker_threshold=2, predict_timeout=30.0,
                    hedge_after_s=0.15, fleet_health_max_age_s=0.0)
    p.start()
    # only the first two processes carry the plan: respawns come up clean
    for w in p.worker_list():
        w.env = _env()
    try:
        yield p
    finally:
        p.stop()


def test_cuda_default_loader_never_lands_on_the_cpu():
    w = _Worker("tests.test_torch_port_pool:_card_loader", batch_size=8,
                queue_capacity=16, env=_env())
    with pytest.raises(RuntimeError, match="exited with code"):
        w.spawn(timeout=60)
    assert not w.alive()


def test_predict_under_worker_kill_hedge_and_breaker(pool):
    """Every accepted predict answers the in-process model's rows or is
    shed explicitly (429/503) while the supervisor respawns the two
    workers that ``serving_worker_kill`` ended (each at its fifth batch);
    the slow tenant's request fires a hedge; a worker's breaker opens,
    probes half-open and closes."""
    ref = InferenceModel(_linear_model(), device="cpu",
                         batch_buckets=(2, 4, 8))
    rs = np.random.RandomState(0)
    answered = sheds = 0
    t_end = time.time() + 40
    while (pool.restarts < 2 or answered < 12) and time.time() < t_end:
        x = rs.rand(2, 8).astype(np.float32)
        try:
            out = _post(pool.url + "/predict",
                        {"instances": x.tolist(), "model": "linear"})
        except HTTPError as e:
            assert e.code in (429, 503), e.code
            sheds += 1
            time.sleep(0.2)
            continue
        np.testing.assert_allclose(out["predictions"], ref.predict(x),
                                   rtol=1e-5, atol=1e-6)
        answered += 1
    assert pool.restarts >= 2 and answered >= 12
    _all_serving(pool)
    with urlreq.urlopen(pool.url + "/health", timeout=10) as r:
        h = json.loads(r.read())
    assert h["restarts"] >= 2
    for w, ww in zip(h["workers"], pool.worker_list()):
        assert w["url"] == ww.url and w["alive"]
        assert w["breaker"]["state"] in ("closed", "open", "half-open")
        assert ww.spawn_s > 0   # the respawn's seconds to WORKER_URL
    # the hedge: the slow tenant outlasts hedge_after_s
    hedged = pool.stats["hedged_requests"]
    out = _post(pool.url + "/predict",
                {"instances": [[1.0, 2.0]], "model": "slow"})
    assert out["predictions"] == [[2.0, 4.0]]
    assert pool.stats["hedged_requests"] == hedged + 1
    # the breaker (the pool's kind, off the live routing that feeds the
    # workers' own): open after two failures, one half-open probe, closed
    br = _Breaker(fail_threshold=2, cooldown_s=0.2, name="probe")
    for _ in range(2):
        br.record_failure()
    assert br.state == "open" and not br.try_acquire()
    time.sleep(0.25)
    assert br.try_acquire() and br.state == "half-open"
    assert not br.try_acquire()
    br.record_success()
    assert br.state == "closed" and br.trips >= 1


def _all_serving(pool, wait_s=40.0):
    deadline = time.time() + wait_s
    while time.time() < deadline and not all(
            w.routable() for w in pool.worker_list()):
        time.sleep(0.2)
    assert all(w.routable() for w in pool.worker_list())


def test_federated_scrape_has_both_workers(pool):
    _all_serving(pool)
    for _ in range(4):     # a respawned worker has no series until served
        _post(pool.url + "/predict",
              {"instances": [[0.5] * 8], "model": "linear"})
    with urlreq.urlopen(pool.url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    fams = {f["name"]: f for f in parse_exposition(text)}
    labels = [lab for f in fams.values() for _, lab, _ in f["samples"]]
    for w in pool.worker_list():
        assert any(f'worker="{w.name}"' in lab for lab in labels), w.name
    assert "serving_requests" in fams
    assert "serving_fleet_failovers" in fams


def _no_fault_tokens(prompts):
    """The no-fault run: the workers' LM in this process, one request at
    a time through a static generate."""
    im = InferenceModel(_lm_model(), device="cpu",
                        decode=DecodeConfig(**LM_GEOMETRY))
    try:
        return [[int(t) for t in im.decode_engine.static_generate(
            [DecodeRequest(tokens=np.asarray(p, np.int32),
                           max_new_tokens=10, **kw)])[0].tokens]
            for p, kw in prompts]
    finally:
        im.stop()


def _stream(pool, rid, prompt, kw, mid, results, errors):
    conn = http.client.HTTPConnection(pool.host, pool.port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps(dict(
            tokens=[int(t) for t in prompt], stream=True,
            max_new_tokens=10, **kw)).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": rid, "Connection": "close"})
        resp = conn.getresponse()
        toks, final = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            ev = json.loads(line)
            if ev.get("done"):
                final = ev
                break
            toks.append(int(ev["token"]))
            if len(toks) == 2:
                mid.set()
        if final is None or "error" in final:
            errors.append((rid, final))
        else:
            results[rid] = ([int(t) for t in final["tokens"]], toks)
    except Exception as e:  # noqa: BLE001 — a failed stream is the bug
        errors.append((rid, repr(e)))
    finally:
        mid.set()
        conn.close()


def test_streams_fail_over_a_killed_worker(pool):
    """Six streams (greedy and seeded); the worker holding live streams
    is killed after each stream's second token; every stream finishes
    with the no-fault tokens, streamed and final, and the proxy counts
    the failovers."""
    rs = np.random.RandomState(17)
    prompts = []
    for i in range(6):
        kw = (dict(temperature=0.0) if i % 2 == 0 else
              dict(temperature=0.8, top_k=8, top_p=0.9,
                   seed=int(rs.randint(0, 2 ** 31 - 1))))
        prompts.append((rs.randint(2, 32, 4).astype(np.int32), kw))
    ref = _no_fault_tokens(prompts)
    _all_serving(pool)
    results, errors = {}, []
    mids = [threading.Event() for _ in prompts]
    threads = [threading.Thread(target=_stream, args=(
        pool, f"chaos-{i}", p, kw, mids[i], results, errors))
        for i, (p, kw) in enumerate(prompts)]
    for t in threads:
        t.start()
    for m in mids:
        assert m.wait(60)
    with urlreq.urlopen(pool.url + "/health", timeout=10) as r:
        h = json.loads(r.read())
    victim = next(w["name"] for w in h["workers"]
                  if w.get("decode", {}).get("generate_inflight", 0) >= 1)
    next(w for w in pool.worker_list() if w.name == victim).proc.kill()
    for t in threads:
        t.join(120)
    assert not errors, errors
    for i in range(len(prompts)):
        final, streamed = results[f"chaos-{i}"]
        assert final == streamed == ref[i], i
    assert pool.stats["fleet_failovers"] >= 1
    assert pool.stats["fleet_resumed_tokens"] >= 1
    assert pool.stats["fleet_orphans"] == 0
    assert any(e["kind"] == "fleet_failover"
               for e in flight.global_recorder().snapshot())
