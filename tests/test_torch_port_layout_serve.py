"""Serving on a layout over gloo ranks on the CPU: ``InferenceModel(
layout=, decode=)`` with float32 and int8 weights and with speculation,
layered int8 ``predict`` on a layout, and (at world 2) the translation
engine's ``Seq2SeqAdapter(layout=)``, against the JAX package on a
CPU mesh of as many devices (``tests/test_layout.py``'s
``TestServingModelSharded``).

Ranks come from ``test_torch_port_collectives.RankPool`` at world 2
(``"tp:2"``, this file) and 4 (``"fsdp:2,tp:2"``,
``tests/test_torch_port_layout_serve4.py``, which runs these specs on
its own pool); every rank builds the same model
from the JAX init (``utils.convert``) and serves the same prompts, and
every rank job is queued at once so the JAX references run while the
ranks work.  The JAX engines queue each wave under their iteration lock
and wait for each draft prefill (ROADMAP C.9), so both packages run one
schedule.

Tolerances:
- greedy tokens equal, summed log-probs within 1e-5 (the row-split
  products of tp and fsdp sum in another order than the JAX mesh's);
- int8 weights: the same, and each rank's local shard of every int8
  payload and scale has JAX device r's shard shape;
- layered int8 ``predict``: 1e-5 of JAX's, scaled by the output's
  largest magnitude (``tests/test_torch_port_int8.py``), and each
  rank's local ``weight_q`` / ``scales`` / ``bias`` has JAX device r's
  shard shape.

The rank workers import this module, which therefore imports JAX only
inside the JAX-side helpers."""

import numpy as np
import pytest

from test_torch_port_collectives import pools  # noqa: F401 (fixture)
from test_torch_port_layout_train import Jobs

VOCAB = 32
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=4, eos_id=1, prefill_batch=2)
SPEC = dict(k=3, sparsity=0.5)
MODES = ("f32", "int8", "spec")
PARS = {"tp:2": 2}
LOGP_TOL = 1e-5
PRED_TOL = 1e-5


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(2, VOCAB, (n,)).astype(np.int32)
            for n in (3, 5, 9, 7)]


def _np(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_lm():
    import jax
    from bigdl_tpu.nn.attention import Transformer as JT

    model = JT(vocab_size=VOCAB, hidden_size=16, num_heads=2, num_layers=2,
               dropout=0.0, mode="lm")
    v = model.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    return model, _np(v["params"])


def _mlp(m):
    return m.Sequential([m.Linear(16, 32), m.ReLU(), m.Linear(32, 8)])


def _mlp_data():
    import jax
    from bigdl_tpu import nn as jnn

    x = np.random.RandomState(1).randn(5, 16).astype(np.float32)
    jm = _mlp(jnn)
    return jm, _np(jm.init(jax.random.PRNGKey(0), x[:2])), x


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _serve_worker(rank, world, params, par, prompts):
    from bigdl_tpu_torch.nn.attention import Transformer
    from bigdl_tpu_torch.serving import (DecodeConfig, InferenceModel,
                                         SpecConfig)
    from bigdl_tpu_torch.utils import load_jax_params
    from bigdl_tpu_torch.utils.convert import jax_path

    out = {}
    for mode in MODES:
        spec = SpecConfig(**SPEC) if mode == "spec" else None
        im = InferenceModel(
            load_jax_params(Transformer(VOCAB, 16, 2, num_layers=2,
                                        dropout=0.0), params),
            decode=DecodeConfig(**GEOMETRY, speculative=spec),
            device="cpu", layout=par,
            weight_quant="int8" if mode == "int8" else None)
        try:
            res = im.generate(prompts, seeds=[100 + i for i in
                                              range(len(prompts))],
                              return_results=True)
        finally:
            im.stop()
        out[mode] = [(r.tokens.tolist(), float(r.logp), r.finish_reason)
                     for r in res]
        if mode == "int8":
            w8 = im.decode_engine.adapter._w8
            out["int8_shapes"] = {
                "/".join(jax_path(n)): (tuple(w.to_local().shape),
                                        tuple(s.to_local().shape))
                for n, (_, w, s) in w8._q.items()}
        if mode == "spec":
            out["spec_stats"] = dict(im.decode_engine.stats)
    return out


S2S = dict(vocab=16, bos=0, buckets=(4, 8))


def _s2s_sources():
    rs = np.random.RandomState(1)
    return [rs.randint(2, S2S["vocab"], (n,)).astype(np.int32)
            for n in (3, 7, 2, 5)]


def _s2s_worker(rank, world, params, par):
    from bigdl_tpu_torch.nn.attention import Transformer
    from bigdl_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                         DecodeRequest, Seq2SeqAdapter)
    from bigdl_tpu_torch.utils import load_jax_params

    model = load_jax_params(Transformer(S2S["vocab"], 16, 2, num_layers=2,
                                        dropout=0.0, mode="translation"),
                            params)
    cfg = DecodeConfig(**GEOMETRY)
    eng = DecodeEngine(Seq2SeqAdapter(model, cap=cfg.cap, bos_id=S2S["bos"],
                                      src_buckets=S2S["buckets"],
                                      layout=par), cfg)
    try:
        reqs = eng.submit_many([DecodeRequest(tokens=p, seed=100 + i)
                                for i, p in enumerate(_s2s_sources())])
        res = [r.wait(timeout=120) for r in reqs]
    finally:
        eng.stop()
    return [(r.tokens.tolist(), float(r.logp), r.finish_reason)
            for r in res]


def _layered_worker(rank, world, variables, x, par):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.quantized import QuantizedLinear
    from bigdl_tpu_torch.serving import InferenceModel
    from bigdl_tpu_torch.utils import load_jax_variables

    im = InferenceModel(load_jax_variables(_mlp(nn), variables),
                        device="cpu", layout=par, weight_quant="int8",
                        batch_buckets=(4, 8))
    shapes = {}
    for name, mod in im.model.named_children():
        if isinstance(mod, QuantizedLinear):
            shapes[name] = {k: tuple(getattr(mod, k).to_local().shape)
                            for k in ("weight_q", "scales", "bias")}
    return dict(pred=im.predict(x), pred3=im.predict(x[:3]), shapes=shapes)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_serve(model, params, par, mode, prompts):
    import jax
    from bigdl_tpu.serving import decode_engine as jde

    cfg = jde.DecodeConfig(**GEOMETRY, speculative=(
        jde.SpecConfig(**SPEC) if mode == "spec" else None))
    eng = jde.DecodeEngine(jde.LMAdapter(
        model, params, cap=cfg.cap, layout=par,
        weight_quant="int8" if mode == "int8" else None), cfg)
    if mode == "spec":
        fn0 = eng._draft_prefill_fn

        def blocking(nb):
            fn = fn0(nb)
            return lambda *a: jax.block_until_ready(fn(*a))

        eng._draft_prefill_fn = blocking
    try:
        reqs = [jde.DecodeRequest(tokens=p, seed=100 + i)
                for i, p in enumerate(prompts)]
        with eng._iter_lock:
            for r in reqs:
                eng.submit(r)
        res = [r.wait(timeout=120) for r in reqs]
        shapes = None
        if mode == "int8":
            shapes = {}

            def walk(tree, path):
                if "__w8__" in tree:
                    shapes["/".join(path)] = tree
                    return
                for k, v in tree.items():
                    if isinstance(v, dict):
                        walk(v, path + (k,))

            walk(eng.adapter._params_stored, ())
        return [(r.tokens.tolist(), float(r.logp), r.finish_reason)
                for r in res], shapes
    finally:
        eng.stop()


def _shard_shape(arr, r):
    import jax

    dev = jax.devices()[r]
    got = [s.data.shape for s in arr.addressable_shards if s.device == dev]
    assert len(got) == 1
    return tuple(got[0])


def _jax_s2s():
    import jax
    from bigdl_tpu.nn.attention import Transformer as JT

    model = JT(vocab_size=S2S["vocab"], hidden_size=16, num_heads=2,
               num_layers=2, dropout=0.0, mode="translation")
    src = np.array([[2, 5, 6, 3], [2, 3, 4, 5]], np.int32)
    return model, _np(model.init(jax.random.PRNGKey(0), src, src)["params"])


def _jax_s2s_serve(model, params, par):
    from bigdl_tpu.serving import decode_engine as jde

    cfg = jde.DecodeConfig(**GEOMETRY)
    eng = jde.DecodeEngine(jde.Seq2SeqAdapter(
        model, params, cap=cfg.cap, bos_id=S2S["bos"],
        src_buckets=S2S["buckets"], layout=par), cfg)
    try:
        with eng._iter_lock:
            reqs = [eng.submit(jde.DecodeRequest(tokens=p, seed=100 + i))
                    for i, p in enumerate(_s2s_sources())]
        return [(r.tokens.tolist(), float(r.logp), r.finish_reason)
                for r in (q.wait(timeout=120) for q in reqs)]
    finally:
        eng.stop()


def serve_all(pools, pars, s2s=False):
    """Queue every rank job of ``pars`` ({policy: world}), then run the
    JAX references while the ranks work (``s2s``: the translation
    engine's too)."""
    model, params = _jax_lm()
    jm, mv, x = _mlp_data()
    prompts = _prompts()
    queues = {}
    for par, n in pars.items():
        q = queues[par] = Jobs(pools(n))
        q.submit("serve", _serve_worker, params, par, prompts)
        q.submit("layered", _layered_worker, mv, x, par)
    if s2s:
        s2s_model, s2s_params = _jax_s2s()
        for par in pars:
            queues[par].submit("s2s", _s2s_worker, s2s_params, par)
    want = {}
    for par in pars:
        for mode in MODES:
            want[par, mode] = _jax_serve(model, params, par, mode, prompts)
        if s2s:
            want[par, "s2s"] = _jax_s2s_serve(s2s_model, s2s_params, par)
    return queues, want, (jm, mv, x)


def check_decode(served, par, mode):
    queues, want, _ = served
    jres, jshapes = want[par, mode]
    got = queues[par].get("serve")
    for r, g in enumerate(got):
        assert len(g[mode]) == len(jres)
        for (tok, logp, fin), (jtok, jlogp, jfin) in zip(g[mode], jres):
            assert tok == jtok and fin == jfin
            assert abs(logp - jlogp) <= LOGP_TOL, (logp, jlogp)
        if mode == "int8":
            assert set(g["int8_shapes"]) == set(jshapes)
            for path, (w, s) in g["int8_shapes"].items():
                assert w == _shard_shape(jshapes[path]["__w8__"], r), path
                assert s == _shard_shape(jshapes[path]["scale"], r), path
        if mode == "spec":
            assert g["spec_stats"]["spec_drafted"] > 0
    # every rank served the same tokens
    assert all(g[mode] == got[0][mode] for g in got)


def check_layered(served, par):
    from bigdl_tpu.serving.inference_model import InferenceModel as JIM

    queues, _, (jm, mv, x) = served
    jim = JIM(jm, mv, layout=par, weight_quant="int8", batch_buckets=(4, 8))
    want, want3 = jim.predict(x), jim.predict(x[:3])
    for r, g in enumerate(queues[par].get("layered")):
        for a, b in ((g["pred"], want), (g["pred3"], want3)):
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=0, atol=PRED_TOL * scale)
        assert set(g["shapes"]) == {"0_Linear", "2_Linear"}
        for k, shapes in g["shapes"].items():
            for name, shape in shapes.items():
                assert shape == _shard_shape(jim._params[k][name], r), \
                    (k, name)


@pytest.fixture(scope="module")
def served(pools):
    return serve_all(pools, PARS, s2s=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("par", list(PARS))
def test_layout_decode_matches_jax(served, par, mode):
    check_decode(served, par, mode)


@pytest.mark.parametrize("par", list(PARS))
def test_layered_int8_predict_on_a_layout_matches_jax(served, par):
    check_layered(served, par)


@pytest.mark.parametrize("par", list(PARS))
def test_seq2seq_adapter_on_a_layout_matches_jax(served, par):
    """``Seq2SeqAdapter(layout=)``: the translation engine over the
    placed model (the encoder's cross K/V gathered to every rank)
    against the JAX adapter on the same layout: greedy tokens equal,
    log-probs within 1e-5."""
    queues, want, _ = served
    jres = want[par, "s2s"]
    for got in queues[par].get("s2s"):
        assert len(got) == len(jres)
        for (tok, logp, fin), (jtok, jlogp, jfin) in zip(got, jres):
            assert tok == jtok and fin == jfin
            assert abs(logp - jlogp) <= LOGP_TOL, (logp, jlogp)
