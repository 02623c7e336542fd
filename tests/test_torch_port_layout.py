"""The port's declarative layouts without ranks
(``bigdl_tpu_torch.parallel.layout`` and ``mesh_policy``), against
``bigdl_tpu.parallel`` on the same inputs: the ``parallelism=`` grammar
and its error texts (``tests/test_layout.py``'s cases), the canonical
specs, every table's spec of every path of the JAX package's 12-layer
LM, seq2seq and two-tower parameter trees (shapes from
``jax.eval_shape``: the two-tower model is not ported, ROADMAP A.6.3),
the audit and its gauge, the byte ledgers, and the specs' DTensor
placements (a mesh stand-in with dim names and sizes).  Everything is
exact: specs, texts and byte counts are equal.  Last, one process
alone: the group of one that a layout opens (closed by the test), the
step with and without remat equal to the bit."""

import logging
import types

import numpy as np
import pytest

from bigdl_tpu_torch.parallel import layout as L
from bigdl_tpu_torch.parallel import mesh_policy as MP
from bigdl_tpu_torch.runtime import engine as engine_mod

VOCAB, T = 32, 8


def _jax_models():
    from bigdl_tpu.models.recsys import TwoTower
    from bigdl_tpu.nn.attention import Transformer

    return {
        "lm12": (Transformer(VOCAB, hidden_size=16, num_heads=2,
                             ffn_size=32, num_layers=12, dropout=0.0,
                             mode="lm"),
                 (np.zeros((1, T), np.int32),)),
        "seq2seq": (Transformer(VOCAB, hidden_size=16, num_heads=2,
                                ffn_size=32, num_layers=2, dropout=0.0,
                                mode="translation"),
                    (np.zeros((1, T), np.int32),
                     np.zeros((1, T), np.int32))),
        "two_tower": (TwoTower(n_users=32, n_items=64, dim=8,
                               hidden=(16,)),
                      (np.zeros((2,), np.int32), np.zeros((2, 3), np.int32),
                       np.zeros((2,), np.int32))),
    }


@pytest.fixture(scope="module")
def jax_trees():
    """name -> (JAX model, its params' shapes)."""
    import jax

    out = {}
    for name, (m, args) in _jax_models().items():
        shapes = jax.eval_shape(lambda r, a, m=m: m.init(r, *a),
                                jax.random.PRNGKey(0), args)["params"]
        out[name] = (m, shapes)
    return out


def _raises_same(fn_port, fn_jax):
    """Both raise ValueError with the same text."""
    with pytest.raises(ValueError) as a:
        fn_port()
    with pytest.raises(ValueError) as b:
        fn_jax()
    assert str(a.value) == str(b.value)
    return str(a.value)


# ---------------------------------------------------------------------------
# parallelism= policy strings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "dp", "fsdp:2,tp:4", "mp:2,sp:2", "tp:2,dp", "dp:2,fsdp:2,tp:2",
    "FSDP:2, TP:2", "data:4", "model:2,seq", "fsdp"])
def test_parse_and_resolve_equal_jax(spec):
    from bigdl_tpu.parallel import mesh_policy as jmp

    assert MP.parse_parallelism(spec) == jmp.parse_parallelism(spec)
    for n in (8, 16):
        assert MP.resolve_parallelism(spec, n) == \
            jmp.resolve_parallelism(spec, n)


@pytest.mark.parametrize("spec,n,match", [
    ("dp:4,zz:2", 8, "unknown axis 'zz'.*fsdp"),
    ("dp:8,tp:2", 8, "needs 16 devices but only 8"),
    ("dp:2,data:4", 8, "given twice"), ("dp,tp", 8, "omit its factor"),
    ("dp:0", 8, "must be >= 1"), ("tp:two", 8, "not an integer"),
    ("", 8, "non-empty"), ("tp:3,dp", 8, "not divisible"),
    ("dp:2,", 8, "stray comma")])
def test_policy_errors_are_jax_texts(spec, n, match):
    from bigdl_tpu.parallel import mesh_policy as jmp

    text = _raises_same(lambda: MP.resolve_parallelism(spec, n),
                        lambda: jmp.resolve_parallelism(spec, n))
    assert __import__("re").search(match, text)


def test_under_subscription_warns_idle_devices():
    records = []
    lg = logging.getLogger("bigdl_tpu_torch.parallel.mesh_policy")
    h = logging.Handler()
    h.emit = records.append
    lg.addHandler(h)
    try:
        sizes = MP.resolve_parallelism("dp:2,tp:2", 8)
    finally:
        lg.removeHandler(h)
    assert sizes["data"] == 2
    assert any("stay idle" in r.getMessage() for r in records)


def test_resolved_layout_properties():
    def rl(par, n):
        return MP.ResolvedLayout(par, None, L.SpecLayout(),
                                 MP.resolve_parallelism(par, n))

    r = rl("fsdp:2,tp:2", 4)
    assert r.n_batch_shards == 2 and r.model_sharded
    assert r.describe() == "'fsdp:2,tp:2' -> {'fsdp': 2, 'tp': 2}"
    d = rl("dp", 1)
    assert not d.model_sharded and d.describe() == "'dp' -> {'data': 1}"


def test_engine_config_parallelism_env(monkeypatch):
    from bigdl_tpu.runtime.engine import EngineConfig as JEngineConfig

    monkeypatch.setenv("BIGDL_TPU_PARALLELISM", "FSDP:2,TP:4")
    assert engine_mod.EngineConfig.from_env().parallelism == \
        JEngineConfig.from_env().parallelism == "fsdp:2,tp:4"
    monkeypatch.delenv("BIGDL_TPU_PARALLELISM")
    assert engine_mod.EngineConfig.from_env().parallelism is None
    assert engine_mod.EngineConfig().parallelism is None


# ---------------------------------------------------------------------------
# specs, tables, audit
# ---------------------------------------------------------------------------

def test_partition_spec_prints_and_compares_as_jax():
    from jax.sharding import PartitionSpec as JP

    for dims in ((("fsdp", "tp"), None), ("fsdp", "tp"), (), ("tp",),
                 (None, None, "fsdp", "tp")):
        assert repr(L.P(*dims)) == repr(JP(*dims))
        assert tuple(L.P(*dims)) == tuple(JP(*dims))


def test_spec_layout_methods_equal_jax():
    from bigdl_tpu.parallel import layout as jl

    for kw in ({}, dict(fsdp=None, tp="model", seq=None),
               dict(data=None), dict(tp=None, seq=None)):
        a, b = L.SpecLayout(**kw), jl.SpecLayout(**kw)
        for m in ("vocab_embedding", "hidden_in", "hidden_out",
                  "tower_kernel", "tower_bias", "col_bias", "row_bias",
                  "norm", "replicated"):
            assert tuple(getattr(a, m)()) == tuple(getattr(b, m)()), m
        for nd in (1, 2, 3):
            assert tuple(a.batch_spec(nd)) == tuple(b.batch_spec(nd))
            assert tuple(a.activation_spec(nd)) == \
                tuple(b.activation_spec(nd))
        assert a.batch_axes() == b.batch_axes()
    assert tuple(L.LEGACY_SPEC_LAYOUT.hidden_in()) == (None, "model")


@pytest.mark.parametrize("name", ["lm12", "seq2seq", "two_tower"])
@pytest.mark.parametrize("sl", [dict(), dict(fsdp=None, tp="model",
                                             seq=None)])
def test_every_path_of_every_table_equals_jax(jax_trees, name, sl):
    import jax
    from bigdl_tpu.parallel import layout as jl

    jm, shapes = jax_trees[name]
    jtable = jl.layout_for_model(jm, jl.SpecLayout(**sl))
    # the port's table of the same family, picked by the class name
    ptable = L.layout_for_model(type(type(jm).__name__, (), {})(),
                                L.SpecLayout(**sl))
    assert ptable.name == jtable.name
    jspecs = jtable.param_specs(shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, type(jl.P())))[0]
    pspecs = ptable.param_specs(shapes)
    assert len(flat) > 0
    for path, jspec in flat:
        key = jl.path_str(path)
        node = pspecs
        for k in key.split("/"):
            node = node[k]
        leaf = shapes
        for k in key.split("/"):
            leaf = leaf[k]
        assert tuple(node) == tuple(jspec), key
        assert ptable.spec_for(key, len(leaf.shape))[1] == \
            jtable.spec_for(key, len(leaf.shape))[1]
    ja, pa = jtable.audit(shapes), ptable.audit(shapes)
    assert pa.sharded == ja.sharded
    assert pa.allowlisted == ja.allowlisted
    assert pa.fallback_replicated == ja.fallback_replicated == []
    assert pa.fallback_elems == ja.fallback_elems


def test_new_param_fails_the_audit_and_sets_the_gauge(jax_trees):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel import layout as jl
    from bigdl_tpu_torch.optim.metrics import global_metrics

    jm, shapes = jax_trees["lm12"]
    shapes = dict(shapes)
    shapes["brand_new_giant_table"] = jax.ShapeDtypeStruct((4096, 64),
                                                           jnp.float32)
    records = []
    lg = logging.getLogger("bigdl_tpu_torch.parallel.layout")
    h = logging.Handler()
    h.emit = records.append
    lg.addHandler(h)
    try:
        audit = L.transformer_layout(L.SpecLayout()).audit(shapes).export()
    finally:
        lg.removeHandler(h)
    want = jl.layout_for_model(jm, jl.SpecLayout()).audit(shapes)
    assert audit.fallback_replicated == want.fallback_replicated == \
        ["brand_new_giant_table"]
    assert audit.fallback_elems == want.fallback_elems == 4096 * 64
    gm = global_metrics()
    assert gm.gauges["parallel.layout.replicated_params"] == 1.0
    assert any("layout_replicated_params" in r.getMessage()
               and "brand_new_giant_table" in r.getMessage()
               for r in records)
    del shapes["brand_new_giant_table"]
    L.transformer_layout(L.SpecLayout()).audit(shapes).export()
    assert gm.gauges["parallel.layout.replicated_params"] == 0.0


def test_generic_rules_and_register_layout():
    table = L.generic_layout(L.SpecLayout())
    assert table.spec_for("head/weight", 2) == (L.P("fsdp", "tp"),
                                                "linear_kernel")
    assert table.spec_for("conv1/weight", 4) == (
        L.P(None, None, "fsdp", "tp"), "conv_kernel_cout")

    class Exotic:
        pass

    try:
        L.register_layout("Exotic", lambda sl: L.ModelLayout(
            sl, rules=(L.LayoutRule("giant", r"(^|/)giant$",
                                    lambda l: l.vocab_embedding()),),
            replicate=L.GENERIC_REPLICATE, name="exotic"))
        t = L.layout_for_model(Exotic(), L.SpecLayout())
        assert t.name == "exotic"
        assert t.spec_for("giant", 2) == (L.P(("fsdp", "tp"), None),
                                          "giant")
    finally:
        L._MODEL_TABLES.pop("Exotic", None)


def test_port_module_paths_hit_the_jax_rules(jax_trees):
    """The port's LM names its parameters as the JAX tree (``path_str``
    of a dotted name is its JAX path): the same specs, path for path."""
    import jax
    from bigdl_tpu.parallel import layout as jl
    from bigdl_tpu_torch.nn.attention import Transformer

    pm = Transformer(VOCAB, 16, 2, 32, num_layers=12, dropout=0.0,
                     mode="lm")
    jm, shapes = jax_trees["lm12"]
    jspecs = jl.layout_for_model(jm, jl.SpecLayout()).param_specs(shapes)
    ptable = L.layout_for_model(pm, L.SpecLayout())
    jflat = {jl.path_str(p): tuple(s) for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(x, type(jl.P())))[0]}
    got = {L.path_str(n): tuple(ptable.spec_for(L.path_str(n), p.ndim)[0])
           for n, p in pm.named_parameters()}
    assert got == jflat


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def _mesh(**sizes):
    names = tuple(sizes)
    return types.SimpleNamespace(mesh_dim_names=names,
                                 shape=tuple(sizes[n] for n in names))


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = _mesh(fsdp=2, tp=2)
    assert L.spec_to_placements(L.P(("fsdp", "tp"), None), m, (32, 16)) \
        == [Shard(0), Shard(0)]
    assert L.spec_to_placements(L.P("tp", "fsdp"), m) == [Shard(1),
                                                          Shard(0)]
    assert L.spec_to_placements(L.P("fsdp"), m) == [Shard(0), Replicate()]
    assert L.spec_to_placements(L.P(), m) == [Replicate(), Replicate()]
    # an axis the live mesh lacks (size 1) splits nothing
    assert L.spec_to_placements(L.P("seq", ("data", "tp")),
                                _mesh(tp=2)) == [Shard(1)]
    # DTensor splits in mesh order: another order is refused, and so is
    # a doubly split dim whose shards would not be JAX's bounds
    with pytest.raises(ValueError, match="mesh order"):
        L.spec_to_placements(L.P(None, ("tp", "fsdp")), m)
    with pytest.raises(ValueError, match="does not divide"):
        L.spec_to_placements(L.P(("fsdp", "tp"), None), m, (30, 16))
    # a singly split dim may be uneven: torch.chunk's bounds are JAX's
    # padded split's (ceil(n / k) a shard)
    assert L.spec_to_placements(L.P("tp"), m, (5,)) == [Replicate(),
                                                        Shard(0)]
    for n in range(1, 12):
        for k in (2, 3, 4):
            import torch

            sizes = [c.numel() for c in torch.arange(n).chunk(k)]
            sizes += [0] * (k - len(sizes))
            c = -(-n // k)
            want = [max(0, min(c, n - i * c)) for i in range(k)]
            assert sizes == want, (n, k)


# ---------------------------------------------------------------------------
# the byte ledgers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("par", ["dp", "fsdp:2,tp:2", "dp:2,tp:2",
                                 "fsdp:4,tp:2", "dp:2,fsdp:2,tp:2"])
def test_ledgers_equal_jax_to_the_byte(jax_trees, par):
    import jax
    from bigdl_tpu.parallel import gspmd as jg
    from bigdl_tpu.parallel import layout as jl
    from bigdl_tpu.parallel.mesh_policy import mesh_and_layout
    from bigdl_tpu_torch.parallel import gspmd as pg

    r = mesh_and_layout(par, devices=jax.devices()[:8])
    sizes = dict(r.mesh.shape)
    for name in ("lm12", "seq2seq", "two_tower"):
        jm, shapes = jax_trees[name]
        jspecs = jl.layout_for_model(jm, jl.SpecLayout()).param_specs(shapes)
        pspecs = L.layout_for_model(type(type(jm).__name__, (), {})(),
                                    L.SpecLayout()).param_specs(shapes)
        assert L.collective_bytes_by_axis(shapes, pspecs, sizes) == \
            jl.collective_bytes_by_axis(shapes, jspecs, r.mesh)
        assert pg.collective_bytes_for_specs(shapes, pspecs, sizes) == \
            jg.collective_bytes_for_specs(shapes, jspecs, r.mesh)
    for args in ((2, 4, 8, 1, 2), (8, 128, 768, 24, 4), (2, 4, 8, 4, 1)):
        assert L.tp_activation_bytes(*args) == jl.tp_activation_bytes(*args)
    for sizes_ in ({"fsdp": 2, "tp": 4}, {}, {"tp": 1}):
        assert L.embedding_lookup_bytes(16, 8, sizes_, 3) == \
            jl.embedding_lookup_bytes(16, 8, sizes_, 3)


def test_legacy_tp_spec_for_path_equals_jax():
    from bigdl_tpu.parallel import gspmd as jg
    from bigdl_tpu_torch.parallel import gspmd as pg

    for path, shape in (("attn/wq", (4, 8)), ("gate/w2", (5,)),
                        ("embedding", (16, 8)), ("dec0/ln1/weight", (8,)),
                        ("ffn/l2/weight", (8, 4)), ("head/weight", (4, 2))):
        leaf = np.zeros(shape)
        assert tuple(pg.tp_spec_for_path(path, leaf)) == \
            tuple(jg.tp_spec_for_path(path, leaf))


# ---------------------------------------------------------------------------
# one process alone: a group of one, opened by the layout and closed here
# ---------------------------------------------------------------------------

def test_one_process_opens_a_group_of_one_and_trains():
    """Without a process group ``mesh_and_layout`` opens one of this
    process alone (gloo on an in-process store); the step with remat
    gives the losses and weights of the step without, to the bit."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.nn.attention import Transformer
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.parallel.gspmd import GSPMDTrainStep

    assert not dist.is_initialized()
    rs = np.random.RandomState(0)
    x = rs.randint(0, VOCAB, (4, T)).astype(np.int32)
    y = rs.randint(0, VOCAB, (4, T)).astype(np.int64)
    try:
        r = MP.mesh_and_layout("dp", "cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert r.sizes == {"data": 1, "fsdp": 1, "tp": 1, "seq": 1}
        runs = []
        for remat in (False, True):
            m = Transformer(VOCAB, 16, 2, 32, num_layers=2, dropout=0.0)
            step = GSPMDTrainStep(m, CrossEntropyCriterion(),
                                  SGD(learning_rate=0.1), layout=r,
                                  remat=remat)
            losses = [float(step.train_step(i, None, x, y))
                      for i in range(2)]
            runs.append((losses, step.get_params()))
        assert runs[0][0] == runs[1][0]
        for a, b in zip(L._leaves(runs[0][1]), L._leaves(runs[1][1])):
            np.testing.assert_array_equal(a[1], b[1])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
