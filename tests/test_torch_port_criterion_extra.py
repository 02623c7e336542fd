"""The port's extended criterion catalog (``nn.criterion_extra``) against
the JAX package's, on the same numpy inputs: each criterion's value and
its gradient with respect to every input tensor.

Tolerance: 1e-6 relative (and 1e-7 absolute), as
``test_torch_port_optim.py`` holds ``criterion.py``: float32 in both,
sums in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn

RTOL, ATOL = 1e-6, 1e-7


def _pm1(rs, *shape):
    return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _probs(rs, rows, n):
    return rs.dirichlet(np.ones(n), rows).astype(np.float32)


def _f32(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _labels(rs, *shape, n=5):
    return rs.randint(0, n, shape).astype(np.int32)


# name -> (criterion from (nn module, size_average),
#          inputs from a RandomState: (input, target); a tuple input is a
#          table, a target of None is not passed)
CASES = {
    "MultiCriterion": (
        lambda m, sa: m.MultiCriterion(
            [m.MSECriterion(sa), m.AbsCriterion(sa)], [0.5, 2.0]).add(
                m.SmoothL1Criterion(sa), 1.5),
        lambda rs: (_f32(rs, 6, 5), _f32(rs, 6, 5, scale=1.5))),
    "MultiLabelSoftMarginCriterion": (
        lambda m, sa: m.MultiLabelSoftMarginCriterion(sa),
        lambda rs: (_f32(rs, 6, 5, scale=2.0),
                    (rs.rand(6, 5) > 0.5).astype(np.float32))),
    "MultiMarginCriterion": (
        lambda m, sa: m.MultiMarginCriterion(1, 1.0, sa),
        lambda rs: (_f32(rs, 6, 5), _labels(rs, 6))),
    "MultiMarginCriterion_p2": (
        lambda m, sa: m.MultiMarginCriterion(2, 0.7, sa),
        lambda rs: (_f32(rs, 6, 5), _labels(rs, 6))),
    "HingeEmbeddingCriterion": (
        lambda m, sa: m.HingeEmbeddingCriterion(1.5, sa),
        lambda rs: (np.abs(_f32(rs, 6, 5, scale=1.5)), _pm1(rs, 6, 5))),
    "L1HingeEmbeddingCriterion": (
        lambda m, sa: m.L1HingeEmbeddingCriterion(5.0),
        lambda rs: ((_f32(rs, 6, 5), _f32(rs, 6, 5)), _pm1(rs, 6))),
    "MarginCriterion": (
        lambda m, sa: m.MarginCriterion(1.0, sa),
        lambda rs: (_f32(rs, 6, 5), _pm1(rs, 6, 5))),
    "MarginCriterion_squared": (
        lambda m, sa: m.MarginCriterion(0.8, sa, squared=True),
        lambda rs: (_f32(rs, 6, 5), _pm1(rs, 6, 5))),
    "SoftMarginCriterion": (
        lambda m, sa: m.SoftMarginCriterion(sa),
        lambda rs: (_f32(rs, 6, 5, scale=2.0), _pm1(rs, 6, 5))),
    "DiceCoefficientCriterion": (
        lambda m, sa: m.DiceCoefficientCriterion(0.5),
        lambda rs: (rs.rand(4, 3, 6).astype(np.float32),
                    (rs.rand(4, 3, 6) > 0.6).astype(np.float32))),
    "PoissonCriterion": (
        lambda m, sa: m.PoissonCriterion(sa),
        lambda rs: ((rs.rand(6, 5) * 3 + 0.1).astype(np.float32),
                    rs.poisson(1.5, (6, 5)).astype(np.float32))),
    "DistKLDivCriterion": (
        lambda m, sa: m.DistKLDivCriterion(sa),
        lambda rs: (np.log(_probs(rs, 6, 5)), _probs(rs, 6, 5))),
    "KullbackLeiblerDivergenceCriterion": (
        lambda m, sa: m.KullbackLeiblerDivergenceCriterion(),
        lambda rs: (_probs(rs, 6, 5), _probs(rs, 6, 5))),
    "MeanAbsolutePercentageCriterion": (
        lambda m, sa: m.MeanAbsolutePercentageCriterion(),
        lambda rs: (_f32(rs, 6, 5), _f32(rs, 6, 5, scale=2.0))),
    "MeanSquaredLogarithmicCriterion": (
        lambda m, sa: m.MeanSquaredLogarithmicCriterion(),
        lambda rs: (_f32(rs, 6, 5) + 1.0, np.abs(_f32(rs, 6, 5)))),
    "CategoricalCrossEntropy": (
        lambda m, sa: m.CategoricalCrossEntropy(),
        lambda rs: (_probs(rs, 6, 5), _labels(rs, 6))),
    "CategoricalCrossEntropy_soft": (
        lambda m, sa: m.CategoricalCrossEntropy(),
        lambda rs: (_probs(rs, 6, 5), _probs(rs, 6, 5))),
    "CosineDistanceCriterion": (
        lambda m, sa: m.CosineDistanceCriterion(sa),
        lambda rs: (_f32(rs, 6, 5), _f32(rs, 6, 5))),
    "CosineProximityCriterion": (
        lambda m, sa: m.CosineProximityCriterion(),
        lambda rs: (_f32(rs, 6, 5), _f32(rs, 6, 5))),
    "RankHingeCriterion": (
        lambda m, sa: m.RankHingeCriterion(0.8),
        lambda rs: ((_f32(rs, 8), _f32(rs, 8)), None)),
    "GaussianCriterion": (
        lambda m, sa: m.GaussianCriterion(),
        lambda rs: ((_f32(rs, 6, 5), _f32(rs, 6, 5, scale=0.5)),
                    _f32(rs, 6, 5))),
    "KLDCriterion": (
        lambda m, sa: m.KLDCriterion(),
        lambda rs: ((_f32(rs, 6, 5), _f32(rs, 6, 5, scale=0.5)), None)),
    "L1Cost": (
        lambda m, sa: m.L1Cost(),
        lambda rs: (_f32(rs, 6, 5), None)),
    "TransformerCriterion": (
        lambda m, sa: m.TransformerCriterion(
            m.MSECriterion(sa), input_transform=(lambda v: v * v - v),
            target_transform=(lambda t: 0.5 * t)),
        lambda rs: (_f32(rs, 6, 5), _f32(rs, 6, 5))),
    "TimeDistributedMaskCriterion": (
        lambda m, sa: m.TimeDistributedMaskCriterion(
            m.ClassNLLCriterion(), padding_value=0),
        lambda rs: (np.log(_probs(rs, 12, 5)).reshape(3, 4, 5),
                    np.array([[1, 2, 0, 0], [3, 4, 1, 0], [2, 0, 0, 0]],
                             np.int32))),
    "PGCriterion": (
        lambda m, sa: m.PGCriterion(sa),
        lambda rs: (_probs(rs, 6, 5),
                    np.eye(5, dtype=np.float32)[_labels(rs, 6)]
                    * _f32(rs, 6, 1, scale=2.0))),
}

# the cases whose criterion takes size_average
SIZE_AVERAGE = {
    "MultiCriterion", "MultiLabelSoftMarginCriterion",
    "MultiMarginCriterion", "MultiMarginCriterion_p2",
    "HingeEmbeddingCriterion", "MarginCriterion", "MarginCriterion_squared",
    "SoftMarginCriterion", "PoissonCriterion", "DistKLDivCriterion",
    "CosineDistanceCriterion", "TransformerCriterion", "PGCriterion"}

PARAMS = [(name, sa) for name in sorted(CASES)
          for sa in ((True, False) if name in SIZE_AVERAGE else (True,))]


def _tree(a, fn):
    return tuple(fn(v) for v in a) if isinstance(a, tuple) else fn(a)


def test_every_class_of_the_jax_catalog_is_ported():
    from bigdl_tpu.nn import criterion_extra as jextra
    from bigdl_tpu_torch.nn import criterion_extra as textra

    names = {n for n, v in vars(jextra).items()
             if isinstance(v, type) and issubclass(v, jnn.Criterion)
             and v.__module__ == jextra.__name__}
    assert len(names) == 22      # and DistKLDivCriterion, an alias
    covered = {n.split("_")[0] for n in CASES}
    assert names | {"DistKLDivCriterion"} == covered
    for n in covered:
        assert hasattr(textra, n) and hasattr(tnn, n), n


@pytest.mark.parametrize("name,size_average", PARAMS)
def test_value_and_gradient_match_jax(name, size_average):
    make, inputs = CASES[name]
    x, t = inputs(np.random.RandomState(11))
    jc = make(jnn, size_average)
    tc = make(tnn, size_average)
    jt = None if t is None else jnp.asarray(t)
    want, jg = jax.value_and_grad(lambda v: jc(v, jt))(
        _tree(x, jnp.asarray))
    tx = _tree(x, lambda v: torch.from_numpy(v.copy()).requires_grad_())
    got = tc(tx, None if t is None else torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(tx if isinstance(tx, tuple) else (tx,),
                    jg if isinstance(jg, tuple) else (jg,)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)
