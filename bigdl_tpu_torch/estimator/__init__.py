"""Estimator — the port of ``bigdl_tpu.estimator``, the Orca-style
scaling API: ``init_context``, ``Estimator.from_module`` /
``from_torch`` / ``from_keras``, ``fit``, ``evaluate``, ``predict`` and
the state-dict export, on the port's ``Optimizer``."""

from bigdl_tpu_torch.estimator.estimator import (Estimator, init_context,
                                                 stop_context)

# the reference's spellings: orca.common.init_orca_context /
# stop_orca_context and the dllib entry init_nncontext
init_orca_context = init_context
stop_orca_context = stop_context
init_nncontext = init_context

__all__ = ["Estimator", "init_context", "stop_context",
           "init_orca_context", "stop_orca_context", "init_nncontext"]
