"""Training — the port of ``bigdl_tpu.optim``'s single-device training loop."""

from bigdl_tpu_torch.optim.optim_method import SGD, Adam, OptimMethod
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.optim.train_step import GradientClipping, TrainStep
from bigdl_tpu_torch.optim.trigger import Trigger

__all__ = ["Adam", "Default", "GradientClipping", "LearningRateSchedule",
           "OptimMethod", "Optimizer", "SGD", "TrainStep", "TrainedModel",
           "Trigger"]
