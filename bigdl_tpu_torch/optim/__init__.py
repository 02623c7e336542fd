"""Training — the port of ``bigdl_tpu.optim``'s single-device training:
the Optimizer, the train step, the optim methods, learning-rate schedules,
validation methods, triggers and checkpoints."""

from bigdl_tpu_torch.optim import checkpoint
from bigdl_tpu_torch.optim.optim_method import (
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamWeightDecay, Ftrl,
    LarsSGD, OptimMethod, RMSprop)
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.schedules import (
    Cosine, Default, EpochDecay, EpochSchedule, EpochStep, Exponential,
    LearningRateSchedule, MultiStep, NaturalExp, Plateau, Poly,
    SequentialSchedule, Step, Warmup)
from bigdl_tpu_torch.optim.train_step import (GradientClipping,
                                              ShardedParameterStep,
                                              TrainStep)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (
    AUC, MAE, MSE, NDCG, HitRatio, Loss, Precision, Recall, Top1Accuracy,
    Top5Accuracy, ValidationMethod, ValidationResult)

__all__ = ["AUC", "Adadelta", "Adagrad", "Adam", "AdamWeightDecay",
           "Adamax", "Cosine", "Default", "EpochDecay", "EpochSchedule",
           "EpochStep", "Exponential", "Ftrl", "GradientClipping",
           "HitRatio", "LBFGS", "LarsSGD", "LearningRateSchedule", "Loss",
           "MAE", "MSE", "MultiStep", "NDCG", "NaturalExp", "OptimMethod",
           "Optimizer", "Plateau", "Poly", "Precision", "RMSprop", "Recall",
           "SGD", "SequentialSchedule", "ShardedParameterStep", "Step", "Top1Accuracy",
           "Top5Accuracy", "TrainStep", "TrainedModel", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup", "checkpoint",
           "PredictionService"]


def __getattr__(name):
    # PredictionService serves through serving.InferenceModel, whose
    # imports reach back into this package: resolved at first use
    if name == "PredictionService":
        from bigdl_tpu_torch.optim.prediction_service import \
            PredictionService

        return PredictionService
    raise AttributeError(name)
