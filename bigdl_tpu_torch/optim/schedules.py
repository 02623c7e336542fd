"""Learning-rate schedules — the port of the part of
``bigdl_tpu.optim.schedules`` that the ported optim methods use.  A
schedule maps (base lr, 0-based step) to the step's learning rate."""


class LearningRateSchedule:
    def __call__(self, lr: float, step: int) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + step * decay)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.decay = learning_rate_decay

    def __call__(self, lr, step):
        return lr / (1.0 + step * self.decay)
