"""Learning-rate schedules — the port of ``bigdl_tpu.optim.schedules``.

A schedule maps (base lr, 0-based step) to the step's learning rate as a
Python float.  The JAX schedules are traced inside the jitted step and
compute in float32; these compute the same formulas in double on the
host, so the two agree to float32 rounding.  ``Plateau`` is host state
``Optimizer`` feeds after each validation (``on_score``); the next step
just reads the new factor (there is no compiled step to rebuild)."""

import math
from typing import Callable, List, Optional, Sequence, Tuple


class LearningRateSchedule:
    def __call__(self, lr: float, step: int) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + step * decay)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.decay = learning_rate_decay

    def __call__(self, lr, step):
        return lr / (1.0 + step * self.decay)


class Step(LearningRateSchedule):
    """lr * gamma^floor(step / step_size)."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, lr, step):
        return lr * self.gamma ** math.floor(step / self.step_size)


class MultiStep(LearningRateSchedule):
    """lr * gamma^(milestones passed); a milestone m is passed at
    step >= m."""

    def __init__(self, step_sizes: Sequence[int], gamma: float = 0.1):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def __call__(self, lr, step):
        return lr * self.gamma ** sum(step >= s for s in self.step_sizes)


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(step / decay_step), floored with ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def __call__(self, lr, step):
        p = step / self.decay_step
        if self.stair_case:
            p = math.floor(p)
        return lr * self.decay_rate ** p


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(step / decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def __call__(self, lr, step):
        return lr * math.exp(-self.gamma * math.floor(step / self.decay_step))


class Poly(LearningRateSchedule):
    """lr * (1 - min(step / max_iteration, 1))^power."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def __call__(self, lr, step):
        frac = min(max(step / self.max_iteration, 0.0), 1.0)
        return lr * (1.0 - frac) ** self.power


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor(epoch / step_size_epochs), the 0-based epoch
    being ``step // steps_per_epoch``."""

    def __init__(self, step_size_epochs: int, gamma: float,
                 steps_per_epoch: int):
        self.step_size = step_size_epochs
        self.gamma = gamma
        self.steps_per_epoch = steps_per_epoch

    def __call__(self, lr, step):
        epoch = math.floor(step / self.steps_per_epoch)
        return lr * self.gamma ** math.floor(epoch / self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch), the 0-based epoch being
    ``step // steps_per_epoch`` (passed as a float, as the JAX schedule
    passes it)."""

    def __init__(self, decay_fn: Callable[[float], float],
                 steps_per_epoch: int):
        self.decay_fn = decay_fn
        self.steps_per_epoch = steps_per_epoch

    def __call__(self, lr, step):
        epoch = float(math.floor(step / self.steps_per_epoch))
        return lr * 0.1 ** float(self.decay_fn(epoch))


class EpochSchedule(LearningRateSchedule):
    """Piecewise-constant lr by ``(start_epoch, end_epoch, lr)`` regimes,
    epochs 1-based.  Past the last regime, or in a gap between two, the
    most recently started regime's rate persists."""

    def __init__(self, regimes: Sequence[Tuple[int, int, float]],
                 steps_per_epoch: int):
        if not regimes:
            raise ValueError("EpochSchedule needs at least one regime")
        self.regimes = tuple(sorted(regimes, key=lambda r: r[0]))
        self.steps_per_epoch = steps_per_epoch

    def __call__(self, lr, step):
        epoch = math.floor(step / self.steps_per_epoch) + 1
        out = lr
        for start, _end, value in self.regimes:
            if epoch >= start:
                out = value
        return out


class Cosine(LearningRateSchedule):
    """Cosine decay to ``alpha * lr`` over ``decay_steps``; the floor
    persists past them."""

    def __init__(self, decay_steps: int, alpha: float = 0.0):
        if decay_steps <= 0:
            raise ValueError("decay_steps must be positive")
        self.decay_steps = decay_steps
        self.alpha = alpha

    def __call__(self, lr, step):
        frac = min(max(step / self.decay_steps, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr * ((1 - self.alpha) * cos + self.alpha)


class Warmup(LearningRateSchedule):
    """lr + delta * step."""

    def __init__(self, delta: float):
        self.delta = delta

    def __call__(self, lr, step):
        return lr + self.delta * step


class SequentialSchedule(LearningRateSchedule):
    """Schedules chained in order, each for ``iterations`` steps.  A
    stage sees its own step, counted from its start and held at
    ``iterations`` past its end; step ``offset + n`` already belongs to
    the next stage.  Past the last stage, the last one keeps running at
    its held step."""

    def __init__(self):
        self.schedules: List[Tuple[LearningRateSchedule, int]] = []

    def add(self, schedule: LearningRateSchedule, iterations: int
            ) -> "SequentialSchedule":
        self.schedules.append((schedule, iterations))
        return self

    def __call__(self, lr, step):
        if not self.schedules:
            return lr
        offset = 0
        result = None
        for schedule, iters in self.schedules:
            if result is None or step >= offset:
                result = schedule(lr, min(max(step - offset, 0), iters))
            offset += iters
        return result


class Plateau(LearningRateSchedule):
    """Reduce-on-plateau: after ``patience`` validations without an
    improvement of ``epsilon`` in the monitored score (``mode`` "max" or
    "min"), the factor shrinks by ``factor``, then ``cooldown``
    validations pass unjudged; the rate never goes below ``min_lr``.
    ``monitor`` names the validation method (None: the first)."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 mode: str = "max", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0,
                 monitor: Optional[str] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode: min | max")
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.monitor = monitor
        self.current_factor = 1.0
        self._best = None
        self._bad = 0
        self._cooling = 0
        self._last_base_lr: Optional[float] = None

    def state_dict(self) -> dict:
        return {"current_factor": self.current_factor, "best": self._best,
                "bad": self._bad, "cooling": self._cooling}

    def load_state_dict(self, d: dict) -> None:
        self.current_factor = float(d["current_factor"])
        self._best = d["best"]
        self._bad = int(d["bad"])
        self._cooling = int(d["cooling"])

    def on_score(self, score: float) -> bool:
        """Record one validation score; True when the factor changed."""
        improved = (self._best is None
                    or (self.mode == "max"
                        and score > self._best + self.epsilon)
                    or (self.mode == "min"
                        and score < self._best - self.epsilon))
        if improved:
            self._best = score
            self._bad = 0
            return False
        if self._cooling > 0:
            self._cooling -= 1
            return False
        self._bad += 1
        if self._bad >= self.patience:
            self._bad = 0
            self._cooling = self.cooldown
            if (self._last_base_lr is not None
                    and self._last_base_lr * self.current_factor
                    <= self.min_lr):
                return False
            self.current_factor = self.current_factor * self.factor
            return True
        return False

    def __call__(self, lr, step):
        self._last_base_lr = float(lr)
        return max(lr * self.current_factor, self.min_lr)
