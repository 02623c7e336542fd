"""Optimization methods — the port of ``bigdl_tpu.optim.optim_method``.

The JAX methods are pure: ``update(step, grads, params, state)`` returns
new params and a new state.  Here the update runs under
``torch.no_grad()`` and changes the parameters and the state tensors IN
PLACE, which keeps one copy of each on the device; it returns nothing.
``params`` and ``grads`` are equal-length lists of tensors and the state
holds one list per slot (Adam's ``m`` and ``v``), under the JAX slot
names, which checkpoints key on.  ``step`` is the 0-based iteration, as
``Optimizer`` passes it: Adam's bias correction uses ``t = step + 1``, as
in the JAX package.

The values of an update that depend on the step (the rate from the live
schedule, Adam's bias corrections, a warmup factor) are computed on the
host by ``scalars(step)`` and written with ``fill_`` into 0-d float32
tensors on the parameters' device (``step_tensors``); ``apply`` reads
them there.  A captured step (``TrainStep.train_bundle``) thus holds the
tensors' addresses, never their values: each replay reads the values
written before it, a ``Plateau`` drop included (ROADMAP C.11).  The
float32 value written is the one a Python float multiplies by, so the
update is the same bits either way.  ``update(step, ...)`` writes and
applies in one call.

``elementwise`` methods are the JAX package's slice-safe ones: every slot
is per element.  ``LarsSGD`` and ``LBFGS`` are not: LARS takes one trust
ratio per tensor (a JAX leaf), and LBFGS keeps a history and dot
products over all parameters, plus the tensor slots ``rho`` and
``count``."""

from typing import Dict, List, Optional

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

State = Dict[str, List[torch.Tensor]]
Scalars = Dict[str, torch.Tensor]


class OptimMethod:
    elementwise: bool = True

    def init_state(self, params: List[torch.Tensor]) -> State:
        return {}

    def scalars(self, step: int) -> Dict[str, float]:
        """The host values of ``step``'s update that depend on the step,
        by name (none for a method whose update reads no step)."""
        return {}

    def step_tensors(self, step: int, device) -> Scalars:
        """``scalars(step)`` written into 0-d float32 tensors on
        ``device`` that this method keeps, one per name: the same tensors
        every step, so a captured update reads the values of the step it
        replays."""
        vals = self.scalars(step)
        # device -> tensors (the methods call no base __init__)
        held = self.__dict__.setdefault("_held_scalars", {})
        dev = torch.device(device)
        if dev not in held:
            held[dev] = {k: torch.zeros((), dtype=torch.float32, device=dev)
                         for k in vals}
        for k, v in vals.items():
            held[dev][k].fill_(v)
        return held[dev]

    def apply(self, s: Scalars, grads: List[torch.Tensor],
              params: List[torch.Tensor], state: State) -> None:
        """The update in place, reading the step's values from ``s``."""
        raise NotImplementedError

    def update(self, step: int, grads: List[torch.Tensor],
               params: List[torch.Tensor], state: State) -> None:
        dev = params[0].device if params else "cpu"
        self.apply(self.step_tensors(step, dev), grads, params, state)

    def get_learning_rate(self, step: int) -> float:
        return getattr(self, "lr", 0.0)


class SGD(OptimMethod):
    """SGD with momentum, dampening, Nesterov and weight decay, and a
    pluggable learning-rate schedule."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            self.dampening = 0.0

    def get_learning_rate(self, step):
        return self.schedule(self.lr, step)

    def init_state(self, params):
        if self.momentum > 0:
            return {"velocity": [torch.zeros_like(p) for p in params]}
        return {}

    def scalars(self, step):
        return {"lr": self.schedule(self.lr, step)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr = s["lr"]
        for i, (g, p) in enumerate(zip(grads, params)):
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            if self.momentum > 0:
                vel = state["velocity"][i]
                vel.mul_(self.momentum).add_(g, alpha=1 - self.dampening)
                g = g + self.momentum * vel if self.nesterov else vel
            p.sub_(lr * g)


class Adam(OptimMethod):
    """Adam with bias correction; ``m`` and ``v`` live beside the
    parameters on their device."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        self.lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def get_learning_rate(self, step):
        return self.schedule(self.lr, step)

    def init_state(self, params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    def scalars(self, step):
        t = step + 1
        return {"lr": self.schedule(self.lr, step),
                "bc1": 1 - self.beta1 ** t, "bc2": 1 - self.beta2 ** t}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr, bc1, bc2 = s["lr"], s["bc1"], s["bc2"]
        for g, p, m, v in zip(grads, params, state["m"], state["v"]):
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt_().add_(self.eps)))


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


class AdamWeightDecay(OptimMethod):
    """Adam without bias correction, with decoupled weight decay and a
    linear warmup over ``warmup_portion`` of ``total`` steps, then a
    linear decay to 0 (the BERT fine-tuning method)."""

    def __init__(self, learning_rate: float = 1e-3,
                 warmup_portion: float = -1.0, total: int = -1,
                 schedule: str = "linear", beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.01):
        self.lr = learning_rate
        self.warmup_portion = warmup_portion
        self.total = total
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def get_learning_rate(self, step):
        if self.total <= 0:
            return self.lr
        progress = step / self.total
        warm = max(self.warmup_portion, 0.0)
        if progress < warm:
            return self.lr * progress / warm
        return self.lr * (1.0 - progress)

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def scalars(self, step):
        return {"lr": self.get_learning_rate(step)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr = s["lr"]
        for g, p, m, v in zip(grads, params, state["m"], state["v"]):
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            p.sub_(lr * (m / (v.sqrt() + self.eps) + self.weight_decay * p))


class Adagrad(OptimMethod):
    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        self.lr = learning_rate
        self.decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        return {"accum": _zeros(params)}

    def scalars(self, step):
        return {"lr": self.lr / (1.0 + step * self.decay)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr = s["lr"]
        for g, p, a in zip(grads, params, state["accum"]):
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            a.addcmul_(g, g)
            p.sub_(lr * g / (a.sqrt() + 1e-10))


class RMSprop(OptimMethod):
    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8):
        self.lr = learning_rate
        self.decay = learning_rate_decay
        self.rho = decay_rate
        self.eps = epsilon

    def init_state(self, params):
        return {"rms": _zeros(params)}

    def scalars(self, step):
        return {"lr": self.lr / (1.0 + step * self.decay)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr = s["lr"]
        for g, p, r in zip(grads, params, state["rms"]):
            r.mul_(self.rho).addcmul_(g, g, value=1 - self.rho)
            p.sub_(lr * g / (r.sqrt() + self.eps))


class Adadelta(OptimMethod):
    """Accumulated-delta scaling; ``learning_rate`` multiplies the final
    step."""

    def __init__(self, learning_rate: float = 1.0, decay_rate: float = 0.9,
                 epsilon: float = 1e-10):
        self.lr = learning_rate
        self.rho = decay_rate
        self.eps = epsilon

    def init_state(self, params):
        return {"accum": _zeros(params), "delta": _zeros(params)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        rho, eps = self.rho, self.eps
        for g, p, a, d in zip(grads, params, state["accum"], state["delta"]):
            a.mul_(rho).addcmul_(g, g, value=1 - rho)
            upd = g * (d + eps).sqrt() / (a + eps).sqrt()
            d.mul_(rho).addcmul_(upd, upd, value=1 - rho)
            p.sub_(self.lr * upd)


class Adamax(OptimMethod):
    """Adam with an infinity-norm second moment ``u``."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        self.lr = learning_rate
        self.b1 = beta1
        self.b2 = beta2
        self.eps = epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def scalars(self, step):
        return {"lr_t": self.lr / (1.0 - self.b1 ** (step + 1))}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr_t = s["lr_t"]
        for g, p, m, u in zip(grads, params, state["m"], state["u"]):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            torch.maximum(u * self.b2, g.abs() + self.eps, out=u)
            p.sub_(lr_t * m / u)


class Ftrl(OptimMethod):
    """Follow-the-regularized-leader with per-element accumulators
    ``accum`` (n) and ``linear`` (z)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        self.lr = learning_rate
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def init_state(self, params):
        return {"accum": [torch.full_like(p, self.init_accum)
                          for p in params],
                "linear": _zeros(params)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        pw = -self.lr_power
        for g, p, n, z in zip(grads, params, state["accum"],
                              state["linear"]):
            new_n = n + g * g
            sigma = (new_n ** pw - n ** pw) / self.lr
            z.add_(g - sigma * p)
            shrunk = -(z - torch.sign(z) * self.l1) / (
                new_n ** pw / self.lr + 2 * self.l2)
            p.copy_(torch.where(z.abs() > self.l1, shrunk,
                                torch.zeros_like(p)))
            n.copy_(new_n)


class LarsSGD(OptimMethod):
    """Layer-wise adaptive rate scaling: one trust ratio per tensor (a
    leaf of the JAX params tree), momentum ``velocity``."""

    elementwise = False

    def __init__(self, learning_rate: float = 1e-1, momentum: float = 0.9,
                 weight_decay: float = 5e-4, trust_coefficient: float = 1e-3,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        self.lr = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust = trust_coefficient
        self.schedule = learning_rate_schedule or Default(0.0)

    def get_learning_rate(self, step):
        return self.schedule(self.lr, step)

    def init_state(self, params):
        return {"velocity": _zeros(params)}

    def scalars(self, step):
        return {"lr": self.schedule(self.lr, step)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        lr = s["lr"]
        wd = self.weight_decay
        for g, p, v in zip(grads, params, state["velocity"]):
            p_norm = torch.linalg.vector_norm(p)
            g_norm = torch.linalg.vector_norm(g)
            local_lr = torch.where(
                (p_norm > 0) & (g_norm > 0),
                self.trust * p_norm / (g_norm + wd * p_norm + 1e-12),
                torch.ones_like(p_norm))
            v.mul_(self.momentum).add_(lr * local_lr * (g + wd * p))
            p.sub_(v)


def _dot(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    return sum((x * y).sum() for x, y in zip(a, b))


class LBFGS(OptimMethod):
    """Limited-memory BFGS with a fixed step ``learning_rate`` (no line
    search) and a history of ``history_size`` (s, y) pairs, newest last.
    A pair enters the history only when y·s > eps; an empty slot has
    rho = 0 and drops out of the two-loop recursion.  Everything stays
    on the device: the step needs no host read."""

    elementwise = False

    def __init__(self, learning_rate: float = 1.0, history_size: int = 10,
                 eps: float = 1e-10):
        self.lr = learning_rate
        self.m = history_size
        self.eps = eps

    def init_state(self, params):
        def hist(p):
            return p.new_zeros((self.m,) + tuple(p.shape))

        dev = params[0].device if params else None
        return {"s": [hist(p) for p in params],
                "y": [hist(p) for p in params],
                "rho": torch.zeros(self.m, device=dev),
                "prev_params": _zeros(params),
                "prev_grads": _zeros(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def apply(self, s, grads, params, state):
        eps = self.eps
        s_new = [p - q for p, q in zip(params, state["prev_params"])]
        y_new = [g - h for g, h in zip(grads, state["prev_grads"])]
        ys = _dot(y_new, s_new)
        valid = (state["count"] > 0) & (ys > eps)
        for hist, new in ((state["s"], s_new), (state["y"], y_new)):
            for h, n in zip(hist, new):
                h.copy_(torch.where(valid, torch.cat([h[1:], n[None]]), h))
        rho = state["rho"]
        rho.copy_(torch.where(valid, torch.cat(
            [rho[1:], (1.0 / torch.clamp(ys, min=eps))[None]]), rho))
        s_hist, y_hist = state["s"], state["y"]

        q = [g.clone() for g in grads]
        alphas = []
        for i in range(self.m - 1, -1, -1):
            a_i = rho[i] * _dot([h[i] for h in s_hist], q)
            for qq, h in zip(q, y_hist):
                qq.sub_(a_i * h[i])
            alphas.append((i, a_i))
        y_last = [h[-1] for h in y_hist]
        yy = _dot(y_last, y_last)
        gamma = torch.where(
            yy > eps,
            _dot([h[-1] for h in s_hist], y_last) / torch.clamp(yy, min=eps),
            torch.ones_like(yy))
        for qq in q:
            qq.mul_(gamma)
        for i, a_i in reversed(alphas):
            b_i = rho[i] * _dot([h[i] for h in y_hist], q)
            for qq, h in zip(q, s_hist):
                qq.add_((a_i - b_i) * h[i])

        for p, g, pp, pg, d in zip(params, grads, state["prev_params"],
                                   state["prev_grads"], q):
            pp.copy_(p)
            pg.copy_(g)
            p.sub_(self.lr * d)
        state["count"].add_(1)
