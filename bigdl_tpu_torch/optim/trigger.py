"""Triggers — when to stop training.  A copy of ``bigdl_tpu.optim.trigger``
(pure Python), so that the port imports nothing of the JAX package.

A trigger is evaluated host-side on the training loop's state dict (epoch,
iteration, loss, epoch_finished, ...).  The ``boundary`` hint of
iteration-structured triggers serves the JAX ``Optimizer``'s step
bundling, which the port's does not have yet; it is kept so the two
packages' triggers stay one object model."""

from typing import Callable, Dict, Optional


class Trigger:
    def __init__(self, fn: Callable[[Dict], bool], desc: str = "trigger",
                 boundary: Optional[Callable[[int], Optional[int]]] = None):
        self.fn = fn
        self.desc = desc
        self.boundary = boundary

    def __call__(self, state: Dict) -> bool:
        return bool(self.fn(state))

    def __repr__(self):
        return f"Trigger({self.desc})"

    # -- factories (reference names, snake_case) ---------------------------
    @staticmethod
    def every_epoch() -> "Trigger":
        """Fires at each epoch boundary (reference everyEpoch)."""
        return Trigger(lambda s: s.get("epoch_finished", False), "every_epoch")

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s["iteration"] > 0 and s["iteration"] % n == 0,
                       f"several_iteration({n})",
                       boundary=lambda it: n - it % n)

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        """True once epoch count exceeds n (epochs are 1-based like the
        reference)."""
        return Trigger(lambda s: s["epoch"] > n, f"max_epoch({n})")

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s["iteration"] >= n, f"max_iteration({n})",
                       boundary=lambda it: n - it if it < n else None)

    @staticmethod
    def min_loss(v: float) -> "Trigger":
        return Trigger(lambda s: s.get("loss", float("inf")) < v, f"min_loss({v})")

    @staticmethod
    def max_score(v: float) -> "Trigger":
        return Trigger(lambda s: s.get("score", float("-inf")) > v,
                       f"max_score({v})")

    @staticmethod
    def plateau(monitor: str = "score", patience: int = 3,
                min_delta: float = 0.0) -> "Trigger":
        """Early stopping: fire when ``monitor`` ("score": higher-better
        validation score, observed once per VALIDATION EVENT; "loss":
        lower-better training loss, observed once per EPOCH) has not
        improved by ``min_delta`` for ``patience`` consecutive
        observations.  The keras-EarlyStopping analog as an end-when
        trigger (stateful: one instance tracks one run).  end_when runs
        every iteration, so observations are gated on the event counter —
        re-seeing the same score between validations does not burn
        patience."""
        if monitor not in ("score", "loss"):
            raise ValueError(
                f"plateau monitor {monitor!r}: 'score' (validation, "
                "higher-better) or 'loss' (training, lower-better)")
        higher_better = monitor == "score"
        event_key = "n_validations" if monitor == "score" else "epoch"
        best = [None]
        stale = [0]
        last_event = [None]

        def fn(s):
            event = s.get(event_key)
            # strictly monotonic: a failure-retry resume rolls the loop's
            # state back and REPLAYS events — re-observing them would burn
            # patience twice and fire early.  Skipping replays only delays
            # the stop (conservative).
            if event is None or (last_event[0] is not None
                                 and event <= last_event[0]):
                return stale[0] >= patience  # no NEW observation
            v = s.get(monitor)
            try:
                v = float(v)
            except (TypeError, ValueError):
                return False
            if v != v or v in (float("inf"), float("-inf")):
                return False
            last_event[0] = event
            improved = (best[0] is None
                        or (v > best[0] + min_delta if higher_better
                            else v < best[0] - min_delta))
            if improved:
                best[0] = v
                stale[0] = 0
            else:
                stale[0] += 1
            return stale[0] >= patience

        return Trigger(fn, f"plateau({monitor}, patience={patience})")

    @staticmethod
    def _child_boundary(triggers):
        """Earliest iteration edge of any child — shortening a bundle more
        than strictly needed is always safe (it only adds an extra host
        visit), missing an edge is not."""
        def boundary(it):
            edges = [b(it) for b in
                     (getattr(t, "boundary", None) for t in triggers)
                     if b is not None]
            edges = [e for e in edges if e is not None and e > 0]
            return min(edges) if edges else None

        return boundary

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in triggers), "and",
                       boundary=Trigger._child_boundary(triggers))

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers), "or",
                       boundary=Trigger._child_boundary(triggers))
