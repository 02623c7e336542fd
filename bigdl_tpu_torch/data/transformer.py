"""Transformer — composable Iterator->Iterator data pipeline stages,
chained with ``>>`` (the port of ``bigdl_tpu.data.transformer``)."""

from typing import Any, Callable, Iterator


class Transformer:
    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterator) -> Iterator:
        return self.apply(it)

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second(self.first(it))


class Identity(Transformer):
    def apply(self, it):
        return it


class MapTransformer(Transformer):
    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


class FilterTransformer(Transformer):
    def __init__(self, pred: Callable[[Any], bool]):
        self.pred = pred

    def apply(self, it):
        return (x for x in it if self.pred(x))
