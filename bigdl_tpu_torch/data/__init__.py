"""Input pipeline — the port of ``bigdl_tpu.data``'s in-memory datasets."""

from bigdl_tpu_torch.data.dataset import ArrayDataSet, DataSet, MiniBatch

__all__ = ["ArrayDataSet", "DataSet", "MiniBatch"]
