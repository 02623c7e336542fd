from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          PositionwiseFFN, Transformer,
                                          TransformerLayer,
                                          positional_encoding)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.layers import (
    ELU, GELU, AvgPool2D, BatchNorm, BatchNormalization, Conv1D, Conv2D,
    Dense, Dropout, Embedding, Flatten, GlobalAvgPool2D, HardSigmoid,
    HardSwish, HardTanh, LayerNorm, LeakyReLU, Linear, LogSoftMax,
    LookupTable, MaxPool2D, ReLU, ReLU6, Reshape, RMSNorm, SiLU, Sigmoid,
    SoftMax, SoftPlus, SoftSign, SpatialAveragePooling,
    SpatialBatchNormalization, SpatialConvolution, SpatialMaxPooling,
    Squeeze, Swish, Tanh, TemporalConvolution, Transpose, Unsqueeze, View,
    ZeroPadding2D)
from bigdl_tpu_torch.nn.layers_extra import (CAdd, CAveTable, CMaxTable,
                                             CosineDistance, DotProduct,
                                             Select)
from bigdl_tpu_torch.nn.module import (CAddTable, CMulTable, Concat,
                                       ConcatTable, Container, Identity,
                                       JoinTable, Lambda, Module,
                                       ParallelTable, SelectTable,
                                       Sequential)
from bigdl_tpu_torch.nn.quantized import (QuantizedConv2D, QuantizedLinear,
                                          WeightOnlyConv2D, WeightOnlyLinear,
                                          calibrate, quantize)

__all__ = [
    "AvgPool2D", "BatchNorm", "BatchNormalization", "CAdd", "CAddTable",
    "CAveTable", "CMaxTable", "CMulTable", "ClassNLLCriterion", "Concat",
    "ConcatTable", "Container", "Conv1D", "Conv2D", "CosineDistance",
    "Criterion", "CrossEntropyCriterion", "Dense", "DotProduct", "Dropout",
    "ELU", "Embedding", "Flatten", "GELU", "GlobalAvgPool2D", "HardSigmoid",
    "HardSwish", "HardTanh", "Identity", "JoinTable", "Lambda", "LayerNorm",
    "LeakyReLU", "Linear", "LogSoftMax", "LookupTable", "MaxPool2D", "Module",
    "MultiHeadAttention", "ParallelTable", "PositionwiseFFN",
    "QuantizedConv2D", "QuantizedLinear", "RMSNorm", "ReLU", "ReLU6",
    "Reshape", "Select", "SelectTable", "Sequential", "SiLU", "Sigmoid",
    "SoftMax", "SoftPlus", "SoftSign", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialConvolution", "SpatialMaxPooling",
    "Squeeze", "Swish", "Tanh", "TemporalConvolution", "Transformer",
    "TransformerLayer", "Transpose", "Unsqueeze", "View", "WeightOnlyConv2D",
    "WeightOnlyLinear", "ZeroPadding2D", "calibrate", "init",
    "positional_encoding", "quantize"]
