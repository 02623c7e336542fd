from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          PositionwiseFFN, Transformer,
                                          TransformerDecoderLayer,
                                          TransformerLayer,
                                          positional_encoding,
                                          transformer_decode,
                                          transformer_decode_cached)
from bigdl_tpu_torch.nn.decode import (DecodeResult, beam_search,
                                       greedy_decode, sample_decode)
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, BCEWithLogitsCriterion, ClassNLLCriterion,
    CosineEmbeddingCriterion, Criterion, CrossEntropyCriterion,
    KLDivCriterion, MarginRankingCriterion, MSECriterion, ParallelCriterion,
    SmoothL1Criterion, TimeDistributedCriterion)
from bigdl_tpu_torch.nn.criterion_extra import (
    CategoricalCrossEntropy, CosineDistanceCriterion,
    CosineProximityCriterion, DiceCoefficientCriterion, DistKLDivCriterion,
    GaussianCriterion, HingeEmbeddingCriterion, KLDCriterion,
    KullbackLeiblerDivergenceCriterion, L1Cost, L1HingeEmbeddingCriterion,
    MarginCriterion, MeanAbsolutePercentageCriterion,
    MeanSquaredLogarithmicCriterion, MultiCriterion,
    MultiLabelSoftMarginCriterion, MultiMarginCriterion, PGCriterion,
    PoissonCriterion, RankHingeCriterion, SoftMarginCriterion,
    TimeDistributedMaskCriterion, TransformerCriterion)
from bigdl_tpu_torch.nn.freeze import has_frozen, trainable_mask_for
from bigdl_tpu_torch.nn.layers import (
    ELU, GELU, AvgPool2D, BatchNorm, BatchNormalization, Conv1D, Conv2D,
    Dense, Dropout, Embedding, Flatten, GlobalAvgPool2D, HardSigmoid,
    HardSwish, HardTanh, LayerNorm, LeakyReLU, Linear, LogSoftMax,
    LookupTable, MaxPool2D, PReLU, ReLU, ReLU6, Reshape, RMSNorm, SiLU, Sigmoid,
    SoftMax, SoftPlus, SoftSign, SpatialAveragePooling,
    SpatialBatchNormalization, SpatialConvolution, SpatialMaxPooling,
    Squeeze, Swish, Tanh, TemporalConvolution, Transpose, Unsqueeze, View,
    ZeroPadding2D)
from bigdl_tpu_torch.nn.layers_extra import (
    AddConstant, CAdd, CAveTable, CDivTable, CMaxTable, Conv2DTranspose,
    CosineDistance, CSubTable, DotProduct, LogSigmoid, Maxout, Mean,
    MulConstant, Select, UpSampling2D)
from bigdl_tpu_torch.nn.layers_more import (HardShrink, Mish, SoftShrink,
                                            TanhShrink)
from bigdl_tpu_torch.nn.layers_tail import GroupNorm
from bigdl_tpu_torch.nn.module import (CAddTable, CMulTable, Concat,
                                       ConcatTable, Container, Identity,
                                       JoinTable, Lambda, Module,
                                       ParallelTable, SelectTable,
                                       Sequential)
from bigdl_tpu_torch.nn.rnn import (GRU, LSTM, BiRecurrent, LSTMPeephole,
                                    MultiRNNCell, Recurrent,
                                    RecurrentDecoder, RnnCell, SimpleRNN,
                                    TimeDistributed)
from bigdl_tpu_torch.nn.quantized import (QuantizedConv2D, QuantizedLinear,
                                          WeightOnlyConv2D, WeightOnlyLinear,
                                          calibrate, quantize)

__all__ = [
    "CategoricalCrossEntropy", "CosineDistanceCriterion",
    "CosineProximityCriterion", "DiceCoefficientCriterion",
    "DistKLDivCriterion", "GaussianCriterion", "HingeEmbeddingCriterion",
    "KLDCriterion", "KullbackLeiblerDivergenceCriterion", "L1Cost",
    "L1HingeEmbeddingCriterion", "MarginCriterion",
    "MeanAbsolutePercentageCriterion", "MeanSquaredLogarithmicCriterion",
    "MultiCriterion", "MultiLabelSoftMarginCriterion",
    "MultiMarginCriterion", "PGCriterion", "PoissonCriterion",
    "RankHingeCriterion", "SoftMarginCriterion",
    "TimeDistributedMaskCriterion", "TransformerCriterion",
    "AbsCriterion", "AvgPool2D", "BCECriterion", "BCEWithLogitsCriterion",
    "CosineEmbeddingCriterion", "KLDivCriterion", "MSECriterion",
    "MarginRankingCriterion", "ParallelCriterion", "SmoothL1Criterion",
    "TimeDistributedCriterion", "has_frozen", "trainable_mask_for", "BatchNorm", "BatchNormalization", "CAdd", "CAddTable",
    "CAveTable", "CMaxTable", "CMulTable", "ClassNLLCriterion", "Concat",
    "ConcatTable", "Container", "Conv1D", "Conv2D", "CosineDistance",
    "Criterion", "CrossEntropyCriterion", "Dense", "DotProduct", "Dropout",
    "ELU", "Embedding", "Flatten", "GELU", "GlobalAvgPool2D", "HardSigmoid",
    "HardSwish", "HardTanh", "Identity", "JoinTable", "Lambda", "LayerNorm",
    "LeakyReLU", "Linear", "LogSoftMax", "LookupTable", "MaxPool2D", "Module",
    "MultiHeadAttention", "ParallelTable", "PositionwiseFFN",
    "PReLU", "QuantizedConv2D", "QuantizedLinear", "RMSNorm", "ReLU", "ReLU6",
    "Reshape", "Select", "SelectTable", "Sequential", "SiLU", "Sigmoid",
    "SoftMax", "SoftPlus", "SoftSign", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialConvolution", "SpatialMaxPooling",
    "Squeeze", "Swish", "Tanh", "TemporalConvolution", "Transformer",
    "TransformerLayer", "Transpose", "Unsqueeze", "View", "WeightOnlyConv2D",
    "WeightOnlyLinear", "ZeroPadding2D", "calibrate", "init",
    "positional_encoding", "quantize",
    "BiRecurrent", "DecodeResult", "GRU", "LSTM", "LSTMPeephole", "Maxout",
    "MultiRNNCell", "Recurrent", "RecurrentDecoder", "RnnCell", "SimpleRNN",
    "TimeDistributed", "TransformerDecoderLayer", "beam_search",
    "greedy_decode", "sample_decode", "transformer_decode",
    "transformer_decode_cached", "AddConstant", "CDivTable", "CSubTable",
    "Conv2DTranspose", "GroupNorm", "HardShrink", "LogSigmoid", "Mean",
    "Mish", "MulConstant", "SoftShrink", "TanhShrink", "UpSampling2D"]
