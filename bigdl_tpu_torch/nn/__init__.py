from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          PositionwiseFFN, Transformer,
                                          TransformerLayer,
                                          positional_encoding)
from bigdl_tpu_torch.nn.layers import Dropout, LayerNorm, Linear

__all__ = ["Dropout", "LayerNorm", "Linear", "MultiHeadAttention",
           "PositionwiseFFN", "Transformer", "TransformerLayer",
           "positional_encoding"]
