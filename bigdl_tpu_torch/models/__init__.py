from bigdl_tpu_torch.models.inception import (inception_module,
                                              inception_v1,
                                              inception_v2,
                                              inception_v2_module)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import (BasicBlock, Bottleneck,
                                           SpaceToDepthStem,
                                           pack_stem_kernel, resnet50,
                                           resnet_cifar)
from bigdl_tpu_torch.models.rnn_zoo import Seq2Seq, char_rnn
from bigdl_tpu_torch.models.transformer_zoo import (BERT, BERTClassifier,
                                                    TransformerEncoder)
from bigdl_tpu_torch.models.vgg import vgg16, vgg_cifar10

__all__ = ["BERT", "BERTClassifier", "BasicBlock", "Bottleneck", "LeNet5",
           "Seq2Seq", "SpaceToDepthStem", "TransformerEncoder", "char_rnn",
           "inception_module", "inception_v1", "inception_v2",
           "inception_v2_module", "pack_stem_kernel", "resnet50",
           "resnet_cifar", "vgg16", "vgg_cifar10"]
