from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import (BasicBlock, Bottleneck,
                                           SpaceToDepthStem,
                                           pack_stem_kernel, resnet50,
                                           resnet_cifar)

__all__ = ["BasicBlock", "Bottleneck", "LeNet5", "SpaceToDepthStem",
           "pack_stem_kernel", "resnet50", "resnet_cifar"]
