"""The port's native host library: image transforms, JPEG decode and
encode, batch assembly and the record reader in C++
(``bigdl_tpu_io.cpp``), built with ``g++`` at first use and bound with
ctypes; every entry point but the encoder has a numpy (or PIL) fallback."""

from bigdl_tpu_torch.native.lib import (BatchPipeline, available, crop,
                                        decode_jpeg, encode_jpeg, hflip,
                                        jpeg_available,
                                        jpeg_unavailable_reason, normalize,
                                        resize_bilinear)

__all__ = ["available", "resize_bilinear", "normalize", "hflip", "crop",
           "decode_jpeg", "encode_jpeg", "jpeg_available",
           "jpeg_unavailable_reason", "BatchPipeline"]
