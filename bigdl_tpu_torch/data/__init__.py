"""Input pipeline — the port of ``bigdl_tpu.data``: in-memory and record
datasets, the stage-parallel streaming pipeline and its device feed, the
vision, text and segmentation helpers, and XShards."""

from bigdl_tpu_torch.data.augmentation import (
    AspectScale, Brightness, ChannelOrder, ColorJitter, Contrast, Expand,
    Filler, FixedCrop, Grayscale, Hue, PixelNormalizer, RandomAspectScale,
    RandomTransformer, Saturation,
)
from bigdl_tpu_torch.data.dataset import (
    ArrayDataSet, DataSet, MiniBatch, ProcessLocalDataSet, Sample,
    SampleToMiniBatch,
)
from bigdl_tpu_torch.data.pipeline import (
    BufferRing, PipelineError, RingBatch, SharedMemoryDecodePool,
    StreamingPipeline, autotune_depths, autotune_workers,
    dispatch_to_device,
)
from bigdl_tpu_torch.data.prefetch import prefetch_to_device, thread_prefetch
from bigdl_tpu_torch.data.records import RecordDataSet, write_records
from bigdl_tpu_torch.data.segmentation import (
    annotation_to_mask, mask_to_bbox, polygons_to_mask, rle_area,
    rle_decode, rle_encode,
)
from bigdl_tpu_torch.data.transformer import Identity as IdentityTransformer
from bigdl_tpu_torch.data.transformer import Transformer
from bigdl_tpu_torch.data.vision import (AugmentedRecordImages,
                                         stream_jpeg_batches)

__all__ = [
    "DataSet", "ArrayDataSet", "Sample", "MiniBatch", "SampleToMiniBatch",
    "ProcessLocalDataSet", "Transformer", "IdentityTransformer",
    "RecordDataSet", "write_records", "prefetch_to_device",
    "thread_prefetch", "BufferRing", "PipelineError", "RingBatch",
    "SharedMemoryDecodePool", "StreamingPipeline", "autotune_depths",
    "autotune_workers", "dispatch_to_device", "AugmentedRecordImages",
    "stream_jpeg_batches", "Brightness", "Contrast", "Saturation", "Hue",
    "ColorJitter", "ChannelOrder", "Grayscale", "Expand", "Filler",
    "FixedCrop", "AspectScale", "RandomAspectScale", "PixelNormalizer",
    "RandomTransformer", "rle_encode", "rle_decode", "rle_area",
    "polygons_to_mask", "mask_to_bbox", "annotation_to_mask",
]
