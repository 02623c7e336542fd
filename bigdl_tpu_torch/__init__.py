"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

It mirrors ``bigdl_tpu``'s module names and imports neither JAX nor
anything of ``bigdl_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; every kernel that ``bigdl_tpu`` wrote in
Pallas for the TPU is a hand-written CUDA kernel here, beside a plain
PyTorch version of the same function that tensors on the CPU take."""
