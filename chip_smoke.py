#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``bigdl_tpu``.  Phases, each printing
one JSON line:

1. device — the card, with its name and power limit from nvidia-smi;
2. build  — every kernel under ``bigdl_tpu_torch/ops/csrc/`` built
   from source with nvcc (into ``build/``), one nvcc per source at once;
3. kernel — each kernel held against its plain PyTorch version at the
   shapes its main path gives it (the flash kernels also at a ragged
   shape; the verify kernel over float32 and int8 pages; the
   block-sparse product at the draft's decode and prefill shapes, its
   dx too; the int8 matmul exactly at every shape of a ResNet-50
   forward at bucket 16, at the split-K shapes of buckets 1, 4 and 64,
   at LeNet-5's ragged shapes and at M = 1, its fused rescale bit-equal
   to the plain tail in the three activation modes; the flash forward's
   non-causal instance at the encoder's shape; the fused LayerNorm at
   the encoder's shape, ragged shapes and a misaligned row start, its
   backward once), and timed beside its bound, the plain version and
   one PyTorch library call; the kernels that run 3xTF32 on the tensor
   cores (the flash forward and backward, the block-sparse product) are
   bounded by the tensor cores with the CUDA-core bound beside it; these,
   the paged decode and verify kernels (split walks merged in a fixed
   order) and the int8 matmul are also launched twice for the same bits,
   and the rows carry their share of the bound; first, timing_floor:
   what the yardstick reads for a 4-byte memset;
4. serve  — the GPT-2-small-class LM (12 layers, d=768, 12 heads, FFN
   3072, vocab 32768; random weights from seed 0) answers 16 greedy
   requests through ``InferenceModel.generate``; the launch counts show
   the decode steps went through the kernels, and every generated token
   is checked against a full (uncached) forward of the same model;
5. profile — the same requests again under torch.profiler: the device's
   busy share of the wall time and its time by kernel;
6. serve_spec — the same requests with ``speculative=SpecConfig(k=4,
   sparsity=0.5)``: every token checked as in serve, every verify
   through ``paged_verify_attention`` and every draft FFN through
   ``block_sparse_matmul`` (launch counts), tokens/s beside serve's,
   acceptance, agreement with serve's tokens; then spec_profile;
7. serve_int8 — int8 KV pages and int8 weights, once without and once
   with speculation (the scan verify on the int8 decode kernel): every
   token within the int8 tolerance of a full forward of the dequantized
   weights, launch counts of the int8 kernel, agreement and log-prob
   drift against serve, page bytes;
8. serve_resnet — ResNet-50 (random weights from seed 0, every BN
   redrawn) served through ``InferenceModel.predict`` in float32 and
   with ``weight_quant="int8"``: requests of 1, 3, 16 and 50 NHWC
   224x224 images (buckets 1, 4, 16, 64), then 20 of 64; float32 held
   to a direct forward, int8 to float32 (top-1 agreement, log-prob
   drift), 54 int8-kernel launches a bucket call, images/s, peak
   memory, weight bytes; then resnet_profile; then resnet_fused: the
   same model through ``IRGraph.from_model(...).to_model("fused")`` (the
   stem's BatchNorm folded into its conv) held to the unfused model at
   bucket 16;
9. serve_bert_fused — BERT-base's encoder (12 post-LN layers, d 768, 12
   heads, FFN 3072, vocab 30522, 128 tokens, a 2-label [CLS] head; random
   weights from seed 0, every LayerNorm and the position table redrawn)
   written with the port's keras API, fused by the IR rewrite (25
   LayerNorm nodes on the fused LayerNorm kernel) and served through
   ``InferenceModel.predict``: requests of 1, 3, 16 and 50 sequences,
   then 20 of 64; every answer held to the unfused model's direct
   forward with plain attention, 25 LayerNorm-kernel and 12 non-causal
   flash launches a bucket call, the plain LayerNorm never run; then
   bert_profile;
10. gradcheck — one batch's gradients of every parameter of the same LM
   with the flash kernels against plain attention (``use_flash=False``);
11. train  — the LM trained 10 steps (batch 8 x 1024 tokens, Adam 1e-4)
   through ``Optimizer.optimize()``: falling finite losses, step time,
   tokens/s, peak memory, and launch counts showing every attention
   layer's forward and backward went through the flash kernels;
12. train_profile — two more steps under torch.profiler;
13. train_plain_attention — four more steps with ``BIGDL_TPU_FLASH=0``,
   the switch that sends the auto path to plain attention: the A/B of
   the flash kernels end to end, and proof that the switch holds;
14. evaluate_lm — ``TrainedModel.evaluate`` of the trained LM on 2
   held-out batches of 8 x 1024 tokens with ``Loss``: 12 flash-forward
   launches a batch and nothing else, the mean loss within 1e-4 of
   plain attention's;
15. train_lenet — LeNet-5 trained 3 epochs on a learnable synthetic
   28x28 set (Adam 1e-3, batch 128, 2 microbatches a step, EMA 0.99,
   validation every epoch): the last validation's top-1 and the EMA
   weights' above 0.9, step time;
16. train_resnet — ResNet-50 (NHWC 224^2, batch 64, random images and
   labels) on the CIFAR recipe scaled to batch 64 (SGD 0.025, Nesterov,
   weight decay 5e-4, warmup then MultiStep): 6 steps checkpointed every
   3, a fresh Optimizer resuming from ckpt-6 to step 10 with validation
   (top-1, top-5, loss), and its steps 7-10 held to an uninterrupted
   10-step run's; step time, images/s, the device's busy share and its
   time by group (two steps under torch.profiler), peak memory, the
   checkpoint's bytes and its write, async write and resume times;
17. train_resnet_remat — 6 steps with ``remat`` against 6 without: peak
   memory, step time, the BatchNorm buffers equal.
   The ResNet phases pin cuDNN to deterministic algorithms; train_resnet
   also times 6 steps with cuDNN's default choice.

Then the kernel table, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero; without a CUDA card it exits non-zero and prints
no result."""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, TF32 and int8 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
INT8_OPS = 1.979e15

# the model of both main paths (bench_lm.py's), and the serving geometry
LM = dict(vocab_size=32768, hidden_size=768, num_heads=12, ffn_size=3072,
          num_layers=12)
DECODE = dict(slots=16, page_size=16, pages_per_slot=64, prompt_chunk=64,
              prefill_batch=4, max_new_tokens=32)
N_REQUESTS = 16
PROMPT_LENS = (16, 512)
SEED = 0

# training geometry of the main path (bench_lm.py's model and batch)
TRAIN = dict(batch=8, seq=1024, steps=10, lr=1e-4)

# evaluate_lm: TrainedModel.evaluate of the trained LM on held-out
# batches of the same shape (numpy seed 1), flash forward against plain
# attention: the mean loss sums 8 x 1024 x 32768 log-probs in float32,
# and 12 layers of flash against plain differ by float32 rounding; 1e-4
EVAL_LM_BATCHES = 2
EVAL_LM_ATOL = 1e-4

# train_lenet: LeNet-5 on a learnable synthetic 28x28 set (10 class
# templates U(0, 1) plus N(0, 0.3^2) noise, 4096 train and 1024
# validation images from numpy seed 0), the recipe of
# examples/lenet_mnist.py (Adam 1e-3, validation every epoch), batch 128,
# 3 epochs, 2 microbatches a step and a weight EMA of decay 0.99
LENET_TRAIN = dict(train=4096, val=1024, noise=0.3, batch=128, epochs=3,
                   lr=1e-3, accum=2, ema=0.99, min_top1=0.9)
# train_resnet: ResNet-50 (stem "conv", 1000 classes), NHWC 224^2, batch
# 64, on random images and labels from seed 0 (640 train, 128 validation):
# the recipe of examples/resnet_cifar10.py (SGD, Nesterov momentum 0.9,
# weight decay 5e-4, a warmup then MultiStep) with the base lr scaled to
# batch 64 by the linear rule, 0.1 x 64 / 256.  Run 1 trains 6 steps and
# checkpoints every 3, run 2 resumes from ckpt-6 to step 10 with
# validation every 5, run 3 trains 10 steps uninterrupted.
RESNET_TRAIN = dict(train=640, val=128, batch=64, lr=0.025, warmup=4,
                    milestone=8, ckpt_every=3, first=6, steps=10,
                    val_every=5, remat_steps=6, default_steps=6)
# ResNet-50 training's operations a step: 4.1 G multiply-adds an image
# forward, the backward twice the forward: 3 x 2 x 4.1e9 x 64
RESNET_TRAIN_FLOPS = 3 * 2 * 4.1e9 * 64
# resumed steps 7-10 against the uninterrupted run's: the training phases
# pin cuDNN to deterministic algorithms, so the runs differ only where a
# library kernel sums with float atomics in another order; 1e-4 relative
RESUME_RTOL = 1e-4
# remat against no remat: the recompute replays each BatchNorm's shift
# and leaves its buffers alone, the deterministic convs give the same bits
REMAT_BN_ATOL = 1e-6

# speculative decoding of the spec phases: SpecConfig(k=4, sparsity=0.5),
# the draft's FFN blocks (8, 8)
SPEC = dict(k=4, sparsity=0.5)
SPARSE_BLOCK = (8, 8)
VERIFY_CHUNK = SPEC["k"] + 1

# kernel check tolerance: f32 sums taken in another order over up to
# 1024 keys
RTOL, ATOL = 1e-4, 1e-5
# the flash backward's gradients sum up to 1024 products of unit-scale
# terms in another order than the plain version: same rtol, atol 1e-4
BWD_ATOL = 1e-4
# the block-sparse product sums up to 1536 kept products of unit-normal
# terms (K = 3072 at half density) in another order than cuBLAS: sums of
# magnitude ~40, float32 rounding of ~1536 * 6e-8 * 40 / sqrt(1536)
# apart; atol 1e-3
BS_ATOL = 1e-3
# on-card gradient check: per parameter, ||g_flash - g_plain|| over
# ||g_plain|| + 1e-4 ||g||.  The floor, relative to the whole gradient,
# holds the attention key bias to rounding noise: its exact gradient is
# 0 (softmax is shift-invariant over keys), so a relative error of its
# noise means nothing.  1e-4: twelve layers of float32 sums in another
# order stay far below it.
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-4

# the vision serving phase: ResNet-50 (stem "conv", 1000 classes), NHWC
# 224x224x3 images; requests of 1, 3, 16 and 50 images hit buckets 1, 4,
# 16 and 64, then 20 requests of 64 measure throughput.  The largest
# bucket is 64: at 256 the stem's im2col patches alone are 1.9 GB.
IMAGE = (224, 224, 3)
RESNET_BUCKETS = (1, 4, 16, 64)
RESNET_REQUESTS = (1, 3, 16, 50)
RESNET_THROUGHPUT = (20, 64)
# ResNet-50's int8 products a forward: the stem, 16 blocks x 3 convs, 4
# projections, the head
RESNET_INT8_CALLS = 54
# LeNet-5's int8 products (M, K, N) at batch 16: ragged K and N
LENET_INT8_SHAPES = ((16 * 28 * 28, 25, 6), (16 * 10 * 10, 150, 12),
                     (16, 300, 100), (16, 100, 10))
# float32 predict against a direct forward of the same rows: another
# batch size can take another cuDNN algorithm, float32 sums in another
# order, 1e-5 of the largest |log-prob|
RESNET_F32_RTOL = 1e-5
# int8 against float32, max |log-prob difference| over max |log-prob|.
# Derived before the first run: each quantized layer rounds its
# activations to half a step of its row's abs-max / 127 and its weights
# to half a step of the column's; as independent uniform errors of
# variance step^2 / 12 they add a relative RMS error of sqrt(2/12) *
# (abs-max / RMS) / 127 = 0.013 for an abs-max/RMS ratio of 4.  Over 54
# layers that add in quadrature, with no damping and no credit for the
# average pool: 0.013 * sqrt(54) = 0.095 of the logits' spread, which
# max |log-prob| (>= the spread of the logits) bounds.  Budget 0.1.
INT8_LOGP_RTOL = 0.1

# the encoder phase: BERT-base at its published widths
# (google-research/bert uncased_L-12_H-768_A-12: 12 post-LN layers, d 768,
# 12 heads, FFN 3072, vocab 30522, LayerNorm eps 1e-12) written with the
# port's keras API, at run_classifier.py's max_seq_length 128 with a pooled
# [CLS] head of 2 labels (SST-2's); random weights from seed 0.  Requests
# of 1, 3, 16 and 50 sequences hit buckets 1, 4, 16 and 64, then 20
# requests of 64 measure throughput.
BERT = dict(vocab=30522, length=128, d=768, heads=12, ffn=3072, layers=12,
            labels=2, eps=1e-12)
BERT_BUCKETS = (1, 4, 16, 64)
BERT_REQUESTS = (1, 3, 16, 50)
BERT_THROUGHPUT = (20, 64)
# fused predict against a direct forward of the unfused model with plain
# attention and plain LayerNorm, max |log-prob difference| over max
# |log-prob|.  Derived before the first run: each of a layer's ~6 summing
# stages (the q/k/v/out projections, the attention sums, the two FFN
# products) sums up to 3072 float32 terms in another order, a relative
# error of ~sqrt(3072 / 2) * 6e-8 = 2.4e-6; post-LN renormalizes the
# hidden state, so the 12 x 6 stages add in quadrature: sqrt(72) * 2.4e-6
# = 2.0e-5 of the logits' scale, and a 2-label log-softmax moves by at
# most twice the logits' error.  With logits of order 1 and max |log-prob|
# >= log 2, that is <= 6e-5 of max |log-prob|.  Budget 1e-4.
BERT_LOGP_RTOL = 1e-4
# the fused LayerNorm kernel against its plain version: rows of up to 1000
# float32 values summed in another order (warp shuffles), rsqrtf within 2
# ulp; rtol and atol 1e-5.  Its backward (plain torch) against autograd of
# the plain version: dgamma and dbeta sum 128 rows in another order, atol
# 1e-4
LN_RTOL = LN_ATOL = 1e-5
LN_BWD_ATOL = 1e-4
# the fold of a BatchNorm into the conv before it rounds the folded weights
# to float32 once: fused ResNet-50 predict within 1e-4 of max |log-prob|
# of the unfused model's
FOLD_LOGP_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel<64,1>`` (head_dim, causal) or
    ``paged_decode_kernel<64,int8>`` from the mangled name of a kernel
    (template instance or not, in a namespace or not); other names as
    they are."""
    # the last <length><name> component that names a kernel
    name, end = None, 0
    for m in re.finditer(r"(?=(\d+))", mangled):   # every digit run start
        start, n = m.start() + len(m.group(1)), int(m.group(1))
        cand = mangled[start:start + n]
        if cand.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", cand):
            name, end = cand, start + n
    if name is None:
        return mangled
    t = re.match(r"I((?:L[ib]\d+E|[fa])+)E", mangled[end:])
    if t is None:
        return name
    args = [a if a.isdigit() else {"f": "f32", "a": "int8"}[a]
            for a in re.findall(r"L[ib](\d+)E|([fa])", t.group(1))
            for a in a if a]
    return f"{name}<{','.join(args)}>"


def ptxas_report(logs) -> dict:
    """Registers and spills of each kernel instance from nvcc's
    ``-Xptxas -v`` output."""
    out, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = _kernel_name(m.group(1))
            elif name and "spill" in ln:
                out[name] = ln.strip()
            elif name and "registers" in ln:
                out[name] = (re.search(r"\d+ registers", ln).group(0)
                             + ", " + out.get(name, ""))
    return out


def time_cold(fn, flush, reps=50) -> float:
    """Median device time of one call (ms), the L2 cache flushed before
    each call, as a step finds it after the other layers ran."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the bytes over HBM's rate or
    the float32 operations over the CUDA cores' peak, whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _bound_3xtf32(nbytes: float, flops: float) -> dict:
    """The bound of a kernel whose float32 products run on the tensor
    cores in 3xTF32 (three TF32 products each): the bytes over HBM's rate
    or 3 x flops over the TF32 peak, whichever is larger.  The CUDA-core
    bound of the same work stands beside it, named; ``bound_ms`` and the
    share are read against the tensor-core one."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    tc = {"bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return {**tc, "bounds": {"tensor_core_3xtf32": tc,
                             "cuda_core_f32": _bound(nbytes, flops)}}


def _share(row: dict) -> dict:
    """The row with its roofline share: bound_ms over ms."""
    return {**row, "share": row["bound_ms"] / row["ms"]}


def _assert_bit_equal(name, first, second) -> None:
    """Two launches on the same inputs must give the same bits."""
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 f"differ, max {(a - b).abs().max().item()}")


def check_paged_decode(dev, flush):
    """The paged decode kernel against its plain version at the serving
    shapes: 16 slots, 12 heads, head_dim 64, pages of 16, a 64-page
    table over a 1024-page pool."""
    from bigdl_tpu_torch.ops.flash_attention import (
        paged_decode_attention, paged_decode_attention_ref)

    q, kp, vp, pt, lengths, _ = _paged_inputs(dev, False)
    S, h, d = q.shape
    P, page, nb = kp.shape[0], kp.shape[2], pt.shape[1]
    ln = torch.from_numpy(lengths.astype(np.int32)).to(dev)

    out = paged_decode_attention(q, kp, vp, pt, ln)
    again = paged_decode_attention(q, kp, vp, pt, ln)
    ref = paged_decode_attention_ref(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    _assert_bit_equal("paged_decode_attention", [out], [again])
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"paged_decode_attention disagrees with its "
                             f"plain version: max abs err {err}")

    ms = time_cold(lambda: paged_decode_attention(q, kp, vp, pt, ln), flush)
    plain_ms = time_cold(
        lambda: paged_decode_attention_ref(q, kp, vp, pt, ln), flush)
    # yardstick: one SDPA call over pre-gathered K/V with the length mask
    ptl = pt.long()
    kg = kp[ptl].permute(0, 2, 1, 3, 4).reshape(S, h, nb * page, d)
    vg = vp[ptl].permute(0, 2, 1, 3, 4).reshape(S, h, nb * page, d)
    mask = (torch.arange(nb * page, device=dev)[None, :]
            <= ln[:, None].long())[:, None, None, :]
    q4 = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(q4, kg, vg, attn_mask=mask)[:, :, 0]
    if not torch.allclose(lib, ref, rtol=RTOL, atol=ATOL):
        raise AssertionError("the SDPA yardstick disagrees with the plain "
                             "version")
    library_ms = time_cold(lambda: sdpa(q4, kg, vg, attn_mask=mask), flush)

    keys = int(np.minimum(lengths + 1, nb * page).sum())
    kv_bytes = 2 * keys * h * d * 4
    io_bytes = 2 * S * h * d * 4 + S * nb * 4 + S * 4
    flops = 4 * keys * h * d
    row = _share({"name": "paged_decode_attention", "route": "cuda",
                  "source": "bigdl_tpu_torch/ops/csrc/"
                            "paged_decode_attention.cu",
                  "replaces": "bigdl_tpu/ops/flash_attention.py:365",
                  "launches": None, "max_abs_err": err, "bit_equal": True,
                  "ms": ms, "plain_ms": plain_ms,
                  **_bound(kv_bytes + io_bytes, flops),
                  "library_ms": library_ms})
    emit({"phase": "kernel", "shape": {"slots": S, "heads": h,
                                       "head_dim": d, "page": page,
                                       "n_blocks": nb, "pages": P},
          "keys": keys, "bytes": kv_bytes + io_bytes, "flops": flops,
          "rtol": RTOL, "atol": ATOL, **row})
    return row


def _paged_inputs(dev, int8: bool):
    """The serving shapes' query, pools and table: 16 slots, 12 heads,
    head_dim 64, pages of 16, a 64-page row-strided table over 1024
    pages.  int8 pools are the per-page quantization of the float32
    ones."""
    from bigdl_tpu_torch.ops.quantized import quantize_pages

    S, h, d, page, nb = 16, 12, 64, 16, 64
    P = S * nb
    g = torch.Generator().manual_seed(SEED)
    q = torch.randn(S, h, d, generator=g).to(dev)
    kp = torch.randn(P, h, page, d, generator=g).to(dev)
    vp = torch.randn(P, h, page, d, generator=g).to(dev)
    rs = np.random.RandomState(SEED)
    lengths = rs.randint(0, nb * page, S)
    # empty-but-one, the last key of a page, the first of the next, full
    lengths[:4] = [0, page - 1, page, nb * page - 1]
    # the engine passes a row-strided slice of its wider table
    wide = np.zeros((S, nb + 16), np.int32)
    wide[:, :nb] = rs.permutation(P).reshape(S, nb)
    pt = torch.from_numpy(wide).to(dev)[:, :nb]
    sc = {}
    if int8:
        kp, ks = quantize_pages(kp)
        vp, vs = quantize_pages(vp)
        sc = dict(k_scales=ks, v_scales=vs)
    return q, kp, vp, pt, lengths, sc


def check_paged_decode_int8(dev, flush):
    """Kernel 2b: the paged decode kernel over int8 pages and per-page
    scales, at the serving shapes, against its plain version; the
    yardstick is dequantize-and-gather plus SDPA."""
    from bigdl_tpu_torch.ops.flash_attention import (
        _gather_pages, paged_decode_attention, paged_decode_attention_ref)

    q, kp, vp, pt, lengths, sc = _paged_inputs(dev, True)
    S, h, d = q.shape
    page, nb = kp.shape[2], pt.shape[1]
    ln = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    out = paged_decode_attention(q, kp, vp, pt, ln, **sc)
    again = paged_decode_attention(q, kp, vp, pt, ln, **sc)
    ref = paged_decode_attention_ref(q, kp, vp, pt, ln, **sc)
    torch.cuda.synchronize()
    _assert_bit_equal("paged_decode_attention int8", [out], [again])
    err = _assert_close("paged_decode_attention int8", out, ref, RTOL, ATOL)
    ms = time_cold(lambda: paged_decode_attention(q, kp, vp, pt, ln, **sc),
                   flush)
    plain_ms = time_cold(lambda: paged_decode_attention_ref(
        q, kp, vp, pt, ln, **sc), flush, reps=10)
    ptl = pt.long()
    mask = (torch.arange(nb * page, device=dev)[None, :]
            <= ln[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        kg = _gather_pages(kp, sc["k_scales"], ptl)
        vg = _gather_pages(vp, sc["v_scales"], ptl)
        return sdpa(q[:, :, None], kg, vg, attn_mask=mask)[:, :, 0]

    _assert_close("the dequantize + SDPA yardstick", library(), ref, RTOL,
                  ATOL)
    library_ms = time_cold(library, flush)
    keys = int(np.minimum(lengths + 1, nb * page).sum())
    kv_bytes = 2 * keys * h * d                          # int8 K and V
    io_bytes = 2 * S * h * d * 4 + S * nb * 4 + S * 4 + 2 * S * nb * 4
    flops = 4 * keys * h * d
    row = _share({"name": "paged_decode_attention_int8", "route": "cuda",
                  "source": "bigdl_tpu_torch/ops/csrc/"
                            "paged_decode_attention.cu",
                  "replaces": "bigdl_tpu/ops/flash_attention.py:213",
                  "launches": None, "max_abs_err": err, "bit_equal": True,
                  "ms": ms, "plain_ms": plain_ms,
                  **_bound(kv_bytes + io_bytes, flops),
                  "library_ms": library_ms})
    emit({"phase": "kernel", "shape": {"slots": S, "heads": h,
                                       "head_dim": d, "page": page,
                                       "n_blocks": nb, "pages": kp.shape[0],
                                       "pages_dtype": "int8"},
          "keys": keys, "bytes": kv_bytes + io_bytes, "flops": flops,
          "rtol": RTOL, "atol": ATOL, **row})
    return row


def check_paged_verify(dev, flush):
    """Kernel 3: the verify kernel at the serving shapes with a chunk of
    k+1 = 5 queries per slot ending at check_paged_decode's lengths, over
    float32 pages (the main path) and int8 pages; the yardstick is SDPA
    over the gathered pages with the staircase mask."""
    from bigdl_tpu_torch.ops.flash_attention import (
        _gather_pages, paged_verify_attention, paged_verify_attention_ref)

    C = VERIFY_CHUNK
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for int8 in (False, True):
        q1, kp, vp, pt, lengths, sc = _paged_inputs(dev, int8)
        S, h, d = q1.shape
        page, nb = kp.shape[2], pt.shape[1]
        g = torch.Generator().manual_seed(SEED + 1)
        q = torch.randn(S, h, C, d, generator=g).to(dev)
        pos_np = np.maximum(lengths - (C - 1), 0).astype(np.int32)
        pos = torch.from_numpy(pos_np).to(dev)
        out = paged_verify_attention(q, kp, vp, pt, pos, **sc)
        again = paged_verify_attention(q, kp, vp, pt, pos, **sc)
        ref = paged_verify_attention_ref(q, kp, vp, pt, pos, **sc)
        torch.cuda.synchronize()
        tag = "int8" if int8 else "f32"
        _assert_bit_equal(f"paged_verify_attention {tag}", [out], [again])
        err = _assert_close(f"paged_verify_attention {tag}", out, ref, RTOL,
                            ATOL)
        ms = time_cold(lambda: paged_verify_attention(q, kp, vp, pt, pos,
                                                      **sc), flush)
        plain_ms = time_cold(lambda: paged_verify_attention_ref(
            q, kp, vp, pt, pos, **sc), flush, reps=10)
        ptl = pt.long()
        key = torch.arange(nb * page, device=dev)
        lim = pos.long()[:, None] + torch.arange(C, device=dev)
        mask = (key[None, None, :] <= lim[:, :, None])[:, None]

        def library():
            kg = _gather_pages(kp, sc.get("k_scales"), ptl)
            vg = _gather_pages(vp, sc.get("v_scales"), ptl)
            return sdpa(q, kg, vg, attn_mask=mask)

        _assert_close("the SDPA yardstick", library(), ref, RTOL, ATOL)
        library_ms = time_cold(library, flush)
        visible = np.minimum(pos_np[:, None] + np.arange(1, C + 1),
                             nb * page)                  # keys per query
        keys = int(np.minimum(pos_np + C, nb * page).sum())
        kv_bytes = 2 * keys * h * d * (1 if int8 else 4)
        io_bytes = 2 * S * h * C * d * 4 + S * nb * 4 + S * 4
        flops = 4 * int(visible.sum()) * h * d
        rows[tag] = _share({
            "name": "paged_verify_attention", "route": "cuda",
            "source": "bigdl_tpu_torch/ops/csrc/paged_verify_attention.cu",
            "replaces": "bigdl_tpu/ops/flash_attention.py:514",
            "launches": None, "max_abs_err": err, "bit_equal": True,
            "ms": ms, "plain_ms": plain_ms,
            **_bound(kv_bytes + io_bytes, flops), "library_ms": library_ms})
        emit({"phase": "kernel", "shape": {"slots": S, "heads": h,
                                           "chunk": C, "head_dim": d,
                                           "page": page, "n_blocks": nb,
                                           "pages_dtype": tag},
              "keys": keys, "bytes": kv_bytes + io_bytes, "flops": flops,
              "rtol": RTOL, "atol": ATOL, **rows[tag]})
    row = dict(rows["f32"])
    row["int8_pages"] = {k: rows["int8"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "share")}
    return row


def check_block_sparse(dev, flush):
    """Kernel 5: the block-sparse product at the draft FFN's shapes —
    M = 16 (a decode step of 16 slots) and 256 (a prefill call of 4 x 64
    tokens), K/N = 768/3072 (l1) and 3072/768 (l2), blocks (8, 8) and
    (64, 64), half of the blocks kept — and its dx at M = 256, against
    the plain version, and twice on the same inputs for the same bits; the
    yardstick is ``torch.matmul`` of the masked weight.  Bounds by the
    tensor cores in 3xTF32 and by the CUDA cores.  The row reports the
    draft step's l1 at (8, 8)."""
    from bigdl_tpu_torch.ops.block_sparse import (ColumnPlan, _bs_raw,
                                                  block_sparse_matmul_ref)

    d, f = LM["hidden_size"], LM["ffn_size"]
    rs = np.random.RandomState(SEED)
    rows, worst = [], 0.0
    for blk in (SPARSE_BLOCK, (64, 64)):
        for k, n in ((d, f), (f, d)):
            nkb, nnb = -(-k // blk[0]), -(-n // blk[1])
            mask = np.zeros(nkb * nnb, bool)
            mask[rs.permutation(nkb * nnb)[: nkb * nnb // 2]] = True
            mask = mask.reshape(nkb, nnb)
            plan = ColumnPlan(mask, *blk)
            g = torch.Generator().manual_seed(SEED)
            w = torch.randn(k, n, generator=g).to(dev)
            wm = torch.where(plan.on(w.device, k, n)[2], w, 0.0)
            kept = int(mask.sum()) * blk[0] * blk[1]
            for m in (16, 256):
                x = torch.randn(m, k, generator=g).to(dev)
                out = _bs_raw(x, w, plan)
                again = _bs_raw(x, w, plan)
                ref = block_sparse_matmul_ref(x, w, plan)
                torch.cuda.synchronize()
                shape = {"m": m, "k": k, "n": n, "block": list(blk),
                         "density": float(mask.mean())}
                _assert_bit_equal(f"block_sparse_matmul {shape}", [out],
                                  [again])
                err = _assert_close(f"block_sparse_matmul {shape}", out,
                                    ref, RTOL, BS_ATOL)
                worst = max(worst, err)
                r = _share({
                    "shape": shape, "max_abs_err": err, "bit_equal": True,
                    "ms": time_cold(lambda: _bs_raw(x, w, plan), flush),
                    "plain_ms": time_cold(
                        lambda: block_sparse_matmul_ref(x, w, plan), flush),
                    "library_ms": time_cold(lambda: torch.matmul(x, wm),
                                            flush),
                    **_bound_3xtf32(4 * (m * k + kept + m * n),
                                    2 * m * kept)})
                if m == 256:
                    # dx = g @ (w masked)^T: the kernel on the transposed
                    # plan
                    go = torch.randn(m, n, generator=g).to(dev)
                    wt, tplan = w.t().contiguous(), plan.transposed()
                    dx = _bs_raw(go, wt, tplan)
                    dx_again = _bs_raw(go, wt, tplan)
                    dref = block_sparse_matmul_ref(go, wt, tplan)
                    torch.cuda.synchronize()
                    _assert_bit_equal(f"block_sparse_matmul dx {shape}",
                                      [dx], [dx_again])
                    derr = _assert_close(f"block_sparse_matmul dx {shape}",
                                         dx, dref, RTOL, BS_ATOL)
                    worst = max(worst, derr)
                    wmt = wm.t()
                    r["dx"] = _share({
                        "max_abs_err": derr, "bit_equal": True,
                        "ms": time_cold(lambda: _bs_raw(go, wt, tplan),
                                        flush),
                        "plain_ms": time_cold(lambda: block_sparse_matmul_ref(
                            go, wt, tplan), flush),
                        "library_ms": time_cold(
                            lambda: torch.matmul(go, wmt), flush),
                        **_bound_3xtf32(4 * (m * n + kept + m * k),
                                        2 * m * kept)})
                emit({"phase": "kernel", "name": "block_sparse_matmul",
                      "rtol": RTOL, "atol": BS_ATOL, **r})
                rows.append(r)
    main = rows[0]          # M = 16, l1 (768 -> 3072), blocks (8, 8)
    return {"name": "block_sparse_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/ops/csrc/block_sparse_matmul.cu",
            "replaces": "bigdl_tpu/ops/block_sparse.py:148",
            "launches": None, "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "bounds": main["bounds"], "share": main["share"],
            "shape": main["shape"],
            "m256": {k: rows[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "bounds", "share",
                                             "library_ms", "dx")}}


def _visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the attention computes for one (batch, head)."""
    if not causal:
        return sq * skv
    return int(np.minimum(np.arange(1, sq + 1), skv).sum())


def _assert_close(name, got, want, rtol, atol) -> float:
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs err {err}")
    return err


def check_flash(dev, flush):
    """The flash forward and backward kernels against their plain
    versions at the training shape (batch 8, 12 heads, 1024 tokens,
    head_dim 64, causal) and at ragged shapes with sq != skv, each launched
    twice for the same bits, then timed at the training shape.  Both
    bounds are by the tensor cores in 3xTF32, the CUDA-core one beside
    it."""
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref)

    h, d = LM["num_heads"], LM["hidden_size"] // LM["num_heads"]
    shapes = [(TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], True),
              (2, 200, 333, False), (2, 333, 200, True)]
    errs = {"fwd": 0.0, "bwd": 0.0}
    for b, sq, skv, causal in shapes:
        g = torch.Generator().manual_seed(SEED)
        q = torch.randn(b, h, sq, d, generator=g).to(dev)
        k = torch.randn(b, h, skv, d, generator=g).to(dev)
        v = torch.randn(b, h, skv, d, generator=g).to(dev)
        go = torch.randn(b, h, sq, d, generator=g).to(dev)
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        grads = flash_attention_bwd(q, k, v, out, lse, go, causal=causal)
        again = (*flash_attention_fwd(q, k, v, causal=causal),
                 *flash_attention_bwd(q, k, v, out, lse, go, causal=causal))
        ro, rl = flash_attention_fwd_ref(q, k, v, causal=causal,
                                         sm_scale=d ** -0.5)
        rgrads = flash_attention_bwd_ref(q, k, v, ro, rl, go, causal=causal,
                                         sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        tag = f"({b}, {h}, {sq}, {skv}, causal={causal})"
        _assert_bit_equal(f"flash {tag}", (out, lse, *grads), again)
        errs["fwd"] = max(errs["fwd"],
                          _assert_close(f"flash fwd out {tag}", out, ro,
                                        RTOL, ATOL),
                          _assert_close(f"flash fwd lse {tag}", lse, rl,
                                        RTOL, ATOL))
        for name, a, w in zip(("dq", "dk", "dv"), grads, rgrads):
            errs["bwd"] = max(errs["bwd"], _assert_close(
                f"flash bwd {name} {tag}", a, w, RTOL, BWD_ATOL))
        del q, k, v, go, out, lse, grads, again, ro, rl, rgrads

    # timing at the training shape
    b, s = TRAIN["batch"], TRAIN["seq"]
    g = torch.Generator().manual_seed(SEED)
    q, k, v, go = (torch.randn(b, h, s, d, generator=g).to(dev)
                   for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(q, k, v, is_causal=True)
    _assert_close("the SDPA yardstick", lib, out, RTOL, ATOL)
    fwd_ms = time_cold(lambda: flash_attention_fwd(q, k, v, causal=True),
                       flush)
    fwd_plain = time_cold(lambda: flash_attention_fwd_ref(
        q, k, v, causal=True, sm_scale=d ** -0.5), flush, reps=10)
    fwd_lib = time_cold(lambda: sdpa(q, k, v, is_causal=True), flush)
    bwd_ms = time_cold(lambda: flash_attention_bwd(
        q, k, v, out, lse, go, causal=True), flush)
    bwd_plain = time_cold(lambda: flash_attention_bwd_ref(
        q, k, v, out, lse, go, causal=True, sm_scale=d ** -0.5), flush,
        reps=10)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fb_lib = time_cold(lambda: torch.autograd.grad(
        sdpa(qr, kr, vr, is_causal=True), (qr, kr, vr), go), flush)

    pairs = b * h * _visible_pairs(s, s, True)
    elems = b * h * s * d
    fwd_flops = 4 * d * pairs
    fwd_bytes = 4 * (4 * elems + b * h * s)          # q k v out, lse
    bwd_flops = 2.5 * fwd_flops
    bwd_bytes = 4 * (8 * elems + b * h * s)  # q k v out g dq dk dv, lse
    shape = {"batch": b, "heads": h, "seq": s, "head_dim": d,
             "causal": True}
    rows = [
        _share({"name": "flash_attention_fwd", "route": "cuda",
                "source": "bigdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                "replaces": "bigdl_tpu/ops/flash_attention.py:109",
                "launches": None, "max_abs_err": errs["fwd"],
                "bit_equal": True, "ms": fwd_ms, "plain_ms": fwd_plain,
                **_bound_3xtf32(fwd_bytes, fwd_flops),
                "library_ms": fwd_lib}),
        _share({"name": "flash_attention_bwd", "route": "cuda",
                "source": "bigdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": "bigdl_tpu/ops/flash_attention.py:141",
                "launches": None, "max_abs_err": errs["bwd"],
                "bit_equal": True, "ms": bwd_ms, "plain_ms": bwd_plain,
                **_bound_3xtf32(bwd_bytes, bwd_flops),
                "library_ms": fb_lib - fwd_lib})]
    for row, flops, nbytes in ((rows[0], fwd_flops, fwd_bytes),
                               (rows[1], bwd_flops, bwd_bytes)):
        emit({"phase": "kernel", "shape": shape,
              "checked": [list(x) for x in shapes], "bytes": nbytes,
              "flops": flops, "rtol": RTOL,
              "atol": ATOL if row is rows[0] else BWD_ATOL, **row})
    return rows


def serve(dev):
    """Drive the serving main path once and check what comes out."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.serving import (DecodeConfig, DecodeRequest,
                                         InferenceModel)

    t0 = time.perf_counter()
    model = Transformer(**LM, dropout=0.0, seed=SEED)
    im = InferenceModel(model, decode=DecodeConfig(**DECODE), device=dev)
    try:
        im.warmup()
        setup_s = time.perf_counter() - t0
        rs = np.random.RandomState(SEED)
        prompts = [rs.randint(2, LM["vocab_size"], n).astype(np.int32)
                   for n in rs.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                       N_REQUESTS)]
        eng = im.decode_engine
        steps0 = eng.stats["steps"]
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        results = im.generate(prompts, return_results=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        steps = eng.stats["steps"] - steps0

        if len(results) != N_REQUESTS or any(
                r.finish_reason not in ("eos", "length") or len(r.tokens) < 1
                for r in results):
            raise AssertionError(f"not every request was answered: "
                                 f"{[r.finish_reason for r in results]}")
        if not all(np.isfinite(r.logp) for r in results):
            raise AssertionError("a request's log-prob is not finite")
        want = LM["num_layers"] * steps
        if steps < 1 or launches.get("paged_decode_attention", 0) != want:
            raise AssertionError(f"paged_decode_attention launched "
                                 f"{launches} times over {steps} decode "
                                 f"steps of {LM['num_layers']} layers")

        # every generated token against a full uncached forward of the
        # same model: finite logits, the token within 1e-3 of the top
        # logit, and the request's summed log-prob within 1e-3
        worst_gap, worst_logp = check_tokens(im, prompts, results, dev)
        if worst_gap > 1e-3 or worst_logp > 1e-3:
            raise AssertionError(f"served tokens disagree with the full "
                                 f"forward: logit gap {worst_gap}, logp "
                                 f"{worst_logp}")

        # continuous vs static decoding on the card: reported, not assumed
        static = eng.static_generate([DecodeRequest(tokens=p)
                                      for p in prompts])
        agree = sum(a.tokens.tolist() == b.tokens.tolist()
                    for a, b in zip(results, static))
        n_tok = int(sum(len(r.tokens) for r in results))
        emit({"phase": "serve", "model": LM, "decode": DECODE,
              "requests": len(results), "answered": len(results),
              "finish_reasons": sorted({r.finish_reason for r in results}),
              "prompt_tokens": int(sum(len(p) for p in prompts)),
              "generated_tokens": n_tok, "decode_steps": steps,
              "prefill_chunks": eng.stats["prefill_chunks"],
              "launches": launches, "nan_logits": False,
              "max_logit_gap": worst_gap, "max_logp_err": worst_logp,
              "static_agree": f"{agree}/{len(results)}",
              "kv_bytes_per_page": eng.kv_bytes_per_page(),
              "wall_s": wall, "tokens_per_s": n_tok / wall,
              "setup_s": setup_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30})
        emit({"phase": "profile", **profile_serving(im, prompts)})
        return launches, prompts, results, n_tok / wall
    finally:
        im.stop()


def check_tokens(im, prompts, results, dev, tol_fn=None):
    """Every generated token against a full uncached forward of the
    served model (its dequantized weights under ``weight_quant``).
    Returns (worst gap of a token's logit below the top logit, worst
    |summed log-prob - the forward's|).  With ``tol_fn(rows)`` — the
    allowed gap of each row of logits — a token past its row's
    allowance raises here."""
    worst_gap = worst_logp = 0.0
    with torch.no_grad(), im.weights():
        for p, r in zip(prompts, results):
            ids = np.concatenate([p, r.tokens[:-1]])
            logits = im.model(torch.from_numpy(ids)[None].to(dev))[0]
            if not torch.isfinite(logits).all():
                raise AssertionError("NaN or inf logit")
            rows = logits[len(p) - 1:]
            tok = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
            picked = rows.gather(1, tok[:, None])[:, 0]
            gaps = rows.max(dim=1).values - picked
            if tol_fn is not None and bool((gaps > tol_fn(rows)).any()):
                raise AssertionError(
                    f"a served token is {gaps.max().item()} below the top "
                    f"logit, past its tolerance "
                    f"{tol_fn(rows)[gaps.argmax()].item()}")
            lp = torch.log_softmax(rows, dim=1).gather(
                1, tok[:, None]).sum().item()
            worst_gap = max(worst_gap, gaps.max().item())
            worst_logp = max(worst_logp, abs(lp - r.logp))
    return worst_gap, worst_logp


def int8_gap_tolerance(rows):
    """How far below the top logit an int8-KV token may sit, per row of
    the reference logits, derived from the int8 step: a page's values
    are stored to within half a step, amax/254, so every attention input
    of a layer carries a relative error of at most 1/254 of its page's
    largest value.  Counting that error once per layer, undamped, the
    last hidden state's error is at most num_layers/254 of its scale,
    and so is each logit's error relative to the row's largest |logit|.
    The served token maximised the perturbed logits, so its reference
    logit sits at most twice that error below the top one:
    2 * num_layers / 254 * max|logit| of the row."""
    return 2 * LM["num_layers"] / 254.0 * rows.abs().amax(dim=1)


def _spec_launches_check(launches, steps, calls, k, name):
    """Hard check of a speculative run: every draft FFN of every draft
    step and draft prefill call went through the block-sparse kernel."""
    L = LM["num_layers"]
    want_bs = 2 * L * (k + 1) * steps + 2 * L * calls
    if launches.get("block_sparse_matmul", 0) != want_bs:
        raise AssertionError(f"{name}: block_sparse_matmul launched "
                             f"{launches.get('block_sparse_matmul', 0)} "
                             f"times, want {want_bs} (24 x {k + 1} x {steps} "
                             f"iterations + 24 x {calls} prefill calls)")
    return want_bs


def _serve_run(im, prompts):
    """One timed generate of ``prompts`` on ``im``: (results, wall s,
    launches, engine stats delta)."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches

    eng = im.decode_engine
    before = dict(eng.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    results = im.generate(prompts, return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    delta = {k: v - before.get(k, 0) for k, v in eng.stats.items()}
    if len(results) != len(prompts) or any(
            r.finish_reason not in ("eos", "length") or len(r.tokens) < 1
            or not np.isfinite(r.logp) for r in results):
        raise AssertionError(f"not every request was answered: "
                             f"{[r.finish_reason for r in results]}")
    return results, wall, launches, delta


def serve_spec(dev, prompts, ref_results, ref_tps):
    """Drive the speculative serving path once and check what comes
    out; then profile it."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import (DecodeConfig, InferenceModel,
                                         SpecConfig)

    t0 = time.perf_counter()
    model = Transformer(**LM, dropout=0.0, seed=SEED)
    im = InferenceModel(model, decode=DecodeConfig(
        **DECODE, speculative=SpecConfig(**SPEC)), device=dev)
    try:
        im.warmup()
        setup_s = time.perf_counter() - t0
        results, wall, launches, d = _serve_run(im, prompts)
        steps, calls = d["steps"], d["prefill_calls"]
        L = LM["num_layers"]
        if steps < 1 or launches.get("paged_verify_attention", 0) \
                != L * steps:
            raise AssertionError(f"paged_verify_attention launched "
                                 f"{launches} times over {steps} speculative "
                                 f"iterations of {L} layers")
        _spec_launches_check(launches, steps, calls, SPEC["k"],
                             "serve_spec")
        gap, dlogp = check_tokens(im, prompts, results, dev)
        if gap > 1e-3:
            raise AssertionError(f"speculative tokens disagree with the full "
                                 f"forward: logit gap {gap}")
        n_tok = int(sum(len(r.tokens) for r in results))
        agree = sum(a.tokens.tolist() == b.tokens.tolist()
                    for a, b in zip(results, ref_results))
        emit({"phase": "serve_spec", "spec": SPEC,
              "sparse_block": list(SPARSE_BLOCK), "requests": len(results),
              "answered": len(results), "generated_tokens": n_tok,
              "spec_iterations": steps, "prefill_calls": calls,
              "launches": launches, "max_logit_gap": gap,
              "max_logp_err": dlogp,
              "drafted": d["spec_drafted"], "accepted": d["spec_accepted"],
              "rejected": d["spec_rejected"],
              "accept_rate": d["spec_accepted"] / max(d["spec_drafted"], 1),
              "tokens_per_iteration": n_tok / max(steps, 1),
              "spec_off_agree": f"{agree}/{len(results)}",
              "wall_s": wall, "tokens_per_s": n_tok / wall,
              "spec_off_tokens_per_s": ref_tps, "setup_s": setup_s,
              "kv_bytes_per_page": im.decode_engine.kv_bytes_per_page(),
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30})
        emit({"phase": "spec_profile",
              **_profile(lambda: im.generate(prompts))})
        return launches
    finally:
        im.stop()


def serve_int8(dev, prompts, ref_results):
    """Int8 KV pages and int8 weights, spec off then on."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import (DecodeConfig, InferenceModel,
                                         SpecConfig)

    out = {}
    L = LM["num_layers"]
    for spec in (None, SpecConfig(**SPEC)):
        # the float32 model is not kept: the engine serves its int8 copy
        im = InferenceModel(Transformer(**LM, dropout=0.0, seed=SEED),
                            decode=DecodeConfig(**DECODE, kv_dtype="int8",
                                                speculative=spec),
                            device=dev, weight_quant="int8")
        try:
            im.warmup()
            results, wall, launches, d = _serve_run(im, prompts)
            steps = d["steps"]
            # spec off: one int8 decode launch per layer and step; spec on:
            # the scan verify runs k+1 decode-step bodies per iteration
            bodies = steps * (1 if spec is None else SPEC["k"] + 1)
            if steps < 1 or launches.get("paged_decode_attention_int8", 0) \
                    != L * bodies or launches.get("paged_decode_attention"):
                raise AssertionError(f"int8 decode launched {launches} "
                                     f"times over {bodies} decode bodies of "
                                     f"{L} layers")
            if spec is not None:
                _spec_launches_check(launches, steps, d["prefill_calls"],
                                     SPEC["k"], "serve_int8 spec")
            gap, dlogp = check_tokens(im, prompts, results, dev,
                                      int8_gap_tolerance)
            n_tok = int(sum(len(r.tokens) for r in results))
            agree = sum(a.tokens.tolist() == b.tokens.tolist()
                        for a, b in zip(results, ref_results))
            drift = [abs(a.logp - b.logp)
                     for a, b in zip(results, ref_results)
                     if a.tokens.tolist() == b.tokens.tolist()]
            tag = "spec" if spec is not None else "plain"
            w8 = im.decode_engine.adapter._w8
            row = {"phase": "serve_int8", "speculative": spec is not None,
                   "requests": len(results), "answered": len(results),
                   "generated_tokens": n_tok, "iterations": steps,
                   "launches": launches, "max_logit_gap": gap,
                   "gap_tolerance": f"2 * {L} / 254 * max|logit| of the row",
                   "max_logp_err_vs_forward": dlogp,
                   "f32_agree": f"{agree}/{len(results)}",
                   "logp_drift_max": max(drift) if drift else None,
                   "logp_drift_mean": float(np.mean(drift)) if drift
                   else None,
                   "kv_bytes_per_page": im.decode_engine.kv_bytes_per_page(),
                   "weight_bytes_at_rest": w8.nbytes(),
                   "wall_s": wall, "tokens_per_s": n_tok / wall,
                   "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                   / 2**30}
            if spec is not None:
                row.update(drafted=d["spec_drafted"],
                           accepted=d["spec_accepted"],
                           accept_rate=d["spec_accepted"]
                           / max(d["spec_drafted"], 1))
            emit(row)
            out[tag] = launches
        finally:
            im.stop()
    return out


def profile_serving(im, prompts) -> dict:
    """The same requests once more under torch.profiler.  The counts of
    the main run were read before this."""
    return _profile(lambda: im.generate(prompts))


def _profile(fn, named=()) -> dict:
    """``fn()`` under torch.profiler: the device's busy share of the wall
    time and its time by kernel; for each substring in ``named``, the
    device time and share of the kernels whose names hold it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = {"wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "device_kernels": len(kernels),
           "top": [{"kernel": e.key[:80], "calls": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in top]}
    for sub in named:
        us = sum(e.self_device_time_total for e in kernels if sub in e.key)
        out.setdefault("named", {})[sub] = {
            "device_ms": us / 1e3, "calls": sum(e.count for e in kernels
                                                if sub in e.key),
            "share_of_device_time": us / busy_us if busy_us else 0.0}
    return out


def _train_data():
    rs = np.random.RandomState(SEED)
    shape = (TRAIN["batch"], TRAIN["seq"])
    ids = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    tgt = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    return ids, tgt


def grad_check(model, ids, tgt, dev) -> dict:
    """One batch's gradients of every parameter with the flash kernels
    (``use_flash=None``, auto on CUDA) against plain attention
    (``use_flash=False``), on the same weights."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, MultiHeadAttention

    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    x = torch.from_numpy(ids).to(dev)
    y = torch.from_numpy(tgt).to(dev)
    model.to(dev).train(True)

    def grads(use_flash):
        for m in mhas:
            m.use_flash = use_flash
        model.zero_grad(set_to_none=True)
        loss = CrossEntropyCriterion()(model(x), y)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    try:
        loss_f, g_f = grads(None)
        loss_p, g_p = grads(False)
    finally:
        for m in mhas:
            m.use_flash = None
        model.zero_grad(set_to_none=True)
        model.train(False)
    total = torch.sqrt(sum(g.square().sum() for g in g_p.values())).item()
    rel, floored = {}, {}
    for n in g_p:
        diff = (g_f[n] - g_p[n]).norm().item()
        norm = g_p[n].norm().item()
        rel[n] = diff / norm if norm > 0 else float("inf")
        floored[n] = diff / (norm + GRAD_FLOOR * total)
    worst = max(floored, key=floored.get)
    others = {n: e for n, e in rel.items() if not n.endswith("attn.bk")}
    worst_other = max(others, key=others.get)
    out = {"loss_flash": loss_f, "loss_plain": loss_p,
           "params": len(g_p), "grad_norm": total, "rtol": GRAD_RTOL,
           "floor": GRAD_FLOOR, "worst_param": worst,
           "worst_err": floored[worst],
           "key_bias_max_rel_err": max(e for n, e in rel.items()
                                       if n.endswith("attn.bk")),
           "worst_other_param": worst_other,
           "worst_other_rel_err": others[worst_other]}
    emit({"phase": "gradcheck", **out})
    if floored[worst] > GRAD_RTOL or abs(loss_f - loss_p) > 1e-5 * abs(
            loss_p):
        raise AssertionError(f"flash gradients disagree with plain "
                             f"attention: {out}")
    return out


def train(dev):
    """Drive the training main path once and check what comes out."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    ids, tgt = _train_data()
    model = Transformer(**LM, dropout=0.0, seed=SEED)
    grad_check(model, ids, tgt, dev)

    events = {}
    steps = TRAIN["steps"]
    opt = (Optimizer(model, DataSet.array(ids, tgt), CrossEntropyCriterion(),
                     batch_size=TRAIN["batch"], device=dev)
           .set_optim_method(Adam(learning_rate=TRAIN["lr"]))
           .set_end_when(Trigger.or_(_step_clock(events),
                                     Trigger.max_iteration(steps))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    trained = opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    losses = opt.losses
    step_ms = _step_ms(events, 0, steps)
    med = float(np.median(step_ms[1:]))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    want = LM["num_layers"] * steps
    out = {"phase": "train", "model": LM, "train": TRAIN,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / med * 1e3, "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
           "launches": launches}
    emit(out)
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv"):
        if launches.get(name, 0) != want:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} "
                                 f"times over {steps} steps of "
                                 f"{LM['num_layers']} layers")

    def run(n, end=None):
        return (Optimizer(model, DataSet.array(ids, tgt),
                          CrossEntropyCriterion(),
                          batch_size=TRAIN["batch"], device=dev)
                .set_optim_method(Adam(learning_rate=TRAIN["lr"]))
                .set_end_when(end or Trigger.max_iteration(n)).optimize())

    emit({"phase": "train_profile", "steps": 2,
          **_profile(lambda: run(2))})

    # A/B: the same steps with BIGDL_TPU_FLASH=0, the kill switch that
    # sends the auto path to plain attention; no flash kernel may launch
    events.clear()
    os.environ["BIGDL_TPU_FLASH"] = "0"
    try:
        reset_launches()
        run(4, Trigger.or_(_step_clock(events), Trigger.max_iteration(4)))
        torch.cuda.synchronize()
        plain_launches = dict(LAUNCHES)
    finally:
        del os.environ["BIGDL_TPU_FLASH"]
    plain_ms = _step_ms(events, 0, 4)
    emit({"phase": "train_plain_attention", "flash_env": "0",
          "step_ms": plain_ms,
          "median_step_ms": float(np.median(plain_ms[1:])),
          "flash_median_step_ms": med, "launches": plain_launches})
    if any(plain_launches.values()):
        raise AssertionError(f"BIGDL_TPU_FLASH=0 still launched "
                             f"{plain_launches}")
    return launches, trained


def evaluate_lm(dev, trained):
    """``TrainedModel.evaluate`` of the trained LM on held-out batches,
    with the flash forward and with plain attention."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, MultiHeadAttention
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.optim import Loss

    rs = np.random.RandomState(SEED + 1)
    shape = (EVAL_LM_BATCHES * TRAIN["batch"], TRAIN["seq"])
    ids = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    tgt = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    held_out = DataSet.array(ids, tgt)
    mhas = [m for m in trained.model.modules()
            if isinstance(m, MultiHeadAttention)]

    def run(use_flash):
        for m in mhas:
            m.use_flash = use_flash
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        (res,) = trained.evaluate(held_out, [Loss(CrossEntropyCriterion())],
                                  batch_size=TRAIN["batch"])
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, dict(LAUNCHES)

    try:
        flash, flash_ms, launches = run(None)
        plain, plain_ms, plain_launches = run(False)
    finally:
        for m in mhas:
            m.use_flash = None
    want = LM["num_layers"] * EVAL_LM_BATCHES
    out = {"phase": "evaluate_lm", "batches": EVAL_LM_BATCHES,
           "rows": flash.count, "loss_flash": flash.result,
           "loss_plain": plain.result,
           "abs_err": abs(flash.result - plain.result), "atol": EVAL_LM_ATOL,
           "flash_ms": flash_ms, "plain_ms": plain_ms,
           "launches": launches, "plain_launches": plain_launches}
    emit(out)
    if launches.get("flash_attention_fwd", 0) != want or any(
            v for k, v in launches.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"evaluate launched {launches}, want "
                             f"{want} flash forwards and nothing else")
    if any(plain_launches.values()):
        raise AssertionError(f"plain evaluate launched {plain_launches}")
    if (flash.count != EVAL_LM_BATCHES * TRAIN["batch"]
            or not np.isfinite(flash.result)
            or abs(flash.result - plain.result) > EVAL_LM_ATOL):
        raise AssertionError(f"evaluate with the flash forward disagrees "
                             f"with plain attention: {out}")
    return launches


def _step_clock(events):
    """An end-when trigger that records a CUDA event at each iteration
    edge the training loop reaches: step i is the device time between
    edges i-1 and i (no host sync); validation and checkpoints run
    before the edge of their iteration, outside the next step."""
    from bigdl_tpu_torch.optim import Trigger

    def tick(state):
        it = state["iteration"]
        if it not in events:
            events[it] = torch.cuda.Event(enable_timing=True)
            events[it].record()
        return False

    return Trigger(tick, "step clock")


def _step_ms(events, first, last):
    """Device ms of steps first+1 .. last from ``_step_clock``'s events."""
    return [events[i - 1].elapsed_time(events[i])
            for i in range(first + 1, last + 1)]


def lenet_data():
    rs = np.random.RandomState(SEED)
    c = LENET_TRAIN
    templates = rs.rand(10, 28, 28, 1).astype(np.float32)

    def draw(n):
        y = rs.randint(0, 10, n).astype(np.int32)
        noise = rs.randn(n, 28, 28, 1).astype(np.float32) * c["noise"]
        return templates[y] + noise, y

    return draw(c["train"]), draw(c["val"])


def train_lenet(dev):
    """LeNet-5 through ``Optimizer.optimize()`` with validation, EMA and
    gradient accumulation; the last validation and the EMA weights must
    both classify the held-out set."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import (Adam, Loss, Optimizer, Top1Accuracy,
                                       Trigger)

    c = LENET_TRAIN
    (x, y), (xv, yv) = lenet_data()
    val = DataSet.array(xv, yv)
    events = {}
    opt = (Optimizer(LeNet5(10, generator=torch.Generator().manual_seed(
        SEED)), DataSet.array(x, y), CrossEntropyCriterion(),
        batch_size=c["batch"], device=dev)
        .set_optim_method(Adam(learning_rate=c["lr"]))
        .set_end_when(Trigger.or_(_step_clock(events),
                                  Trigger.max_epoch(c["epochs"])))
        .set_validation(Trigger.every_epoch(), val,
                        [Top1Accuracy(), Loss()]))
    opt.accum_steps = c["accum"]
    opt.ema_decay = c["ema"]
    t0 = time.perf_counter()
    trained = opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = opt.final_state["iteration"]
    step_ms = _step_ms(events, 0, steps)
    vals = [{"iteration": it, **{r.name: r.result for r in res}}
            for it, res in opt.validations]
    trained.set_variables(trained.ema_variables)
    (ema_top1,) = trained.evaluate(val, [Top1Accuracy()])
    out = {"phase": "train_lenet", "config": c, "steps": steps,
           "wall_s": wall, "median_step_ms": float(np.median(step_ms[2:])),
           "images_per_s": c["batch"] / float(np.median(step_ms[2:])) * 1e3,
           "first_loss": opt.losses[0], "last_loss": opt.losses[-1],
           "validations": vals, "ema_top1": ema_top1.result}
    emit(out)
    if len(vals) != c["epochs"] or not np.all(np.isfinite(opt.losses)):
        raise AssertionError(f"LeNet-5 training went wrong: {out}")
    if vals[-1]["Top1Accuracy"] <= c["min_top1"] or \
            ema_top1.result <= c["min_top1"]:
        raise AssertionError(f"LeNet-5 top-1 at or below {c['min_top1']}: "
                             f"{out}")
    return out


def resnet_train_data():
    """Random NHWC images and labels from seed 0 (train, then
    validation), drawn in float32."""
    c = RESNET_TRAIN
    rng = np.random.default_rng(SEED)
    n = c["train"] + c["val"]
    x = rng.standard_normal((n,) + IMAGE, dtype=np.float32)
    y = rng.integers(0, 1000, n).astype(np.int32)
    return (x[:c["train"]], y[:c["train"]]), (x[c["train"]:], y[c["train"]:])


def _resnet_recipe():
    from bigdl_tpu_torch.optim import SGD, MultiStep, SequentialSchedule, \
        Warmup

    c = RESNET_TRAIN
    schedule = (SequentialSchedule()
                .add(Warmup(c["lr"] / c["warmup"]), c["warmup"])
                .add(MultiStep([c["milestone"]], 0.1), 10 ** 9))
    return SGD(learning_rate=c["lr"], momentum=0.9, weight_decay=5e-4,
               nesterov=True, learning_rate_schedule=schedule)


def _resnet_optimizer(dev, data, end, **attrs):
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.models import resnet50
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer

    model = resnet50(classes=1000, stem="conv",
                     generator=torch.Generator().manual_seed(SEED))
    opt = (Optimizer(model, DataSet.array(*data), CrossEntropyCriterion(),
                     batch_size=RESNET_TRAIN["batch"], device=dev)
           .set_optim_method(_resnet_recipe()).set_end_when(end))
    for k, v in attrs.items():
        setattr(opt, k, v)
    return opt


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _profile_train(fn) -> dict:
    """``fn()`` under torch.profiler: the device's busy share, and its
    time split into cuDNN / cuBLAS convolutions and products, the
    optimizer update (the ``train_step/update`` range: clipping, SGD,
    EMA), and the rest (BatchNorm, ReLU, adds, pools, the loss,
    copies)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "train_step/update"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    conv_words = ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad",
                  "implicit", "cutlass", "sm90")
    conv_ms = sum(e.self_device_time_total for e in kernels
                  if any(w in e.key.lower() for w in conv_words)) / 1e3
    update_ms = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.key == "train_step/update") / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_s": wall, "device_busy_s": busy_ms / 1e3,
            "device_busy_share": busy_ms / 1e3 / wall,
            "device_ms_by_group": {
                "conv_and_matmul": conv_ms, "optimizer_update": update_ms,
                "rest": busy_ms - conv_ms - update_ms},
            "top": [{"kernel": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}


def train_resnet(dev, data):
    """ResNet-50 through ``Optimizer.optimize()``: checkpoints, a resume
    that continues the epoch, validation, and the resumed steps held to
    an uninterrupted run's."""
    import tempfile

    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.optim import (Loss, Top1Accuracy, Top5Accuracy,
                                       TrainStep, Trigger, checkpoint)

    c = RESNET_TRAIN
    (x, y), (xv, yv) = data
    tmp = tempfile.mkdtemp(prefix="resnet_ckpt_")
    every = Trigger.several_iteration(c["ckpt_every"])
    try:
        # run 1: 6 steps, checkpoints at 3 and 6
        first = _resnet_optimizer(dev, (x, y),
                                  Trigger.max_iteration(c["first"]))
        first.set_checkpoint(tmp, every)
        trained1 = first.optimize()
        latest = checkpoint.latest_checkpoint(tmp)
        ckpt_bytes = _dir_bytes(latest)
        # the checkpoint's costs, on run 1's model with SGD's slots
        step = TrainStep(trained1.model, None, _resnet_recipe())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = step.checkpoint_arrays()
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(os.path.join(tmp, "sync"), 0, **arrays)
        sync_ms = (time.perf_counter() - t0) * 1e3
        writer = checkpoint.AsyncCheckpointer()
        t0 = time.perf_counter()
        writer.submit(os.path.join(tmp, "async"), 0, **arrays)
        submit_ms = (time.perf_counter() - t0) * 1e3
        writer.wait()
        async_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = checkpoint.load_checkpoint(latest)
        step.restore(*loaded[:3], loaded[4])
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t0) * 1e3
        del step, arrays, loaded, trained1, first
        # run 2: a fresh Optimizer on the same directory resumes at 6
        second = _resnet_optimizer(dev, (x, y),
                                   Trigger.max_iteration(c["steps"]))
        second.set_checkpoint(tmp, every)
        second.set_validation(Trigger.several_iteration(c["val_every"]),
                              DataSet.array(xv, yv),
                              [Top1Accuracy(), Top5Accuracy(), Loss()])
        t0 = time.perf_counter()
        second.optimize()
        resumed_wall = time.perf_counter() - t0
        resumed = second.losses
        vals = [{"iteration": it, **{r.name: r.result for r in res}}
                for it, res in second.validations]
        del second
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    # run 3: the same 10 steps uninterrupted, timed
    torch.cuda.empty_cache()
    events = {}
    third = _resnet_optimizer(dev, (x, y), Trigger.or_(
        _step_clock(events), Trigger.max_iteration(c["steps"])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    third.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    full = third.losses
    step_ms = _step_ms(events, 0, c["steps"])
    med = float(np.median(step_ms[2:]))
    # the same steps with cuDNN's default algorithm choice (the checks
    # above pin it to deterministic algorithms)
    events_default = {}
    torch.backends.cudnn.deterministic = False
    try:
        _resnet_optimizer(dev, (x, y), Trigger.or_(
            _step_clock(events_default),
            Trigger.max_iteration(c["default_steps"]))).optimize()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = True
    med_default = float(np.median(
        _step_ms(events_default, 0, c["default_steps"])[2:]))
    # two steps of an Optimizer built beforehand under the profiler; the busy
    # share of a step is their kernel time a step over run 3's median step
    profiled = _resnet_optimizer(dev, (x, y), Trigger.max_iteration(2))
    prof = _profile_train(profiled.optimize)
    del profiled
    busy = prof["device_busy_s"] * 1e3 / 2 / med
    tail = full[c["first"]:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, tail))
    bound_ms = RESNET_TRAIN_FLOPS / F32_FLOPS * 1e3
    out = {"phase": "train_resnet", "config": c,
           "cudnn_deterministic": torch.backends.cudnn.deterministic,
           "losses": full, "resumed_losses": resumed,
           "resume_max_rel_err": rel, "resume_rtol": RESUME_RTOL,
           "step_ms": step_ms, "median_step_ms": med,
           "images_per_s": c["batch"] / med * 1e3,
           "median_step_ms_cudnn_default": med_default,
           "images_per_s_cudnn_default": c["batch"] / med_default * 1e3,
           "bound_ms": bound_ms, "bound_by": "operations",
           "share_of_bound": bound_ms / med, "busy_share": busy,
           "wall_s": wall,
           "resumed_wall_s": resumed_wall,
           "peak_mem_gb": peak / 2**30,
           "checkpoint_bytes": ckpt_bytes, "snapshot_ms": snapshot_ms,
           "write_ms_sync": sync_ms, "async_submit_ms": submit_ms,
           "async_write_ms": async_ms, "resume_ms": resume_ms,
           "validations": vals, "profile_2_steps": prof}
    emit(out)
    if len(full) != c["steps"] or not np.all(np.isfinite(full)) or \
            len(resumed) != c["steps"] - c["first"] or \
            not np.all(np.isfinite(resumed)):
        raise AssertionError(f"ResNet-50 losses: {full} / {resumed}")
    if rel > RESUME_RTOL:
        raise AssertionError(f"resumed steps differ from the uninterrupted "
                             f"run by {rel} relative: {resumed} / {tail}")
    if [v["iteration"] for v in vals] != [c["steps"]] or not all(
            np.isfinite(v[k]) for v in vals for k in v):
        raise AssertionError(f"ResNet-50 validation: {vals}")
    return out


def train_resnet_remat(dev, data):
    """Six ResNet-50 steps with remat against six without: peak memory,
    step time (the median after the first two), and the BatchNorm
    running buffers after the steps."""
    from bigdl_tpu_torch.optim import Trigger

    c = RESNET_TRAIN
    runs = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        events = {}
        opt = _resnet_optimizer(dev, data[0], Trigger.or_(
            _step_clock(events), Trigger.max_iteration(c["remat_steps"])),
            remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        trained = opt.optimize()
        torch.cuda.synchronize()
        step_ms = _step_ms(events, 0, c["remat_steps"])
        runs[remat] = {
            "losses": opt.losses, "step_ms": step_ms,
            "median_step_ms": float(np.median(step_ms[2:])),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            "buffers": {n: b.detach().clone() for n, b in
                        trained.model.named_buffers()}}
    err = max((runs[True]["buffers"][n] - b).abs().max().item()
              for n, b in runs[False]["buffers"].items())
    out = {"phase": "train_resnet_remat", "steps": c["remat_steps"],
           "bn_buffers": len(runs[False]["buffers"]),
           "bn_max_abs_err": err, "atol": REMAT_BN_ATOL,
           **{("remat" if k else "plain"): {
               n: v for n, v in r.items() if n != "buffers"}
              for k, r in runs.items()}}
    emit(out)
    if err > REMAT_BN_ATOL or not np.all(np.isfinite(runs[True]["losses"])):
        raise AssertionError(f"remat moved the BatchNorm buffers: {out}")
    return out


def resnet_model():
    """ResNet-50 (stem "conv", 1000 classes) on the CPU, random weights
    from ``torch.Generator`` seed 0, every BatchNorm redrawn from it
    (weight U(0.5, 1.5), bias N(0, 0.1), running mean N(0, 0.1), running
    variance U(0.5, 1.5)): at init the last BN of every block is 0
    (``gamma_zero``), which would make every residual body output 0 and
    let a check pass without its convs."""
    from bigdl_tpu_torch.models import resnet50
    from bigdl_tpu_torch.nn import BatchNorm

    g = torch.Generator().manual_seed(SEED)
    model = resnet50(classes=1000, stem="conv", generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def int8_shapes(model, batch, dev):
    """(M, K, N) of each int8 product of one forward of ``model`` at
    ``batch`` images, in order, from hooks on its float Conv2D / Linear
    leaves (one float forward on the card)."""
    from bigdl_tpu_torch.nn import Conv2D, Linear

    shapes = []

    def hook(m, inp, out):
        rows = out.numel() // out.shape[-1]
        if isinstance(m, Linear):
            shapes.append((rows, m.in_features, m.out_features))
        else:
            kh, kw = m.kernel_size
            shapes.append((rows, kh * kw * m.in_channels // m.groups,
                           m.out_channels))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv2D, Linear))]
    try:
        with torch.no_grad():
            model.to(dev)(torch.zeros(batch, *IMAGE, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def _int8_bound(m, k, n, scale_bytes=0):
    """(operations, bytes) bounds in ms of an (M, K) x (K, N) int8
    product: each operand read once, the 4-byte output written once,
    plus the epilogue's scale vectors."""
    t_ops = 2 * m * k * n / INT8_OPS * 1e3
    t_bytes = (m * k + k * n + 4 * m * n + scale_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return t_ops, t_bytes


def _int8_operands(dev, g, m, k, n):
    """Random int8 x (M, K) in rows padded to 16 bytes, as
    ``quantize_activations`` hands them to the kernel, and a K-major
    weight (N, K), with the fused epilogue's per-row sx, sw and bias."""
    from bigdl_tpu_torch.ops.common import round_up

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int16).to(torch.int8)

    x = rand_i8(m, round_up(k, 16))[:, :k]
    w_nk = rand_i8(n, k)
    sx = torch.rand(m, device=dev, generator=g) * 0.05 + 1e-3
    sw = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4
    bias = torch.randn(n, device=dev, generator=g) * 0.1
    return x, w_nk, sx, sw, bias


def _check_int8_epilogue(name, x, w_nk, acc, sx, sw, bias):
    """The fused epilogue bit-equal to the plain tail on the same
    payloads, in the three activation modes (per row, scalar, none) and
    with and without bias; ``acc`` is the plain int32 product."""
    from bigdl_tpu_torch.ops.quantized import int8_matmul_nk, rescale_plain

    for sxm in (sx[:, None], sx[:1].reshape(()), None):
        for b in (bias, None):
            got = int8_matmul_nk(x, w_nk, sw, sxm, b)
            want = rescale_plain(acc, sxm, sw, b)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name}: the fused epilogue differs from the plain "
                    f"tail (sx {None if sxm is None else tuple(sxm.shape)}, "
                    f"bias {b is not None}): max "
                    f"{(got - want).abs().max().item()}")


def check_int8_matmul(dev, flush, resnet_shapes):
    """Kernel 4: the int8 matmul against its plain version, EXACTLY, at
    every distinct (M, K, N) of one ResNet-50 forward at bucket 16, at
    the split-K shapes of buckets 1, 4 and 64, at LeNet-5's ragged shapes
    (batch 16) and at M = 1; at each, the fused epilogue bit-equal to the
    plain tail in its three activation modes, and the same bits twice.
    The main path's launch (K-major weight, x in 16-byte rows, the fused
    rescale with per-row sx, no bias) is timed at the bucket-16 shapes
    beside its bound, its plain version (float64 GEMM and the plain tail)
    and ``torch._int_mm`` (the int32 product alone; it needs M > 16 and
    K, N multiples of 8: its operands are zero-padded to that, and its
    result checked too); the int32 entry's time stands beside it.  The
    row is the sum over the 54 calls of the bucket-16 forward."""
    from collections import Counter

    from bigdl_tpu_torch.ops.common import round_up
    from bigdl_tpu_torch.ops.quantized import (int8_matmul, int8_matmul_nk,
                                               int8_matmul_plain, int8_plan,
                                               rescale_plain)

    counts = Counter(resnet_shapes)
    # the products of buckets 1, 4 and 64 whose plan splits K (M scales
    # with the bucket)
    split = sorted({(m * b // 16, k, n) for m, k, n in counts
                    for b in (1, 4, 64)
                    if int8_plan(m * b // 16, k, n)[2] > 1} - set(counts))
    lenet = list(LENET_INT8_SHAPES)
    single = [(1, 147, 64), (1, 2048, 1000)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    per_shape = {}
    for m, k, n in dict.fromkeys(list(counts) + split + lenet + single):
        x, w_nk, sx, sw, bias = _int8_operands(dev, g, m, k, n)
        xc, w = x.contiguous(), w_nk.t().contiguous()   # (K, N) row-major
        out = int8_matmul_nk(x, w_nk)
        again = int8_matmul_nk(x, w_nk)
        public = int8_matmul(xc, w)
        ref = int8_matmul_plain(xc, w)
        torch.cuda.synchronize()
        wrong = int((out != ref).sum().item())
        if wrong or out.dtype != torch.int32 or not torch.equal(public, ref):
            raise AssertionError(f"int8_matmul ({m}, {k}, {n}) disagrees with "
                                 f"its plain version in {wrong} of {m * n} "
                                 f"outputs (public entry equal: "
                                 f"{torch.equal(public, ref)})")
        _assert_bit_equal(f"int8_matmul ({m}, {k}, {n})", [out], [again])
        _check_int8_epilogue(f"int8_matmul ({m}, {k}, {n})", x, w_nk, ref,
                             sx, sw, bias)
        r = {"shape": [m, k, n], "calls": counts.get((m, k, n), 0),
             "plan": list(int8_plan(m, k, n)),
             "max_abs_err": (out - ref).abs().max().item(),
             "fused_bit_equal": True}
        if (m, k, n) in counts:
            sxm = sx[:, None]
            mp, kp, np_ = max(m, 17), round_up(k, 8), round_up(n, 8)
            xp = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
            wp = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
            xp[:m, :k] = xc
            wp[:k, :n] = w
            lib = torch._int_mm(xp, wp)[:m, :n]
            torch.cuda.synchronize()
            if not torch.equal(lib, ref):
                raise AssertionError(f"torch._int_mm ({m}, {k}, {n}) "
                                     f"disagrees with the plain version")
            t_ops, t_bytes = _int8_bound(m, k, n, 4 * (m + n))
            s_ops, s_bytes = _int8_bound(m, k, n)
            r.update({
                "ms": time_cold(lambda: int8_matmul_nk(x, w_nk, sw, sxm),
                                flush),
                "plain_ms": time_cold(lambda: rescale_plain(
                    int8_matmul_plain(xc, w), sxm, sw), flush, reps=10),
                "library_ms": time_cold(lambda: torch._int_mm(xp, wp),
                                        flush),
                "library_padded_to": [mp, kp, np_],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "s32_ms": time_cold(lambda: int8_matmul_nk(x, w_nk), flush),
                "s32_plain_ms": time_cold(lambda: int8_matmul_plain(xc, w),
                                          flush, reps=10),
                "s32_bound_ms": max(s_ops, s_bytes)})
            r["tops"] = 2 * m * k * n / r["ms"] / 1e9
            del xp, wp, lib
        per_shape[(m, k, n)] = r
        emit({"phase": "kernel", "name": "int8_matmul", "exact": True, **r})
        del x, w_nk, xc, w, out, again, public, ref

    def total(key, shapes):
        return sum(per_shape[s][key] * c for s, c in shapes.items())

    by = Counter()
    for s, c in counts.items():
        by[per_shape[s]["bound_by"]] += per_shape[s]["bound_ms"] * c
    return _share({
            "name": "int8_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/ops/csrc/int8_matmul.cu",
            "replaces": "bigdl_tpu/ops/quantized.py:156",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
            "bit_equal": True,
            "ms": total("ms", counts), "plain_ms": total("plain_ms", counts),
            "bound_ms": total("bound_ms", counts),
            "bound_by": by.most_common(1)[0][0],
            "library_ms": total("library_ms", counts),
            "library": "torch._int_mm, the int32 product alone",
            "s32": {"ms": total("s32_ms", counts),
                    "plain_ms": total("s32_plain_ms", counts),
                    "bound_ms": total("s32_bound_ms", counts)},
            "work": f"the {sum(counts.values())} int8 products of one "
                    f"ResNet-50 forward at bucket 16 "
                    f"({len(counts)} distinct shapes) as the main path "
                    f"launches them (K-major weight, fused rescale), summed",
            "checked_shapes": len(per_shape)})


def _profile_groups(fn) -> dict:
    """``_profile`` of ``fn`` with the device time split into the int8
    kernel (its tiles and its split-K sums, the output rescale fused in),
    the port's profiler ranges ``int8_im2col`` (patch gather) and
    ``int8_quantize_activations`` (abs-max, divide, round, clamp, cast),
    and the rest (BN, ReLU, adds, cuDNN convs, copies)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = ("int8_im2col", "int8_quantize_activations")
    events = prof.key_averages()
    # a range also shows as a device-side annotation spanning its
    # kernels: not a kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in names]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the host-side range: the device time of the kernels launched in it
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.key in names}
    groups = {"int8_matmul": sum(e.self_device_time_total for e in kernels
                                 if "int8_matmul_kernel" in e.key
                                 or "int8_splitk_reduce_kernel" in e.key)
              / 1e3,
              "im2col": ranges.get("int8_im2col", 0.0),
              "quantize_activations": ranges.get(
                  "int8_quantize_activations", 0.0)}
    groups["rest"] = busy_ms - sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy_ms / 1e3,
            "device_busy_share": busy_ms / 1e3 / wall,
            "device_ms_by_group": groups,
            "top": [{"kernel": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}


def serve_resnet(dev, model):
    """Serve ResNet-50 through ``InferenceModel.predict``, float32 and
    int8: requests of 1, 3, 16 and 50 images (buckets 1, 4, 16, 64), then
    20 requests of 64.  Float32 answers are held to a direct forward of
    the same rows, int8 answers to the float32 ones; every int8 bucket
    call goes through 54 launches of the int8 kernel and the plain
    version never runs.  Then a profile of each."""
    from bigdl_tpu_torch.nn import Conv2D, Linear
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.ops import quantized as q8
    from bigdl_tpu_torch.serving import InferenceModel

    t0 = time.perf_counter()
    ims = {"float32": InferenceModel(model, device=dev,
                                     batch_buckets=RESNET_BUCKETS),
           "int8": InferenceModel(model, device=dev, weight_quant="int8",
                                  batch_buckets=RESNET_BUCKETS)}
    rs = np.random.RandomState(SEED)
    sample = rs.randn(1, *IMAGE).astype(np.float32)
    for im in ims.values():
        im.warmup(sample)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    requests = [rs.randn(n, *IMAGE).astype(np.float32)
                for n in RESNET_REQUESTS]
    n_tp, b_tp = RESNET_THROUGHPUT
    burst = rs.randn(b_tp, *IMAGE).astype(np.float32)
    want_calls = [1, 4, 16, 64] + [b_tp] * n_tp
    weights_f32 = sum(m.weight.numel() * 4 for m in model.modules()
                      if isinstance(m, (Conv2D, Linear)))
    results, rows = {}, {}
    for tag, im in ims.items():
        calls, plain = [], [0]
        hook = im.model.register_forward_pre_hook(
            lambda m, a: calls.append(a[0].shape[0]))
        plain_fn = q8.int8_matmul_plain

        def counted(*a):
            plain[0] += 1
            return plain_fn(*a)

        q8.int8_matmul_plain = counted
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            t1 = time.perf_counter()
            outs = [im.predict(x) for x in requests]
            torch.cuda.synchronize()
            req_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            for _ in range(n_tp):
                last = im.predict(burst)
            torch.cuda.synchronize()
            tp_s = time.perf_counter() - t1
            launches = dict(LAUNCHES)
        finally:
            q8.int8_matmul_plain = plain_fn
            hook.remove()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        outs.append(last)
        for x, y in zip(requests + [burst], outs):
            if y.shape != (x.shape[0], 1000) or not np.isfinite(y).all():
                raise AssertionError(f"serve_resnet {tag}: output "
                                     f"{y.shape}, finite "
                                     f"{np.isfinite(y).all()}")
        if calls != want_calls:
            raise AssertionError(f"serve_resnet {tag}: bucket calls {calls}, "
                                 f"want {want_calls}")
        want_launches = RESNET_INT8_CALLS * len(calls) if tag == "int8" else 0
        if launches.get("int8_matmul", 0) != want_launches or plain[0]:
            raise AssertionError(f"serve_resnet {tag}: int8_matmul launched "
                                 f"{launches} times over {len(calls)} bucket "
                                 f"calls (want {want_launches}), the plain "
                                 f"version ran {plain[0]} times")
        results[tag] = outs
        if tag == "int8":
            wq = sum(b.numel() * b.element_size()
                     for n, b in im.model.named_buffers()
                     if n.rsplit(".", 1)[-1] in ("weight_q", "scales"))
        else:
            wq = weights_f32
        rows[tag] = {"phase": "serve_resnet", "precision": tag,
                     "requests": [int(x.shape[0]) for x in requests],
                     "answered": len(requests), "bucket_calls": calls,
                     "launches": launches, "plain_calls": plain[0],
                     "requests_wall_s": req_s,
                     "throughput": {"requests": n_tp, "images": b_tp},
                     "throughput_wall_s": tp_s,
                     "images_per_s": n_tp * b_tp / tp_s,
                     "matmul_weight_bytes_at_rest": wq,
                     "peak_mem_gb": peak}

    # float32 predict against a direct forward of the same rows
    f32 = ims["float32"]
    worst_f32 = 0.0
    with torch.no_grad():
        for x, y in zip(requests, results["float32"]):
            direct = f32.model(torch.from_numpy(x).to(dev)).cpu().numpy()
            worst_f32 = max(worst_f32, float(np.abs(y - direct).max()
                                             / np.abs(direct).max()))
    # int8 against float32: top-1 agreement and log-prob drift
    agree = total = 0
    worst = 0.0
    for a, b in zip(results["int8"], results["float32"]):
        agree += int((a.argmax(1) == b.argmax(1)).sum())
        total += a.shape[0]
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    rows["float32"].update(max_rel_err_vs_direct=worst_f32,
                           rtol=RESNET_F32_RTOL)
    rows["int8"].update(top1_agree=f"{agree}/{total}",
                        max_logp_rel_err_vs_f32=worst,
                        rtol=INT8_LOGP_RTOL,
                        f32_matmul_weight_bytes=weights_f32)
    for tag in ims:
        rows[tag]["setup_s"] = setup_s
        emit(rows[tag])
    if worst_f32 > RESNET_F32_RTOL:
        raise AssertionError(f"float32 predict disagrees with a direct "
                             f"forward: {worst_f32}")
    if worst > INT8_LOGP_RTOL:
        raise AssertionError(f"int8 log-probs drift {worst} of max "
                             f"|log-prob| from float32's, past "
                             f"{INT8_LOGP_RTOL}")
    for tag, im in ims.items():
        emit({"phase": "resnet_profile", "precision": tag,
              "requests": 3, "images": b_tp,
              **_profile_groups(lambda: [im.predict(burst)
                                         for _ in range(3)])})
    return rows["int8"]["launches"]



def check_fused_layernorm(dev, flush):
    """Kernel 6: the fused LayerNorm against its plain version at the
    encoder's (bucket 64 x 128 tokens, 768) with eps 1e-12, at one
    sequence's (128, 768), at ragged (37, 1000) and (5, 16), and at a row
    start off 16-byte alignment; gamma and beta drawn from the seed.  The
    backward once against autograd of the plain version.  Timed at the
    main shape beside its bound, the plain version and
    ``F.layer_norm``."""
    from bigdl_tpu_torch.ops.fused import (fused_layernorm,
                                           fused_layernorm_plain)

    rows, d = BERT_THROUGHPUT[1] * BERT["length"], BERT["d"]
    g = torch.Generator().manual_seed(SEED)

    def inputs(r, c):
        x = (torch.randn(r, c, generator=g) * 2 + 0.5).to(dev)
        gamma = torch.empty(c).uniform_(0.5, 1.5, generator=g).to(dev)
        beta = (0.1 * torch.randn(c, generator=g)).to(dev)
        return x, gamma, beta

    checked, err = [], 0.0
    for r, c, eps, misaligned in ((rows, d, BERT["eps"], False),
                                  (BERT["length"], d, BERT["eps"], False),
                                  (37, 1000, BERT["eps"], False),
                                  (5, 16, 1e-5, False),
                                  (rows, d, BERT["eps"], True)):
        x, gamma, beta = inputs(r, c)
        if misaligned:
            buf = torch.empty(r * c + 1, device=dev)
            buf[1:].copy_(x.reshape(-1))
            x = buf[1:].view(r, c)
        got = fused_layernorm(x, gamma, beta, eps=eps)
        want = fused_layernorm_plain(x, gamma, beta, eps)
        torch.cuda.synchronize()
        tag = f"({r}, {c}), eps {eps}{', misaligned' if misaligned else ''}"
        err = max(err, _assert_close(f"fused_layernorm {tag}", got, want,
                                     LN_RTOL, LN_ATOL))
        checked.append([r, c, eps, misaligned])
        del x, gamma, beta, got, want

    # the backward (plain torch, as in the JAX package) once
    x, gamma, beta = inputs(BERT["length"], d)
    up = torch.randn(BERT["length"], d, generator=g).to(dev)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    grads = torch.autograd.grad(fused_layernorm(*leaves, eps=BERT["eps"]),
                                leaves, up)
    ref_leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    want = torch.autograd.grad(
        fused_layernorm_plain(*ref_leaves, BERT["eps"]), ref_leaves, up)
    bwd_err = max(_assert_close(f"fused_layernorm backward {name}", a, b,
                                LN_RTOL, LN_BWD_ATOL)
                  for name, a, b in zip(("dx", "dgamma", "dbeta"), grads,
                                        want))

    x, gamma, beta = inputs(rows, d)
    eps = BERT["eps"]
    lib = torch.nn.functional.layer_norm(x, (d,), gamma, beta, eps)
    _assert_close("the F.layer_norm yardstick", lib,
                  fused_layernorm_plain(x, gamma, beta, eps), LN_RTOL,
                  LN_ATOL)
    nbytes = 4 * (2 * rows * d + 2 * d)
    flops = 8 * rows * d
    row = {"name": "fused_layernorm", "route": "cuda",
           "source": "bigdl_tpu_torch/ops/csrc/fused_layernorm.cu",
           "replaces": "bigdl_tpu/ops/fused.py:73",
           "launches": None, "max_abs_err": err,
           "ms": time_cold(lambda: fused_layernorm(x, gamma, beta, eps=eps),
                           flush),
           "plain_ms": time_cold(lambda: fused_layernorm_plain(
               x, gamma, beta, eps), flush, reps=10),
           **_bound(nbytes, flops),
           "library_ms": time_cold(lambda: torch.nn.functional.layer_norm(
               x, (d,), gamma, beta, eps), flush)}
    emit({"phase": "kernel", "shape": [rows, d], "eps": eps,
          "checked": checked, "bytes": nbytes, "flops": flops,
          "rtol": LN_RTOL, "atol": LN_ATOL, "backward_max_abs_err": bwd_err,
          "backward_atol": LN_BWD_ATOL, **row})
    return row


def check_flash_noncausal(dev, flush):
    """Kernel 1's non-causal instance, which the encoder's attention
    takes, at its shape (bucket 64, 12 heads, 128 tokens, head_dim 64)
    against its plain version, timed beside SDPA without ``is_causal``."""
    from bigdl_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)

    b, h, s = BERT_THROUGHPUT[1], BERT["heads"], BERT["length"]
    d = BERT["d"] // h
    g = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn(b, h, s, d, generator=g).to(dev)
               for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, causal=False)
    again = flash_attention_fwd(q, k, v, causal=False)
    ro, rl = flash_attention_fwd_ref(q, k, v, causal=False,
                                     sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    _assert_bit_equal("flash fwd (non-causal)", (out, lse), again)
    err = max(_assert_close("flash fwd out (non-causal)", out, ro, RTOL,
                            ATOL),
              _assert_close("flash fwd lse (non-causal)", lse, rl, RTOL,
                            ATOL))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _assert_close("the SDPA yardstick (non-causal)", sdpa(q, k, v), out,
                  RTOL, ATOL)
    elems = b * h * s * d
    flops = 4 * d * b * h * _visible_pairs(s, s, False)
    nbytes = 4 * (4 * elems + b * h * s)
    row = _share({
        "name": "flash_attention_fwd", "instance": "non-causal",
        "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:109",
        "launches": None, "max_abs_err": err, "bit_equal": True,
        "ms": time_cold(lambda: flash_attention_fwd(q, k, v, causal=False),
                        flush),
        "plain_ms": time_cold(lambda: flash_attention_fwd_ref(
            q, k, v, causal=False, sm_scale=d ** -0.5), flush, reps=10),
        **_bound_3xtf32(nbytes, flops),
        "library_ms": time_cold(lambda: sdpa(q, k, v), flush)})
    emit({"phase": "kernel", "shape": {"batch": b, "heads": h, "seq": s,
                                       "head_dim": d, "causal": False},
          "bytes": nbytes, "flops": flops, "rtol": RTOL, "atol": ATOL,
          **row})
    return row


def bert_model(cfg=BERT, seed=SEED):
    """BERT's encoder written with the port's keras API on the CPU, weights
    drawn from ``torch.Generator`` seed ``seed``, every LayerNorm's gamma
    (U(0.5, 1.5)) and beta (N(0, 0.1)) and the position table (N(0, 0.5))
    redrawn from it: with gamma 1, beta 0 and zero positions a kernel that
    dropped its affine step, or a path that skipped the positions, would
    pass unchecked.  Two divergences from google-research/bert: GELU is the
    tanh approximation (``jax.nn.gelu``'s and the port's), and the position
    table (with the segment-0 row folded in) is a ``CAdd`` fixed to the
    length."""
    from bigdl_tpu_torch import keras as K
    from bigdl_tpu_torch import nn

    g = torch.Generator().manual_seed(seed)
    L, d, eps = cfg["length"], cfg["d"], cfg["eps"]
    tok = K.Input((L,), dtype=np.int32)
    x = K.Embedding(cfg["vocab"], d, generator=g)(tok)
    x = nn.CAdd((L, d))(x)
    x = K.Dropout(0.1)(K.LayerNorm(d, eps=eps)(x))
    for _ in range(cfg["layers"]):           # post-LN, as BERT
        a = K.Dropout(0.1)(K.MultiHeadAttention(d, cfg["heads"],
                                                generator=g)(x))
        x = K.LayerNorm(d, eps=eps)(K.Merge("sum")([x, a]))
        f = K.Dense(cfg["ffn"], d, generator=g)(
            K.GELU()(K.Dense(d, cfg["ffn"], generator=g)(x)))
        x = K.LayerNorm(d, eps=eps)(K.Merge("sum")([x, K.Dropout(0.1)(f)]))
    p = K.Activation("tanh")(K.Dense(d, d, generator=g)(nn.Select(1, 0)(x)))
    out = K.LogSoftMax()(K.Dense(d, cfg["labels"], generator=g)(
        K.Dropout(0.1)(p)))
    model = K.Model(tok, out)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, nn.CAdd):
                m.bias.normal_(0.0, 0.5, generator=g)
    return model.eval()


def serve_bert_fused(dev, model, cfg=BERT, buckets=BERT_BUCKETS,
                     sizes=BERT_REQUESTS, throughput=BERT_THROUGHPUT):
    """Fuse the encoder with ``IRGraph.from_model(model).to_model("fused")``
    and serve it through ``InferenceModel.predict``: requests of 1, 3, 16
    and 50 sequences (buckets 1, 4, 16, 64), then 20 requests of 64.  Every
    bucket call launches the LayerNorm kernel once per LayerNorm node and
    the flash forward once per attention, and the plain LayerNorm never
    runs; every answer is held to a direct forward of the unfused model
    with plain attention (no kernel of the port).  Then bert_profile."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.ops import fused as fused_mod
    from bigdl_tpu_torch.serving import InferenceModel
    from bigdl_tpu_torch.utils.intermediate import FusedLayerNorm, IRGraph

    t0 = time.perf_counter()
    fused = IRGraph.from_model(model).to_model("fused")
    kinds = [type(n.layer).__name__ for n in fused.order]
    n_ln = 1 + 2 * cfg["layers"]
    if (kinds.count(FusedLayerNorm.__name__) != n_ln or "LayerNorm" in kinds
            or "Dropout" in kinds):
        raise AssertionError(f"the fused graph has "
                             f"{kinds.count('FusedLayerNorm')} FusedLayerNorm "
                             f"nodes (want {n_ln}), LayerNorm "
                             f"{'LayerNorm' in kinds}, Dropout "
                             f"{'Dropout' in kinds}")
    im = InferenceModel(fused, device=dev, batch_buckets=buckets)
    rs = np.random.RandomState(SEED)

    def tokens(n):
        return rs.randint(0, cfg["vocab"], (n, cfg["length"])).astype(
            np.int32)

    im.warmup(tokens(1))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    requests = [tokens(n) for n in sizes]
    n_tp, b_tp = throughput
    burst = tokens(b_tp)
    want_calls = [min(b for b in buckets if b >= n) for n in sizes]
    want_calls += [b_tp] * n_tp
    calls, plain = [], [0]
    hook = im.model.register_forward_pre_hook(
        lambda m, a: calls.append(a[0].shape[0]))
    plain_fn = fused_mod.fused_layernorm_plain

    def counted(*a):
        plain[0] += 1
        return plain_fn(*a)

    fused_mod.fused_layernorm_plain = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t1 = time.perf_counter()
        outs = [im.predict(x) for x in requests]
        torch.cuda.synchronize()
        req_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        for _ in range(n_tp):
            last = im.predict(burst)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t1
        launches = dict(LAUNCHES)
    finally:
        fused_mod.fused_layernorm_plain = plain_fn
        hook.remove()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    outs.append(last)
    for x, y in zip(requests + [burst], outs):
        if y.shape != (x.shape[0], cfg["labels"]) or not np.isfinite(y).all():
            raise AssertionError(f"serve_bert_fused: output {y.shape}, "
                                 f"finite {np.isfinite(y).all()}")
    if calls != want_calls:
        raise AssertionError(f"serve_bert_fused: bucket calls {calls}, want "
                             f"{want_calls}")
    want_ln = n_ln * len(calls)
    want_flash = cfg["layers"] * len(calls)
    if (launches.get("fused_layernorm", 0) != want_ln
            or launches.get("flash_attention_fwd", 0) != want_flash
            or plain[0]):
        raise AssertionError(f"serve_bert_fused: launches {launches} over "
                             f"{len(calls)} bucket calls (want "
                             f"fused_layernorm {want_ln}, "
                             f"flash_attention_fwd {want_flash}); the plain "
                             f"LayerNorm ran {plain[0]} times")

    # every answer against the unfused model with plain attention and
    # plain LayerNorm: no kernel of the port in the reference
    for m in model.modules():
        if isinstance(m, nn.MultiHeadAttention):
            m.use_flash = False
    ref_model = model.to(dev)
    worst, agree, total = 0.0, 0, 0
    before = dict(LAUNCHES)
    with torch.no_grad():
        for x, y in zip(requests + [burst], outs):
            ref = ref_model(torch.from_numpy(x).to(dev)).cpu().numpy()
            worst = max(worst, float(np.abs(y - ref).max()
                                     / np.abs(ref).max()))
            agree += int((y.argmax(1) == ref.argmax(1)).sum())
            total += y.shape[0]
    if dict(LAUNCHES) != before:
        raise AssertionError("the reference forward launched a kernel of "
                             "the port")
    n_seq = n_tp * b_tp
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in im.model.parameters())
    emit({"phase": "serve_bert_fused", "model": cfg,
          "requests": [int(x.shape[0]) for x in requests],
          "answered": len(requests), "bucket_calls": calls,
          "launches": launches, "plain_layernorm_calls": plain[0],
          "fused_layernorm_nodes": n_ln,
          "max_logp_rel_err_vs_unfused_plain": worst,
          "rtol": BERT_LOGP_RTOL, "top1_agree": f"{agree}/{total}",
          "requests_wall_s": req_s,
          "throughput": {"requests": n_tp, "sequences": b_tp},
          "throughput_wall_s": tp_s, "sequences_per_s": n_seq / tp_s,
          "tokens_per_s": n_seq * cfg["length"] / tp_s,
          "weight_bytes": weight_bytes, "peak_mem_gb": peak,
          "setup_s": setup_s})
    if worst > BERT_LOGP_RTOL:
        raise AssertionError(f"fused predict disagrees with the unfused "
                             f"plain forward: {worst} of max |log-prob|, "
                             f"past {BERT_LOGP_RTOL}")
    emit({"phase": "bert_profile", "requests": 3, "sequences": b_tp,
          **_profile(lambda: [im.predict(burst) for _ in range(3)],
                     named=("fused_layernorm_kernel", "flash_fwd_kernel"))})
    return launches


def resnet_fused(dev, model):
    """ResNet-50 through the same rewrite: ``from_model`` lifts the top
    Sequential with the bottleneck blocks as whole nodes and folds the
    stem's BatchNorm into its conv, which gains a bias; ``predict`` at
    bucket 16 against the unfused model's."""
    from bigdl_tpu_torch.nn import BatchNorm, Conv2D
    from bigdl_tpu_torch.serving import InferenceModel
    from bigdl_tpu_torch.utils.intermediate import IRGraph

    fused = IRGraph.from_model(model).to_model("fused")
    n_bn = [sum(isinstance(m, BatchNorm) for m in mod.modules())
            for mod in (model, fused)]
    stem = fused.order[1].layer
    if n_bn[1] != n_bn[0] - 1 or not (isinstance(stem, Conv2D)
                                      and stem.with_bias
                                      and stem.bias is not None):
        raise AssertionError(f"fused ResNet-50: BatchNorms {n_bn}, stem "
                             f"{type(stem).__name__} with bias "
                             f"{getattr(stem, 'bias', None) is not None}")
    x = np.random.RandomState(SEED + 1).randn(16, *IMAGE).astype(np.float32)
    got = InferenceModel(fused, device=dev,
                         batch_buckets=RESNET_BUCKETS).predict(x)
    want = InferenceModel(model, device=dev,
                          batch_buckets=RESNET_BUCKETS).predict(x)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    emit({"phase": "resnet_fused", "batchnorms": n_bn,
          "stem_bias": True, "images": 16, "max_logp_rel_err": err,
          "rtol": FOLD_LOGP_RTOL,
          "top1_agree": f"{int((got.argmax(1) == want.argmax(1)).sum())}/16"})
    if not np.isfinite(got).all() or err > FOLD_LOGP_RTOL:
        raise AssertionError(f"fused ResNet-50 disagrees with the unfused "
                             f"model: {err} of max |log-prob|")


def main() -> int:
    # the port first: in a directory without it this fails before any
    # result is printed
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.common import resolve_device
    from bigdl_tpu_torch.tensor.policy import apply_precision_policy

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device()
    apply_precision_policy()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "sources": [s.name for s in _build.sources()],
          "ptxas": ptxas_report(_build.BUILD_LOGS)})

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    # what the yardstick reads for a launch that does next to nothing
    tiny = torch.zeros(1, device=dev)
    emit({"phase": "timing_floor", "what": "a 4-byte memset under time_cold",
          "ms": time_cold(tiny.zero_, flush)})
    decode_row = check_paged_decode(dev, flush)
    int8_row = check_paged_decode_int8(dev, flush)
    verify_row = check_paged_verify(dev, flush)
    sparse_row = check_block_sparse(dev, flush)
    fwd_row, bwd_row = check_flash(dev, flush)
    fwd_nc_row = check_flash_noncausal(dev, flush)
    ln_row = check_fused_layernorm(dev, flush)
    resnet = resnet_model()
    int8mm_row = check_int8_matmul(dev, flush, int8_shapes(resnet, 16, dev))
    del flush
    torch.cuda.empty_cache()

    launches, prompts, results, tps = serve(dev)
    decode_row["launches"] = launches.get(decode_row["name"], 0)
    torch.cuda.empty_cache()
    launches = serve_spec(dev, prompts, results, tps)
    verify_row["launches"] = launches.get(verify_row["name"], 0)
    sparse_row["launches"] = launches.get(sparse_row["name"], 0)
    torch.cuda.empty_cache()
    launches = serve_int8(dev, prompts, results)
    int8_row["launches"] = launches["plain"].get(int8_row["name"], 0)
    int8_row["launches_spec"] = launches["spec"].get(int8_row["name"], 0)
    torch.cuda.empty_cache()
    launches = serve_resnet(dev, resnet)
    int8mm_row["launches"] = launches.get(int8mm_row["name"], 0)
    resnet_fused(dev, resnet)
    del resnet
    torch.cuda.empty_cache()
    launches = serve_bert_fused(dev, bert_model())
    ln_row["launches"] = launches.get(ln_row["name"], 0)
    fwd_nc_row["launches"] = launches.get(fwd_nc_row["name"], 0)
    torch.cuda.empty_cache()
    launches, trained = train(dev)
    fwd_row["launches"] = launches.get("flash_attention_fwd", 0)
    bwd_entries = {k: launches.get(k, 0) for k in (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")}
    # one backward call launches both entry points
    bwd_row["launches"] = min(bwd_entries.values())
    bwd_row["launches_by_entry"] = bwd_entries
    eval_launches = evaluate_lm(dev, trained)
    fwd_row["launches_evaluate_lm"] = eval_launches.get(
        "flash_attention_fwd", 0)
    del trained
    torch.cuda.empty_cache()
    train_lenet(dev)
    # the training phases pin cuDNN to deterministic algorithms, so that a
    # resume can be held to the uninterrupted run
    torch.backends.cudnn.deterministic = True
    try:
        data = resnet_train_data()
        train_resnet(dev, data)
        torch.cuda.empty_cache()
        train_resnet_remat(dev, data)
        del data
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"kernels": [decode_row, int8_row, fwd_row, fwd_nc_row, bwd_row,
                      verify_row, int8mm_row, sparse_row, ln_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
