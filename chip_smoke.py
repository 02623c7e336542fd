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
   requests through ``InferenceModel.generate``, on an engine whose
   calls replay CUDA graphs (``cuda_graphs=True``, captured by
   ``warmup()``) beside one running the same programs eagerly, three
   timed runs each, alternating (``serve_run`` lines: tokens/s,
   ``serving.decode.step_s`` p50 and p99, launches a step, peak
   memory); every run's tokens and log-probs equal to the bit across
   the two; warmup seconds, graphs captured and the graph pool's bytes;
   the launch counts show the decode steps went through the kernels,
   and every generated token is checked against a full (uncached)
   forward of the same model; then ``serve_profile`` of each engine:
   the device's busy share of the wall time and its time by kernel;
6. serve_spec — the same requests with ``speculative=SpecConfig(k=4,
   sparsity=0.5)``, graphs beside eager (two pairs): every token checked
   as in serve, every verify through ``paged_verify_attention`` and
   every draft FFN through ``block_sparse_matmul`` (launch counts),
   tokens/s beside serve's, acceptance, agreement with serve's tokens;
   then serve_sweep on the same warmed engines: a mixed stream reaching
   every cache bucket, greedy and sampled, one request disconnecting
   mid-stream — no capture after warmup, the cancel counted, every page
   back, the graphs' tokens equal to the eager engine's;
7. serve_int8 — int8 KV pages and int8 weights, once without and once
   with speculation (the scan verify on the int8 decode kernel), graphs
   beside eager: every token within the int8 tolerance of a full
   forward of the dequantized weights, launch counts of the int8
   kernel, agreement and log-prob drift against serve, page bytes;
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
14b. train_lm_bundles — the LM at K = 1 (eager) and K = 4 (one captured
   step replayed), 12 steps each on 48 seeded rows (6 batches an epoch):
   losses equal to the bit, the flash forward and backward launches a
   step the same under replay (credited at each replay), step ms,
   tokens/s, peak memory, the busy share over [4, 8);
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
   memory, step time, the BatchNorm buffers equal;
17b. sync_audit — one eager ResNet-50 TrainStep step and three steps of
   the driver under ``torch.cuda.set_sync_debug_mode("warn")``: the
   count and call sites of the host syncs (none may be left in the step);
   train_resnet_bundles — K = 1 and K = 4 alternating (three runs each,
   12 steps): step ms, the host's dispatch of a step onto an idle card,
   busy share, peak memory, graphs captured, K = 4's losses equal to
   K = 1's to the bit with the epoch-tail bundle, and a K = 4 run
   checkpointed off the grid (every 6) and resumed to the same bits;
   recovery — K = 4 runs with ``step_fail@5``, a NaN batch caught by
   ``StepWatchdog(nan_patience=1)``, and SIGTERM sent at a step: each
   recovers or resumes, the steps after it equal the clean run's to the
   bit; profile_window — ``set_profile`` over iterations [2, 4) of a
   K = 2 run writes a trace;
18. the record-file input pipeline: record_file writes 1,280 seeded
   uint8 images of 300x300x3 and their labels with ``write_records``
   (345.6 MB) and opens them as ``AugmentedRecordImages`` (resize 256^2,
   random 224^2 crop, random flip, ImageNet normalization, in the native
   library); pipeline_alone streams two epochs of batch 64 into
   ``dispatch_to_device`` with no training (images/s, stage rates, the
   workers chosen, the host's cores, whether the native library and
   libjpeg built, overlapped copies > 0); feed_check holds epoch 0's
   first 6 batches through the feed over a depth-2 ring to the serial
   batches to the bit, with 1 worker and the tuned count;
   train_resnet_records trains ResNet-50 20 steps through
   ``Optimizer.optimize()`` from the record dataset with the JAX defaults
   (streaming, host_prefetch 2, prefetch 2): step time beside
   train_resnet's, images/s, busy share, the p50 and p99 of
   ``train.data_wait_s``, peak memory, its first 6 losses equal to the
   serial feed's to the bit, and a train summary with a loss and a
   throughput a step; train_resnet_records_bundles the same at K = 1
   and K = 4 alternating, losses equal to the bit, the data wait's p50
   and p99;
19. stream_jpeg — 256 seeded images JPEG-encoded by the native library
   and streamed through ``stream_jpeg_batches`` into the feed, 1 worker
   against the tuned count (the same bits); where the library has no
   libjpeg the line says why.
   The ResNet phases pin cuDNN to deterministic algorithms; train_resnet
   also times 6 steps with cuDNN's default choice.

Then the kernel table, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.

Each kernel row also says whether the kernel runs inside a captured
CUDA graph (``in_graph``: one call captured, replayed and held to the
eager call's bits).

``python3 chip_smoke.py --feed-ab`` runs only ``feed_ab``: where the
record path's ResNet-50 step time goes (in memory against records with
the tuned decode pool, one decode worker, and a train summary, each at
K = 1 and K = 4, alternating in one call; the host's time to dispatch a
step onto an idle card at each K).

Any failed phase raises and the
script exits non-zero; without a CUDA card it exits non-zero and prints
no result."""

import contextlib
import gc
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from collections import Counter

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
# train_resnet_records: ResNet-50 trained from a record file through the
# stage-parallel input pipeline.  1,280 uint8 images of 300x300x3 and
# int32 labels in [0, 1000) from seed 0, written with write_records
# (345.6 MB), read as AugmentedRecordImages with bench_loader.py's
# recipe: resize to 256^2, a random 224^2 crop, a random flip, the
# ImageNet mean and std on the 0-255 scale.  (a) two epochs through the
# feed alone; (b) epoch 0's first 6 batches through the feed over a
# depth-2 ring, held to the serial batches to the bit (1 worker and the
# tuned count); (c) 20 training steps, the first 6 losses held to the
# serial feed's to the bit.  Then 256 seeded images encoded as JPEG
# through stream_jpeg_batches where the native library has libjpeg.
RECORDS = dict(n=1280, src=300, resize=256, batch=64, pipeline_epochs=2,
               feed_batches=6, feed_ring=2, steps=20, bit_steps=6,
               jpeg_images=256, jpeg_quality=90)
IMAGENET_MEAN = tuple(v * 255 for v in (0.485, 0.456, 0.406))
IMAGENET_STD = tuple(v * 255 for v in (0.229, 0.224, 0.225))

# step bundles (sync_audit, train_resnet_bundles,
# train_resnet_records_bundles, train_lm_bundles, recovery,
# profile_window): K = 4 (one captured step replayed) beside K = 1 (eager)
# in one call, alternating 1, 4, 4, 1, ...; 12 steps a run (ResNet-50 in
# memory: 10 an epoch, bundles 4, 4, the 2-step epoch tail, 2; the LM: 6
# batches of 8 x 1024 an epoch), timed from iteration 4 (the first
# bundle holds the two eager warm steps and the capture); 8-step runs
# synchronised at each edge for the host's dispatch and profiled over
# [4, 8) for the busy share; a resume from a checkpoint off the grid of
# 4 (every 6)
BUNDLE = dict(k=4, steps=12, pairs=3, timed_from=4, sync_steps=8,
              ckpt_every=6, records_pairs=2, lm_batches=6)

# speculative decoding of the spec phases: SpecConfig(k=4, sparsity=0.5),
# the draft's FFN blocks (8, 8)
SPEC = dict(k=4, sparsity=0.5)
# the serving phases: an engine replaying CUDA graphs (cuda_graphs=True)
# beside one running the same programs eagerly (cuda_graphs=False), over
# one seeded LM, timed runs alternating eager, graphs, graphs, eager, ...:
# serve 3 pairs, serve_spec 2, each serve_int8 configuration 1; then one
# profiled run of each engine
SERVE_PAIRS = dict(serve=3, spec=2, int8=1)
# serve_sweep, on serve_spec's warmed engines: a stream reaching every
# cache bucket, greedy and sampled requests alternating.  A call's bucket
# is its longest row's, and one engine iteration runs up to k+1 prefill
# calls, so the stream comes in stages of (prompt tokens, new tokens),
# each stage submitted from the token stream of the stage before it (its
# first request's SWEEP_TRIGGER[i]-th token): the short first stage runs
# alone (buckets 1 and 2), then 4, 8, and the longest prompts 16 to 64 as
# each finishes its prefill.  Request SWEEP_CANCEL[0] (in stream order)
# disconnects at its SWEEP_CANCEL[1]-th token.
SWEEP_STAGES = (((3, 24), (5, 24), (9, 24)), ((20, 16), (40, 16)),
                ((90, 20),),
                ((180, 12), (400, 16), (900, 8), (14, 24), (60, 12),
                 (250, 8)))
SWEEP_TRIGGER = (12, 4, 4)
SWEEP_CANCEL = (7, 5)
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


def _in_graph(fn, want) -> dict:
    """Whether a kernel runs inside a captured CUDA graph: one call of its
    wrapper captured (after an eager call, as a captured step's warm-up
    runs it), replayed, and held to ``want`` (the eager outputs) to the
    bit.  A capture that fails is reported with its reason, not raised:
    the row records it."""
    from bigdl_tpu_torch.ops.common import captured_launches

    wants = want if isinstance(want, (tuple, list)) else (want,)
    fn()
    graph = torch.cuda.CUDAGraph()
    try:
        with captured_launches() as launched:
            with torch.cuda.graph(graph):
                out = fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return {"in_graph": False, "in_graph_reason": str(e)[:300]}
    outs = out if isinstance(out, (tuple, list)) else (out,)
    equal = all(torch.equal(a, b) for a, b in zip(outs, wants))
    return {"in_graph": equal, "in_graph_launches": dict(launched)}


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
    graph = _in_graph(lambda: paged_decode_attention(q, kp, vp, pt, ln), out)
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
                  "library_ms": library_ms, **graph})
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
    graph = _in_graph(
        lambda: paged_decode_attention(q, kp, vp, pt, ln, **sc), out)
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
                  "library_ms": library_ms, **graph})
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
        graph = _in_graph(lambda: paged_verify_attention(
            q, kp, vp, pt, pos, **sc), out)
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
            **_bound(kv_bytes + io_bytes, flops), "library_ms": library_ms,
            **graph})
        emit({"phase": "kernel", "shape": {"slots": S, "heads": h,
                                           "chunk": C, "head_dim": d,
                                           "page": page, "n_blocks": nb,
                                           "pages_dtype": tag},
              "keys": keys, "bytes": kv_bytes + io_bytes, "flops": flops,
              "rtol": RTOL, "atol": ATOL, **rows[tag]})
    row = dict(rows["f32"])
    row["int8_pages"] = {k: rows["int8"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "share", "in_graph")}
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
                graph = (_in_graph(lambda: _bs_raw(x, w, plan), out)
                         if not rows else {})
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
                                    2 * m * kept), **graph})
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
            "shape": main["shape"], "in_graph": main["in_graph"],
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
    graphs = (_in_graph(lambda: flash_attention_fwd(q, k, v, causal=True),
                        (out, lse)),
              _in_graph(lambda: flash_attention_bwd(
                  q, k, v, out, lse, go, causal=True),
                  flash_attention_bwd(q, k, v, out, lse, go, causal=True)))
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
                "library_ms": fwd_lib, **graphs[0]}),
        _share({"name": "flash_attention_bwd", "route": "cuda",
                "source": "bigdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": "bigdl_tpu/ops/flash_attention.py:141",
                "launches": None, "max_abs_err": errs["bwd"],
                "bit_equal": True, "ms": bwd_ms, "plain_ms": bwd_plain,
                **_bound_3xtf32(bwd_bytes, bwd_flops),
                "library_ms": fb_lib - fwd_lib, **graphs[1]})]
    for row, flops, nbytes in ((rows[0], fwd_flops, fwd_bytes),
                               (rows[1], bwd_flops, bwd_bytes)):
        emit({"phase": "kernel", "shape": shape,
              "checked": [list(x) for x in shapes], "bytes": nbytes,
              "flops": flops, "rtol": RTOL,
              "atol": ATOL if row is rows[0] else BWD_ATOL, **row})
    return rows


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


def _sample_metrics():
    """A metrics registry for one serving run that also keeps every
    observed sample, for exact percentiles of the run."""
    from bigdl_tpu_torch.optim.metrics import Metrics

    class Samples(Metrics):
        def __init__(self):
            super().__init__()
            self.samples = {}

        def observe(self, name, value, labels=None):
            super().observe(name, value, labels)
            self.samples.setdefault(name, []).append(float(value))

    return Samples()


def _lm_pair(dev, weight_quant=None, **cfg):
    """Two InferenceModels of the seeded LM, one whose engine replays CUDA
    graphs (``cuda_graphs=True``) and one whose engine runs the same
    programs eagerly (``cuda_graphs=False``), each warmed up: ({mode: im},
    {mode: warmup row})."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    model = Transformer(**LM, dropout=0.0, seed=SEED)
    pair, rows = {}, {}
    for mode in ("graphs", "eager"):
        im = InferenceModel(model, decode=DecodeConfig(
            **DECODE, cuda_graphs=mode == "graphs", **cfg), device=dev,
            weight_quant=weight_quant)
        pair[mode] = im
        eng = im.decode_engine
        eng.metrics = _sample_metrics()
        torch.cuda.synchronize()
        im.warmup()
        pool = eng.graph_pool_bytes()
        rows[mode] = {
            "warmup_s": eng.warmup_s, "graphs_captured": eng.graphs_captured,
            "graph_captures_counted": eng.metrics.counter(
                "serving.decode.graph_captures"),
            "graph_pool_gb": None if pool is None else pool / 2**30,
            "closed_set": len(eng.closed_set())}
    return pair, rows


def _percentile_ms(samples, q):
    return 1e3 * float(np.percentile(samples, q)) if samples else None


def _serve_run(im, prompts):
    """One timed ``generate`` of ``prompts`` on ``im``, its engine on a
    fresh metrics registry: a dict of the results, wall s, launches, the
    engine's stats delta and the run's row."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches

    eng = im.decode_engine
    eng.metrics = _sample_metrics()
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
    steps = max(delta["steps"], 1)
    n_tok = int(sum(len(r.tokens) for r in results))
    samples = eng.metrics.samples
    step_s = samples.get("serving.decode.step_s", [])
    row = {"tokens_per_s": n_tok / wall, "wall_s": wall,
           "generated_tokens": n_tok, "steps": delta["steps"],
           "prefill_calls": delta["prefill_calls"],
           "step_ms_p50": _percentile_ms(step_s, 50),
           "step_ms_p99": _percentile_ms(step_s, 99),
           "prefill_ms_p50": _percentile_ms(
               samples.get("serving.decode.prefill_s", []), 50),
           "inter_token_ms_p50": _percentile_ms(
               samples.get("serving.decode.inter_token_s", []), 50),
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    for name in ("spec_draft_step_s", "spec_verify_step_s"):
        got = samples.get(f"serving.decode.{name}")
        if got:
            row[name[:-2] + "_ms_p50"] = _percentile_ms(got, 50)
    return {"results": results, "wall": wall, "launches": launches,
            "delta": delta, "row": row}


def _replay_host_ms(eng, reps=5) -> dict:
    """The host's time to launch one replay of each program's greedy
    graph at the largest bucket onto an idle card, median of ``reps``
    (idle inputs: every write goes to the sink; not counted as
    launches)."""
    nb = eng.cfg.len_buckets()[-1]
    out = {}
    for (name, b, sampled), entry in eng._graphs.items():
        if b != nb or sampled:
            continue
        eng._programs[name].dev_in.copy_(eng._programs[name].idle)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.graph.replay()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        out[name] = 1e3 * float(np.median(times))
    return out


def _same_bits(name, want, got) -> None:
    """Graphs against eager: every token and summed log-prob to the bit."""
    for i, (a, b) in enumerate(zip(want, got)):
        if a.tokens.tolist() != b.tokens.tolist() \
                or np.float32(a.logp).tobytes() != np.float32(b.logp).tobytes():
            raise AssertionError(
                f"{name}: request {i} differs between the runs: tokens "
                f"{a.tokens.tolist()[:8]}... vs {b.tokens.tolist()[:8]}..., "
                f"logp {a.logp!r} vs {b.logp!r}")


def _serve_pairs(pair, prompts, n_pairs, name, busy=True):
    """``n_pairs`` timed runs of each engine, alternating eager, graphs,
    graphs, eager, ...: every run's tokens and log-probs equal to the
    first eager run's to the bit, and every run's launches equal (a
    replay credits its capture's counts); then, with ``busy``, one
    profiled run of each engine for the device's busy share.  Returns
    {mode: summary} and the first graphs run."""
    order = []
    for i in range(n_pairs):
        order += ["eager", "graphs"] if i % 2 == 0 else ["graphs", "eager"]
    runs = {"graphs": [], "eager": []}
    for mode in order:
        run = _serve_run(pair[mode], prompts)
        emit({"phase": f"{name}_run", "mode": mode,
              "run": len(runs[mode]), **run["row"]})
        runs[mode].append(run)
    ref = runs["eager"][0]
    for mode, rs in runs.items():
        for run in rs:
            _same_bits(name, ref["results"], run["results"])
            if run["launches"] != ref["launches"]:
                raise AssertionError(f"{name}: launches {run['launches']} "
                                     f"({mode}) against {ref['launches']}")
    summary = {}
    for mode, rs in runs.items():
        rows = [r["row"] for r in rs]
        summary[mode] = {
            "tokens_per_s": [r["tokens_per_s"] for r in rows],
            "step_ms_p50": [r["step_ms_p50"] for r in rows],
            "step_ms_p99": [r["step_ms_p99"] for r in rows],
            "launches_per_step": rows[0]["launches_per_step"],
            "peak_mem_gb": max(r["peak_mem_gb"] for r in rows)}
        if mode == "graphs":
            summary[mode]["replay_host_ms"] = _replay_host_ms(
                pair[mode].decode_engine)
        if busy:
            prof = _profile(lambda im=pair[mode]: im.generate(prompts))
            summary[mode]["device_busy_share"] = prof["device_busy_share"]
            emit({"phase": f"{name}_profile", "mode": mode, **prof})
    summary["bits_equal"] = True
    return summary, runs["graphs"][0]


def serve(dev):
    """Drive the serving main path: the seeded LM answers the requests
    through ``InferenceModel.generate``, an engine replaying CUDA graphs
    beside one running the same programs eagerly, and check what comes
    out."""
    t0 = time.perf_counter()
    pair, setup = _lm_pair(dev)
    try:
        setup_s = time.perf_counter() - t0
        rs = np.random.RandomState(SEED)
        prompts = [rs.randint(2, LM["vocab_size"], n).astype(np.int32)
                   for n in rs.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                       N_REQUESTS)]
        modes, run = _serve_pairs(pair, prompts, SERVE_PAIRS["serve"],
                                  "serve")
        results, launches = run["results"], run["launches"]
        steps = run["delta"]["steps"]
        want = LM["num_layers"] * steps
        if steps < 1 or launches.get("paged_decode_attention", 0) != want:
            raise AssertionError(f"paged_decode_attention launched "
                                 f"{launches} times over {steps} decode "
                                 f"steps of {LM['num_layers']} layers")
        im = pair["graphs"]
        # every generated token against a full uncached forward of the
        # same model: finite logits, the token within 1e-3 of the top
        # logit, and the request's summed log-prob within 1e-3
        worst_gap, worst_logp = check_tokens(im, prompts, results, dev)
        if worst_gap > 1e-3 or worst_logp > 1e-3:
            raise AssertionError(f"served tokens disagree with the full "
                                 f"forward: logit gap {worst_gap}, logp "
                                 f"{worst_logp}")
        # continuous vs static decoding on the card: reported, not assumed
        eng = im.decode_engine
        from bigdl_tpu_torch.serving import DecodeRequest

        static = eng.static_generate([DecodeRequest(tokens=p)
                                      for p in prompts])
        agree = sum(a.tokens.tolist() == b.tokens.tolist()
                    for a, b in zip(results, static))
        n_tok = int(sum(len(r.tokens) for r in results))
        tps = float(np.median(modes["graphs"]["tokens_per_s"]))
        emit({"phase": "serve", "model": LM, "decode": DECODE,
              "requests": len(results), "answered": len(results),
              "finish_reasons": sorted({r.finish_reason for r in results}),
              "prompt_tokens": int(sum(len(p) for p in prompts)),
              "generated_tokens": n_tok, "decode_steps": steps,
              "prefill_calls": run["delta"]["prefill_calls"],
              "launches": launches, "nan_logits": False,
              "max_logit_gap": worst_gap, "max_logp_err": worst_logp,
              "static_agree": f"{agree}/{len(results)}",
              "kv_bytes_per_page": eng.kv_bytes_per_page(),
              "tokens_per_s": tps, "setup_s": setup_s, "warmup": setup,
              "modes": modes})
        return launches, prompts, results, tps
    finally:
        for im in pair.values():
            im.stop()


def serve_spec(dev, prompts, ref_results, ref_tps):
    """Drive the speculative serving path, graphs beside eager, and check
    what comes out.  Returns its launches and the pair (serve_sweep runs
    on it next)."""
    from bigdl_tpu_torch.serving import SpecConfig

    t0 = time.perf_counter()
    pair, setup = _lm_pair(dev, speculative=SpecConfig(**SPEC))
    try:
        setup_s = time.perf_counter() - t0
        modes, run = _serve_pairs(pair, prompts, SERVE_PAIRS["spec"],
                                  "serve_spec")
        results, launches, d = run["results"], run["launches"], run["delta"]
        steps, calls = d["steps"], d["prefill_calls"]
        L = LM["num_layers"]
        if steps < 1 or launches.get("paged_verify_attention", 0) \
                != L * steps:
            raise AssertionError(f"paged_verify_attention launched "
                                 f"{launches} times over {steps} speculative "
                                 f"iterations of {L} layers")
        _spec_launches_check(launches, steps, calls, SPEC["k"],
                             "serve_spec")
        im = pair["graphs"]
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
              "tokens_per_s": float(np.median(
                  modes["graphs"]["tokens_per_s"])),
              "spec_off_tokens_per_s": ref_tps, "setup_s": setup_s,
              "warmup": setup,
              "kv_bytes_per_page": im.decode_engine.kv_bytes_per_page(),
              "modes": modes})
        return launches, pair
    except BaseException:
        for im in pair.values():
            im.stop()
        raise


def serve_int8(dev, prompts, ref_results):
    """Int8 KV pages and int8 weights, spec off then on, graphs beside
    eager."""
    from bigdl_tpu_torch.serving import SpecConfig

    out = {}
    L = LM["num_layers"]
    for spec in (None, SpecConfig(**SPEC)):
        # the engines serve their int8 copies of one float32 model
        pair, setup = _lm_pair(dev, weight_quant="int8", kv_dtype="int8",
                               speculative=spec)
        try:
            modes, run = _serve_pairs(pair, prompts, SERVE_PAIRS["int8"],
                                      "serve_int8")
            results, launches, d = (run["results"], run["launches"],
                                    run["delta"])
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
            im = pair["graphs"]
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
                   "tokens_per_s": float(np.median(
                       modes["graphs"]["tokens_per_s"])),
                   "warmup": setup, "modes": modes}
            if spec is not None:
                row.update(drafted=d["spec_drafted"],
                           accepted=d["spec_accepted"],
                           accept_rate=d["spec_accepted"]
                           / max(d["spec_drafted"], 1))
            emit(row)
            out[tag] = launches
        finally:
            for im in pair.values():
                im.stop()
    return out


def serve_sweep(dev, pair):
    """After warmup(), on both engines of the serve_spec pair: a mixed
    stream whose prompts reach every cache bucket (``SWEEP_STAGES``, each
    stage submitted from the token stream of the one before),
    greedy and sampled requests alternating, speculation on, one request
    cancelled from its own token stream (``reason="client_disconnect"``).
    Both engines see the same schedule.  Holds: zero unexpected
    captures, the cancel counted once as a client disconnect, every page
    back on the free list, and every token and log-prob of the graphs'
    stream (the cancelled request's partial tokens too) equal to the
    eager stream's."""
    from bigdl_tpu_torch.serving import DecodeRequest, RequestCancelledError

    rs = np.random.RandomState(SEED + 1)
    shape = [r for stage in SWEEP_STAGES for r in stage]
    prompts = [rs.randint(2, LM["vocab_size"], n).astype(np.int32)
               for n, _ in shape]
    starts = np.cumsum([0] + [len(st) for st in SWEEP_STAGES])
    victim, at = SWEEP_CANCEL
    out = {}
    for mode in ("graphs", "eager"):
        eng = pair[mode].decode_engine
        eng.metrics = _sample_metrics()
        eng.calls.clear()
        reqs = [DecodeRequest(tokens=p, max_new_tokens=new,
                              temperature=1.1 if i % 2 else 0.0, top_k=50,
                              top_p=0.95, seed=i)
                for i, (p, (_, new)) in enumerate(zip(prompts, shape))]

        submitted = set()

        def submit_stage(st, eng=eng, reqs=reqs, submitted=submitted):
            # on the engine thread, once: at the trigger token, or when
            # the triggering request ends first
            if st not in submitted:
                submitted.add(st)
                eng.submit_many(reqs[starts[st]:starts[st + 1]])

        def next_stage(rid, tok, idx, reqs=reqs):
            st = int(np.searchsorted(starts, reqs.index(
                next(r for r in reqs if r.rid == rid)), side="right"))
            if idx + 1 == SWEEP_TRIGGER[st - 1]:
                submit_stage(st)

        def disconnect(rid, tok, idx, eng=eng):
            if idx + 1 == at:
                eng.cancel(rid, reason="client_disconnect")

        for st in range(len(SWEEP_STAGES) - 1):
            reqs[starts[st]].on_token = next_stage
            reqs[starts[st]].on_done = \
                lambda r, st=st: submit_stage(st + 1)
        reqs[victim].on_token = disconnect
        t0 = time.perf_counter()
        eng.submit_many(reqs[:starts[1]])
        results, partial = [], None
        for i, r in enumerate(reqs):
            deadline = time.time() + 300
            while not r.rid and time.time() < deadline:
                time.sleep(0.01)     # submitted from the engine thread
            try:
                results.append(r.wait(timeout=300))
            except RequestCancelledError as e:
                if i != victim or e.reason != "client_disconnect":
                    raise
                partial = e.partial_tokens.tolist()
                results.append(None)
        wall = time.perf_counter() - t0
        deadline = time.time() + 30
        while len(eng._free_pages) != eng.cfg.total_pages \
                or eng._reserved_pages:
            if time.time() > deadline:
                raise AssertionError(
                    f"serve_sweep ({mode}): "
                    f"{eng.cfg.total_pages - len(eng._free_pages)} pages "
                    f"never came back")
            time.sleep(0.01)
        m = eng.metrics
        out[mode] = {
            "results": results, "partial": partial,
            "unexpected_captures": m.counter(
                "serving.decode.unexpected_captures"),
            "cancelled": m.counter("serving.decode.cancelled"),
            "client_disconnects": m.counter(
                "serving.decode.client_disconnects"),
            "free_pages": len(eng._free_pages),
            "calls": {f"{n}@{nb}{'s' if smp else 'g'}": c
                      for (n, nb, smp), c in sorted(eng.calls.items())},
            "wall_s": wall}
    g, e = out["graphs"], out["eager"]
    if g["unexpected_captures"] != 0 or g["cancelled"] != 1 \
            or g["client_disconnects"] != 1 or e["cancelled"] != 1:
        raise AssertionError(f"serve_sweep: {g}")
    if g["partial"] is None or g["partial"] != e["partial"] \
            or len(g["partial"]) < at:
        raise AssertionError(f"serve_sweep: cancelled stream {g['partial']} "
                             f"vs {e['partial']}")
    _same_bits("serve_sweep", [r for r in e["results"] if r is not None],
               [r for r in g["results"] if r is not None])
    cfg = pair["graphs"].decode_engine.cfg
    buckets = sorted({nb for n, nb, _ in pair["graphs"].decode_engine.calls
                      if n == "spec"})
    if buckets != list(cfg.len_buckets()):
        raise AssertionError(f"serve_sweep reached the speculative "
                             f"program at buckets {buckets} only")
    emit({"phase": "serve_sweep", "requests": len(prompts),
          "prompt_lens": [n for n, _ in shape],
          "unexpected_captures": g["unexpected_captures"],
          "cancelled": g["cancelled"],
          "client_disconnects": g["client_disconnects"],
          "partial_tokens": len(g["partial"]),
          "free_pages": g["free_pages"], "total_pages": cfg.total_pages,
          "spec_buckets": buckets, "calls": g["calls"],
          "graphs_equal_eager": True,
          "wall_s": {"graphs": g["wall_s"], "eager": e["wall_s"]}})


def _device_kernels(events) -> list:
    """The device-side entries of ``key_averages()`` that are kernels and
    copies.  A profiler range (``record_function``: the driver's
    ``train/data`` and ``train/bundle``, the step's
    ``train_step/update``) also shows on the device, under its host-side
    name, as an annotation spanning the kernels it launched: counted as
    device time it would count them twice, so every device entry whose
    name is also a host event's is left out."""
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in host]


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
    kernels = _device_kernels(prof.key_averages())
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
    kernels = _device_kernels(events)
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


def _xy(mb):
    return mb["input"], mb["target"]


def write_record_images(d):
    """RECORDS' images and labels from seed 0 as a record file in ``d``."""
    from bigdl_tpu_torch.data import write_records

    c = RECORDS
    rng = np.random.default_rng(SEED)
    path = os.path.join(d, "train.btrec")
    t0 = time.perf_counter()
    write_records(path, {
        "image": rng.integers(0, 256, (c["n"], c["src"], c["src"], 3),
                              dtype=np.uint8),
        "label": rng.integers(0, 1000, c["n"]).astype(np.int32)})
    return path, time.perf_counter() - t0


def record_images(path):
    from bigdl_tpu_torch.data import AugmentedRecordImages

    c = RECORDS
    return AugmentedRecordImages(path, IMAGE[:2], IMAGENET_MEAN,
                                 IMAGENET_STD, resize_hw=(c["resize"],) * 2,
                                 random_crop=True, random_flip=True)


def pipeline_alone(dev, path):
    """(a) Two epochs through stream_batches into the device feed, no
    training: the rate the host can feed the card at, with the stage
    rates that say which stage sets it."""
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.data import dispatch_to_device
    from bigdl_tpu_torch.data.pipeline import host_core_count
    from bigdl_tpu_torch.optim.metrics import Metrics

    c = RECORDS
    ds = record_images(path)
    m = Metrics()
    epochs = []
    for epoch in range(c["pipeline_epochs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream = ds.stream_batches(c["batch"], seed=SEED, epoch=epoch,
                                   metrics=m)
        n = 0
        for x, _ in dispatch_to_device(stream, _xy, metrics=m, device=dev):
            n += x.shape[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs.append({"epoch": epoch, "images": n, "wall_s": wall,
                       "images_per_s": n / wall, "workers": stream.workers,
                       "stage_rates": stream.stage_rates()})
    ds.close()
    out = {"phase": "pipeline_alone", "epochs": epochs,
           "host_cores": host_core_count(),
           "native_built": native.available(),
           "libjpeg_built": native.jpeg_available(),
           "libjpeg_reason": native.jpeg_unavailable_reason(),
           "dispatch_overlapped_total":
               m.counter("data.dispatch_overlapped_total"),
           "decoded_images": m.counter("data.decoded_images")}
    emit(out)
    want = c["n"] // c["batch"] * c["batch"]
    if [e["images"] for e in epochs] != [want] * c["pipeline_epochs"]:
        raise AssertionError(f"the pipeline lost images: {out}")
    if out["dispatch_overlapped_total"] <= 0 or not native.available():
        raise AssertionError(f"the feed never overlapped two copies, or "
                             f"the native library did not build: {out}")
    return out


def feed_check(dev, path):
    """(b) Epoch 0's first batches through the feed over a depth-2 ring,
    every device batch kept alive while the ring refills its slots, then
    read back: equal to the serial batches to the bit, for 1 worker and
    for the tuned count."""
    import itertools

    from bigdl_tpu_torch.data import dispatch_to_device
    from bigdl_tpu_torch.data.pipeline import autotune_workers

    c = RECORDS
    ds = record_images(path)
    want = list(itertools.islice(ds.batches(c["batch"], seed=SEED, epoch=0),
                                 c["feed_batches"]))
    runs = []
    for workers in (1, autotune_workers()):
        feed = dispatch_to_device(
            ds.stream_batches(c["batch"], seed=SEED, epoch=0,
                              workers=workers, ring_depth=c["feed_ring"]),
            _xy, device=dev)
        kept = list(itertools.islice(feed, c["feed_batches"]))
        feed.close()
        equal = [bool(np.array_equal(x.cpu().numpy(), mb["input"])
                      and np.array_equal(y.cpu().numpy(), mb["target"]))
                 for (x, y), mb in zip(kept, want)]
        runs.append({"workers": workers, "batches": len(kept),
                     "bit_equal": equal})
    ds.close()
    out = {"phase": "feed_check", "ring_depth": c["feed_ring"], "runs": runs}
    emit(out)
    if not all(r["batches"] == c["feed_batches"] and all(r["bit_equal"])
               for r in runs):
        raise AssertionError(f"the feed's batches differ from the serial "
                             f"batches: {out}")
    return out


def train_resnet_records(dev, path, in_memory):
    """(c) ResNet-50 through ``Optimizer.optimize()`` from the record
    dataset with the JAX defaults (streaming, host_prefetch 2, prefetch
    2): step time beside the in-memory run's, the data waits, and the
    first losses held to the serial feed's to the bit; a train summary
    with a loss and a throughput a step."""
    import shutil

    from bigdl_tpu_torch.models import resnet50
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer, Trigger
    from bigdl_tpu_torch.optim.metrics import SummaryWriter
    from bigdl_tpu_torch.utils.tbwriter import read_scalars

    c = RECORDS
    ds = record_images(path)

    def make(end, **attrs):
        model = resnet50(classes=1000, stem="conv",
                         generator=torch.Generator().manual_seed(SEED))
        opt = (Optimizer(model, ds, CrossEntropyCriterion(),
                         batch_size=c["batch"], device=dev)
               .set_optim_method(_resnet_recipe()).set_end_when(end))
        for k, v in attrs.items():
            setattr(opt, k, v)
        return opt

    serial = make(Trigger.max_iteration(c["bit_steps"]), streaming=False,
                  host_prefetch=0)
    serial.optimize()
    serial_losses = serial.losses
    del serial
    torch.cuda.empty_cache()
    summary = tempfile.mkdtemp(prefix="resnet_records_summary_")
    try:
        events = {}
        opt = make(Trigger.or_(_step_clock(events),
                               Trigger.max_iteration(c["steps"])))
        if (opt.streaming, opt.host_prefetch, opt.prefetch) != (True, 2, 2):
            raise AssertionError("the Optimizer's input defaults moved")
        opt.set_train_summary(summary)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        with SummaryWriter(summary, "train", tensorboard=False) as s:
            logged = {tag: [step for step, _ in s.read_scalar(tag)]
                      for tag in ("loss", "throughput", "lr")}
        (event_file,) = os.listdir(os.path.join(summary, "train"))
        tb = read_scalars(os.path.join(summary, "train", event_file))
        tb_counts = {tag: sum(1 for _, t, _ in tb if t == tag)
                     for tag in ("loss", "throughput")}
    finally:
        shutil.rmtree(summary, ignore_errors=True)
    step_ms = _step_ms(events, 0, c["steps"])
    med = float(np.median(step_ms[2:]))
    snap = opt.metrics.snapshot()
    waits, counters = snap["hists"]["train.data_wait_s"], snap["counters"]
    wait_p = [opt.metrics.percentile("train.data_wait_s", q)
              for q in (50, 99)]
    losses = opt.losses
    del opt
    torch.cuda.empty_cache()
    profiled = make(Trigger.max_iteration(2))
    prof = _profile_train(profiled.optimize)
    del profiled
    ds.close()
    out = {"phase": "train_resnet_records", "config": c,
           "cudnn_deterministic": torch.backends.cudnn.deterministic,
           "losses": losses, "serial_feed_losses": serial_losses,
           "step_ms": step_ms, "median_step_ms": med,
           "images_per_s": c["batch"] / med * 1e3,
           "in_memory_median_step_ms": in_memory["median_step_ms"],
           "step_over_in_memory": med / in_memory["median_step_ms"],
           "busy_share": prof["device_busy_s"] * 1e3 / 2 / med,
           # the histogram's percentiles: the upper bound of the bucket
           # that holds them (x2 buckets from 0.1 ms), clamped to the max
           "data_wait_s": {
               "count": waits["n"], "p50_bucket_bound": wait_p[0],
               "p99_bucket_bound": wait_p[1], "max": waits["max"],
               "sum": waits["sum"]},
           "dispatch_overlapped_total": counters.get(
               "data.dispatch_overlapped_total", 0.0),
           "wall_s": wall, "peak_mem_gb": peak / 2**30,
           "in_memory_peak_mem_gb": in_memory["peak_mem_gb"],
           "summary_steps": {k: len(v) for k, v in logged.items()},
           "summary_event_scalars": tb_counts,
           "profile_2_steps": prof}
    emit(out)
    first = losses[:c["bit_steps"]]
    if len(losses) != c["steps"] or not np.all(np.isfinite(losses)):
        raise AssertionError(f"ResNet-50 record losses: {losses}")
    if first != serial_losses:
        raise AssertionError(f"the streamed losses differ from the serial "
                             f"feed's: {first} / {serial_losses}")
    steps = list(range(1, c["steps"] + 1))
    if logged["loss"] != steps or logged["throughput"] != steps or \
            tb_counts != {"loss": c["steps"], "throughput": c["steps"]}:
        raise AssertionError(f"the train summary: {logged} {tb_counts}")
    if out["dispatch_overlapped_total"] <= 0 or waits["n"] < c["steps"]:
        raise AssertionError(f"the feed or the data waits: {out}")
    return out


def stream_jpeg(dev):
    """256 seeded images encoded as JPEG (the native encoder) streamed
    through ``stream_jpeg_batches`` (decode, resize, crop, flip and
    normalize in the native workers) into the feed, for 1 worker and the
    tuned count: the same bits either way, finite, the recipe's shape."""
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.data import dispatch_to_device, stream_jpeg_batches
    from bigdl_tpu_torch.data.pipeline import autotune_workers

    c = RECORDS
    if not native.jpeg_available():
        out = {"phase": "stream_jpeg", "ran": False,
               "reason": native.jpeg_unavailable_reason()}
        emit(out)
        return out
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    enc = [native.encode_jpeg(rng.integers(0, 256, (c["src"], c["src"], 3),
                                           dtype=np.uint8), c["jpeg_quality"])
           for _ in range(c["jpeg_images"])]
    encode_s = time.perf_counter() - t0
    labels = rng.integers(0, 1000, c["jpeg_images"]).astype(np.int32)
    runs, batches = [], {}
    for workers in (1, autotune_workers()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream = stream_jpeg_batches(
            enc, c["batch"], IMAGE[:2], IMAGENET_MEAN, IMAGENET_STD,
            labels=labels, resize_hw=(c["resize"],) * 2, random_crop=True,
            random_flip=True, shuffle=True, seed=SEED, workers=workers)
        got = list(dispatch_to_device(stream, _xy, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        batches[workers] = [(x.cpu().numpy(), y.cpu().numpy())
                            for x, y in got]
        runs.append({"workers": workers, "batches": len(got),
                     "images_per_s": len(got) * c["batch"] / wall,
                     "stage_rates": stream.stage_rates()})
    (one, many) = batches.values()
    equal = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(one, many))
    finite = all(np.all(np.isfinite(x)) for x, _ in one)
    shapes = sorted({x.shape for x, _ in one})
    out = {"phase": "stream_jpeg", "ran": True, "images": len(enc),
           "jpeg_bytes": sum(map(len, enc)), "encode_s": encode_s,
           "runs": runs, "bit_equal_1_vs_n": equal, "finite": finite,
           "shapes": [list(sh) for sh in shapes]}
    emit(out)
    if not (equal and finite and shapes == [(c["batch"],) + IMAGE]
            and len(one) == c["jpeg_images"] // c["batch"]):
        raise AssertionError(f"stream_jpeg_batches on the card: {out}")
    return out


class _PinnedWorkers:
    """A record dataset whose streaming decode pool has ``workers``
    threads (the driver leaves the width to ``autotune_workers``)."""

    def __init__(self, ds, workers):
        self.ds, self.workers = ds, workers

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def stream_batches(self, *args, **kw):
        return self.ds.stream_batches(*args, **dict(kw,
                                                     workers=self.workers))


def feed_ab(dev):
    """``--feed-ab``: where the record path's step time goes, eager and
    in step bundles.  In one call, alternating, 20 ResNet-50 steps each,
    at K = 1 (eager) and K = 4 (captured graphs): in memory, from records
    with the tuned decode pool, with one decode worker, and with the
    tuned pool plus a train summary; the step's device ms over steps
    5-20 (CUDA events at the bundle edges).  Then 12 steps of each K in
    memory and from records with the card synchronised at every edge,
    which gives the host's time to dispatch one step onto an idle
    card."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.data.pipeline import (autotune_workers,
                                              host_core_count)
    from bigdl_tpu_torch.models import resnet50
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer

    c = RECORDS
    (x, y), _ = resnet_train_data()
    memory = DataSet.array(x, y)
    del x, y

    def maker(ds, summary):
        def make(end):
            model = resnet50(classes=1000, stem="conv",
                             generator=torch.Generator().manual_seed(SEED))
            opt = (Optimizer(model, ds, CrossEntropyCriterion(),
                             batch_size=c["batch"], device=dev)
                   .set_optim_method(_resnet_recipe()).set_end_when(end))
            if summary:
                opt.set_train_summary(summary)
            return opt
        return make

    def run(name, k, steps=c["steps"], sync=False):
        ds, summary = plan[name]
        r = _bundle_run(maker(ds, summary), k, steps, sync=sync)
        del r["losses"]
        return {"run": f"{name}_k{k}" + ("_synced" if sync else ""), **r}

    runs = []
    with tempfile.TemporaryDirectory(prefix="feed_ab_") as d:
        path, _ = write_record_images(d)
        records = record_images(path)
        tuned = autotune_workers()
        plan = {"memory": (memory, None),
                f"records_{tuned}_workers": (records, None),
                "records_1_worker": (_PinnedWorkers(records, 1), None),
                f"records_{tuned}_workers_summary": (
                    records, os.path.join(d, "summary"))}
        order = [(n, k) for k in (1, BUNDLE["k"]) for n in plan]
        for name, k in order + order[::-1]:
            runs.append(run(name, k))
        for k in (1, BUNDLE["k"]):
            for name in ("memory", f"records_{tuned}_workers"):
                runs.append(run(name, k, steps=12, sync=True))
        records.close()
    step_ms = {}
    for r in runs:
        if "host_dispatch_ms" not in r:
            step_ms.setdefault(r["run"], []).append(r["step_ms"])
    out = {"phase": "feed_ab", "host_cores": host_core_count(),
           "tuned_workers": tuned, "step_ms": step_ms,
           "host_dispatch_ms": {r["run"]: r["host_dispatch_ms"]
                                for r in runs if "host_dispatch_ms" in r},
           "host_ms_per_step": {r["run"]: r["host_ms_per_step"]
                                for r in runs if "host_ms_per_step" in r},
           "runs": runs}
    emit(out)
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
        if not per_shape:
            # the main path's launch: K-major weight, fused rescale
            graph = _in_graph(lambda: int8_matmul_nk(x, w_nk, sw, sx[:, None]),
                              int8_matmul_nk(x, w_nk, sw, sx[:, None]))
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
            **graph,
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
    kernels = _device_kernels(events)
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
    graph = _in_graph(lambda: fused_layernorm(x, gamma, beta, eps=eps),
                      fused_layernorm(x, gamma, beta, eps=eps))
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
               x, (d,), gamma, beta, eps), flush), **graph}
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
    graph = _in_graph(lambda: flash_attention_fwd(q, k, v, causal=False),
                      (out, lse))
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
        "library_ms": time_cold(lambda: sdpa(q, k, v), flush), **graph})
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


# ---------------------------------------------------------------------------
# step bundles: captured CUDA graphs of the training step
# ---------------------------------------------------------------------------

class _SyncWindow:
    """``set_sync_debug_mode("warn")`` over a window: as an end trigger,
    from iteration ``start`` to ``stop`` (edges of the driver's loop),
    or around a call (``with``).  ``sites``: the Python line of every
    call in the window that waited on the card, with its count."""

    def __init__(self, start=0, stop=0):
        import warnings

        self.start, self.stop = start, stop
        self._catch = warnings.catch_warnings(record=True)
        self.caught, self.sites = None, None

    def __enter__(self):
        import warnings

        torch.cuda.synchronize()
        self.caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        sites = Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                        for w in self.caught
                        if "called a synchronizing" in str(w.message))
        self.sites = [{"site": k, "count": v}
                      for k, v in sites.most_common()]
        return False

    def __call__(self, state):
        it = state["iteration"]
        if it == self.start and self.caught is None:
            self.__enter__()
        elif it >= self.stop and self.caught is not None \
                and self.sites is None:
            self.__exit__(None, None, None)
        return False


def sync_audit(dev, data):
    """Where the eager ResNet-50 step waits on the card, under
    ``set_sync_debug_mode("warn")``.  (a) One ``TrainStep`` step on a
    batch already on the card: none may remain, or the step could not be
    captured; (b) steps 2-4 of the driver's loop from memory (the feed,
    the triggers around the step; the set-up's parameter copies and the
    run's final read of the losses are outside the window)."""
    from bigdl_tpu_torch.models import resnet50
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import TrainStep, Trigger

    (x, y), _ = data
    b = RESNET_TRAIN["batch"]
    model = resnet50(classes=1000, stem="conv",
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
    step = TrainStep(model, CrossEntropyCriterion(), _resnet_recipe())
    xt = torch.from_numpy(x[:b]).to(dev)
    yt = torch.from_numpy(y[:b]).to(dev)
    step(0, xt, yt)
    with _SyncWindow() as window:
        step(1, xt, yt)
    in_step = window.sites
    del step, model, xt, yt
    _release()
    window = _SyncWindow(1, 4)
    opt = _resnet_optimizer(dev, (x, y), Trigger.or_(
        window, Trigger.max_iteration(5)))
    opt.optimize()
    in_loop = window.sites
    del opt
    _release()
    out = {"phase": "sync_audit",
           "train_step": {"syncs": sum(s["count"] for s in in_step),
                          "sites": in_step},
           "driver_steps_2_to_4": {
               "syncs": sum(s["count"] for s in in_loop), "sites": in_loop}}
    emit(out)
    if in_step:
        raise AssertionError(f"the eager TrainStep step still waits on the "
                             f"card: {in_step}")
    return out


class _BusyWindow:
    """An end trigger that profiles iterations ``[start, stop)`` (bundle
    edges): the device's kernel time over the wall time between them."""

    def __init__(self, start, stop):
        self.start, self.stop = start, stop
        self.prof, self.out = None, None

    def __call__(self, state):
        from torch.profiler import ProfilerActivity, profile

        it = state["iteration"]
        if it == self.start and self.prof is None:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif it >= self.stop and self.prof is not None and self.out is None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            self.prof.stop()
            kernels = _device_kernels(self.prof.key_averages())
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            self.out = {"steps": it - self.start, "wall_s": wall,
                        "device_busy_s": busy, "busy_share": busy / wall,
                        "top": [{"kernel": e.key[:60], "calls": e.count,
                                 "device_ms": e.self_device_time_total
                                 / 1e3} for e in top[:4]],
                        "kernel_launches": sum(e.count for e in kernels)}
        return False


def _bundle_run(make_opt, k, steps, sync=False, busy=None, extra=None):
    """One run of ``make_opt(end_when)`` at ``steps_per_call=k`` to
    ``steps``: the CUDA events at the bundle edges it reaches (step ms
    from iteration BUNDLE["timed_from"] on), the losses, peak memory and
    the graphs captured; ``sync`` synchronises at every edge and gives
    the host's time to dispatch a step onto an idle card; ``busy`` a
    ``_BusyWindow``; ``extra(opt)`` more entries.  The kernel launches
    a step are counted (replays credited).  The run, its graphs and their
    memory pools are released before it returns."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.optim import Trigger

    events, arrive, idle = {}, {}, {}

    def tick(state):
        it = state["iteration"]
        if it not in events:
            arrive[it] = time.perf_counter()
            events[it] = torch.cuda.Event(enable_timing=True)
            events[it].record()
            if sync:
                torch.cuda.synchronize()
            idle[it] = time.perf_counter()
        return False

    ends = [Trigger(tick, "clock")] + ([busy] if busy else [])
    opt = make_opt(Trigger.or_(*ends, Trigger.max_iteration(steps)))
    opt.steps_per_call = k
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(opt.device)
    reset_launches()
    t0 = time.perf_counter()
    with _timed_step_calls(calls) if sync else contextlib.nullcontext():
        trained = opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    edges = sorted(events)
    a = min(e for e in edges if e >= BUNDLE["timed_from"])
    out = {"k": k, "steps": steps, "edges": edges,
           "step_ms": events[a].elapsed_time(events[steps]) / (steps - a),
           "wall_s": wall, "peak_mem_gb":
               torch.cuda.max_memory_allocated(opt.device) / 2**30,
           "graphs_captured": trained._step.graphs_captured,
           "launches_per_step": {n: v / steps for n, v in LAUNCHES.items()},
           "losses": opt.losses, **(extra(opt) if extra else {})}
    del opt, trained
    _release()
    if sync:
        # all the host's work a step (the feed, the loop, the dispatch)
        # and the step call alone, from iteration a on
        per = [(arrive[e2] - idle[e1]) * 1e3 / (e2 - e1)
               for e1, e2 in zip(edges, edges[1:]) if e1 >= a]
        out["host_ms_per_step"] = float(np.median(per))
        timed = [dts for it0, dts in calls if it0 >= a and dts]
        out["host_dispatch_ms"] = (float(np.median([d[0] for d in timed]))
                                   * 1e3 if timed else None)
        out["host_step_calls_ms"] = [[t * 1e3 for t in d] for d in timed]
    if busy is not None:
        out["busy"] = busy.out
    return out


@contextlib.contextmanager
def _timed_step_calls(calls):
    """Record every call of the train step (``TrainStep.__call__`` and
    ``train_bundle``) as ``(first step, [host seconds of each step])``:
    the host's dispatch of the steps themselves, without the feed and
    the loop.  With the card synchronised at every bundle edge, a call's
    first step is dispatched onto an idle card; the later steps of a
    bundle can wait for room in the card's launch queue, which holds
    about two replays of a ResNet-50 step."""
    from bigdl_tpu_torch.optim import TrainStep

    real_call, real_bundle = TrainStep.__call__, TrainStep.train_bundle
    real_graph = TrainStep._graph_step

    def call(self, step, x, y):
        t0 = time.perf_counter()
        out = real_call(self, step, x, y)
        calls.append((step, [time.perf_counter() - t0]))
        return out

    def graph_step(self, x, y, scalars):
        t0 = time.perf_counter()
        out = real_graph(self, x, y, scalars)
        calls[-1][1].append(time.perf_counter() - t0)
        return out

    def bundle(self, step0, xs, ys):
        calls.append((step0, []))
        return real_bundle(self, step0, xs, ys)

    TrainStep.__call__, TrainStep.train_bundle = call, bundle
    TrainStep._graph_step = graph_step
    try:
        yield calls
    finally:
        TrainStep.__call__, TrainStep.train_bundle = real_call, real_bundle
        TrainStep._graph_step = real_graph


def _release():
    """Collect dropped runs (their captured graphs hold private memory
    pools) and hand the cached memory back."""
    gc.collect()
    torch.cuda.empty_cache()


def _bundle_pairs(make_opt, steps, pairs, name, extra=None):
    """``pairs`` x (K = 1, K = 4) alternating (1, 4, 4, 1, ...; ``extra``
    for each), then one synchronised run of each for the host's dispatch
    and one profiled window of each for the busy share.  Every run's
    losses must equal the first K = 1 run's to the bit."""
    k = BUNDLE["k"]
    order = [1, k, k, 1] * (pairs // 2) + ([1, k] if pairs % 2 else [])
    runs = []
    for kk in order:
        runs.append(_bundle_run(make_opt, kk, steps, extra=extra))
    sync_steps = BUNDLE["sync_steps"]
    for kk in (1, k):
        runs.append({**_bundle_run(make_opt, kk, sync_steps, sync=True),
                     "run": "synced"})
        runs.append({**_bundle_run(
            make_opt, kk, sync_steps,
            busy=_BusyWindow(BUNDLE["timed_from"], sync_steps)),
            "run": "profiled"})
    ref = runs[0]["losses"]
    timed = [r for r in runs if "run" not in r]
    summary = {
        f"k{kk}": {
            "step_ms": [r["step_ms"] for r in timed if r["k"] == kk],
            "median_step_ms": float(np.median(
                [r["step_ms"] for r in timed if r["k"] == kk])),
            "host_dispatch_ms": next(r["host_dispatch_ms"] for r in runs
                                     if r.get("run") == "synced"
                                     and r["k"] == kk),
            "host_ms_per_step": next(r["host_ms_per_step"] for r in runs
                                     if r.get("run") == "synced"
                                     and r["k"] == kk),
            "busy_share": next(r["busy"]["busy_share"] for r in runs
                               if r.get("run") == "profiled"
                               and r["k"] == kk),
            "peak_mem_gb": max(r["peak_mem_gb"] for r in timed
                               if r["k"] == kk),
            "graphs_captured": max(r["graphs_captured"] for r in timed
                                   if r["k"] == kk),
            "launches_per_step": next(r["launches_per_step"] for r in timed
                                      if r["k"] == kk)}
        for kk in (1, k)}
    equal = [r["losses"] == ref[:len(r["losses"])] for r in runs]
    out = {"phase": name, "order": order, "summary": summary,
           "losses_k1": ref, "all_losses_bit_equal": all(equal),
           "runs": [{kk: v for kk, v in r.items() if kk != "losses"}
                    for r in runs]}
    return out, equal


def train_resnet_bundles(dev, data):
    """ResNet-50 at batch 64 from memory, K = 1 (eager) and K = 4 (one
    captured step replayed) alternating: step ms, the host's dispatch
    onto an idle card, busy share, peak memory, graphs captured, and
    K = 4's losses equal to K = 1's to the bit over 12 steps (10 an
    epoch: bundles 4, 4, the 2-step epoch tail, then 2).  Then a K = 4
    run checkpointed off the grid (every 6) and resumed: the resumed
    steps equal the uninterrupted run's to the bit."""
    import shutil

    from bigdl_tpu_torch.optim import Trigger

    (x, y), _ = data
    steps = BUNDLE["steps"]

    def make(end):
        return _resnet_optimizer(dev, (x, y), end)

    out, equal = _bundle_pairs(make, steps, BUNDLE["pairs"],
                               "train_resnet_bundles")
    ref = out["losses_k1"]
    tmp = tempfile.mkdtemp(prefix="bundle_ckpt_")
    try:
        every = Trigger.several_iteration(BUNDLE["ckpt_every"])
        first = make(Trigger.max_iteration(BUNDLE["ckpt_every"] + 1))
        first.set_checkpoint(tmp, every)
        first.steps_per_call = BUNDLE["k"]
        first.optimize()
        del first
        _release()
        second = make(Trigger.max_iteration(steps))
        second.set_checkpoint(tmp, every)
        second.steps_per_call = BUNDLE["k"]
        second.optimize()
        resumed = second.losses
        del second
        _release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["resumed_off_grid"] = {
        "ckpt_every": BUNDLE["ckpt_every"], "losses": resumed,
        "bit_equal": resumed == ref[BUNDLE["ckpt_every"]:]}
    emit(out)
    if not all(equal) or len(ref) != steps or not np.all(np.isfinite(ref)):
        raise AssertionError(f"K = 4 losses differ from K = 1's: {out}")
    if not out["resumed_off_grid"]["bit_equal"]:
        raise AssertionError(f"the resumed bundles differ: {resumed} / "
                             f"{ref}")
    if out["summary"][f"k{BUNDLE['k']}"]["graphs_captured"] != 1:
        raise AssertionError(f"one graph per batch shape: {out}")
    return out


def train_resnet_records_bundles(dev, path):
    """The same from the record file through the stage-parallel pipeline
    (the driver's defaults), K = 1 beside K = 4 (two runs each, then a
    synchronised and a profiled one): step ms, the host's dispatch, busy
    share, peak memory, losses equal to the bit, the data wait's p50 and
    p99."""
    from bigdl_tpu_torch.models import resnet50
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer

    c = RECORDS
    ds = record_images(path)

    def make(end):
        model = resnet50(classes=1000, stem="conv",
                         generator=torch.Generator().manual_seed(SEED))
        return (Optimizer(model, ds, CrossEntropyCriterion(),
                          batch_size=c["batch"], device=dev)
                .set_optim_method(_resnet_recipe()).set_end_when(end))

    def waits(opt):
        m = opt.metrics
        return {"data_wait_s": {
            "count": m.snapshot()["hists"]["train.data_wait_s"]["n"],
            "p50_bucket_bound": m.percentile("train.data_wait_s", 50),
            "p99_bucket_bound": m.percentile("train.data_wait_s", 99)}}

    out, equal = _bundle_pairs(make, BUNDLE["steps"],
                               BUNDLE["records_pairs"],
                               "train_resnet_records_bundles", extra=waits)
    ds.close()
    emit(out)
    if not all(equal) or not np.all(np.isfinite(out["losses_k1"])):
        raise AssertionError(f"record-file bundles: {out}")
    return out


def train_lm_bundles(dev):
    """The LM (12 layers, d 768, batch 8 x 1024) at K = 1 and K = 4: the
    flash forward and backward launch counts a step the same under replay
    as eager (credited at each replay), the losses equal to the bit, step
    ms, tokens/s, the host's dispatch, busy share and peak memory.  48
    seeded rows: 6 steps an epoch."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.optim import Adam, Optimizer

    rs = np.random.RandomState(SEED + 2)
    shape = (TRAIN["batch"] * BUNDLE["lm_batches"], TRAIN["seq"])
    ids = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    tgt = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)

    def make(end):
        return (Optimizer(Transformer(**LM, dropout=0.0, seed=SEED),
                          DataSet.array(ids, tgt), CrossEntropyCriterion(),
                          batch_size=TRAIN["batch"], device=dev)
                .set_optim_method(Adam(learning_rate=TRAIN["lr"]))
                .set_end_when(end))

    out, equal = _bundle_pairs(make, BUNDLE["steps"], 1, "train_lm_bundles")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    for summary in out["summary"].values():
        summary["tokens_per_s"] = tokens / summary["median_step_ms"] * 1e3
    emit(out)
    want = {n: float(LM["num_layers"]) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}
    for kk, summary in out["summary"].items():
        got = {n: summary["launches_per_step"].get(n) for n in want}
        if got != want:
            raise AssertionError(f"flash launches a step at {kk}: {got}")
    if not all(equal) or not np.all(np.isfinite(out["losses_k1"])):
        raise AssertionError(f"LM bundles: {out}")
    return out


class _Poisoned:
    """The in-memory set with batch 5 of epoch 1 NaN the first time it
    is served."""

    def __init__(self, ds):
        self.ds, self.fired = ds, False

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def batches(self, *a, **kw):
        for i, mb in enumerate(self.ds.batches(*a, **kw)):
            if kw.get("epoch") == 1 and i == 5 and not self.fired:
                self.fired = True
                mb = dict(mb, input=np.full_like(mb["input"], np.nan))
            yield mb


class _SigtermAt:
    """An end trigger that sends this process SIGTERM the first time the
    run reaches ``at``: at a step, never from a timer."""

    def __init__(self, inner, at):
        self.inner, self.at, self.fired = inner, at, False
        self.boundary = inner.boundary

    def __call__(self, state):
        if not self.fired and state["iteration"] >= self.at:
            self.fired = True
            self.t = time.perf_counter()
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner(state)


def recovery(dev, data, clean):
    """ResNet-50 at K = 4 through the retry loop and preemption, each run
    held to the clean K = 4 run of train_resnet_bundles (``clean``, its
    12 losses): (a) ``step_fail@5`` recovered from the bundle-edge
    checkpoint at 4; (b) a NaN batch (batch 5) caught by
    ``StepWatchdog(nan_patience=1)`` before ckpt-8 is written and rewound
    to ckpt-4; (c) SIGTERM delivered at iteration 4's edge: checkpoint
    at 5 (the next bundle shrunk to one step), stop, and a new run
    resumes to 12.  The steps after each rewind or resume equal the
    clean run's to the bit."""
    import shutil

    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.resilience.detector import StepWatchdog
    from bigdl_tpu_torch.runtime import Engine

    (x, y), _ = data
    steps, k = BUNDLE["steps"], BUNDLE["k"]
    config = Engine.get().config
    interval = config.failure_retry_interval_s
    config.failure_retry_interval_s = 0.0
    tmp = tempfile.mkdtemp(prefix="recovery_")
    out = {"phase": "recovery", "k": k}
    try:
        def run(tag, dataset=None, end=None, **attrs):
            opt = _resnet_optimizer(dev, (x, y),
                                    end or Trigger.max_iteration(steps))
            if dataset is not None:
                opt.dataset = dataset
            opt.steps_per_call = k
            d = os.path.join(tmp, tag)
            opt.set_checkpoint(d, Trigger.several_iteration(k))
            for name, v in attrs.items():
                setattr(opt, name, v)
            t0 = time.perf_counter()
            opt.optimize()
            wall = time.perf_counter() - t0
            r = {"final_iteration": opt.final_state["iteration"],
                 "wall_s": wall,
                 "recoveries_total": opt.metrics.counter("recoveries_total"),
                 "retries_by_cause": {
                     n: v for n, v in opt.metrics.counters.items()
                     if n.startswith("retries_by_cause.")},
                 "time_lost_to_recovery_s": opt.metrics.counter(
                     "time_lost_to_recovery_s"),
                 "losses": opt.losses}
            del opt
            _release()
            return r

        inj = faults.install(faults.parse_plan("step_fail@5"))
        try:
            out["step_fail"] = run("step_fail")
        finally:
            faults.clear()
        out["step_fail"]["events"] = inj.events
        poisoned = _Poisoned(DataSet.array(x, y))
        out["nan"] = run("nan", dataset=poisoned,
                         watchdog=StepWatchdog(nan_patience=1))
        out["nan"]["poison_served"] = poisoned.fired
        end = _SigtermAt(Trigger.max_iteration(steps), 3)
        opt = _resnet_optimizer(dev, (x, y), end)
        opt.steps_per_call = k
        d = os.path.join(tmp, "sigterm")
        opt.set_checkpoint(d, Trigger.several_iteration(100))
        opt.set_preemption_checkpoint()
        opt.optimize()
        stopped_s = time.perf_counter() - end.t
        stopped = opt.final_state["iteration"]
        del opt
        _release()
        resume = _resnet_optimizer(dev, (x, y), Trigger.max_iteration(steps))
        resume.steps_per_call = k
        resume.set_checkpoint(d, Trigger.several_iteration(100))
        t_resume = {}
        restore = resume._try_resume

        def timed(*a):
            t0 = time.perf_counter()
            restore(*a)
            torch.cuda.synchronize()
            t_resume["s"] = time.perf_counter() - t0

        resume._try_resume = timed
        resume.optimize()
        out["sigterm"] = {"stopped_at": stopped,
                          "checkpoints": sorted(os.listdir(d)),
                          "signal_to_stop_s": stopped_s,
                          "resume_s": t_resume.get("s"),
                          "losses": resume.losses}
        del resume
        _release()
    finally:
        config.failure_retry_interval_s = interval
        shutil.rmtree(tmp, ignore_errors=True)
    checks = {
        "step_fail": out["step_fail"]["recoveries_total"] == 1
        and out["step_fail"]["final_iteration"] == steps
        and ("step_fail", 5, 5) in out["step_fail"]["events"]
        and out["step_fail"]["losses"][k:] == clean[k:],
        "nan": out["nan"]["poison_served"]
        and out["nan"]["retries_by_cause"] == {
            "retries_by_cause.poisoned_batch": 1.0}
        and out["nan"]["final_iteration"] == steps
        and out["nan"]["losses"][2 * k:] == clean[2 * k:],
        "sigterm": out["sigterm"]["stopped_at"] == k + 1
        and out["sigterm"]["checkpoints"] == [f"ckpt-{k + 1}"]
        and out["sigterm"]["losses"] == clean[k + 1:]}
    out["bit_equal_after_recovery"] = checks
    for key in ("step_fail", "nan"):
        out[key]["losses_tail"] = out[key].pop("losses")[-4:]
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"recovery: {checks}")
    return out


def profile_window(dev, data):
    """``set_profile`` over iterations [2, 4) of a K = 2 ResNet-50 run
    (the second bundle: its capture and first replays) writes one
    Chrome trace; the phase prints its size."""
    import shutil

    from bigdl_tpu_torch.optim import Trigger

    (x, y), _ = data
    d = tempfile.mkdtemp(prefix="profile_window_")
    try:
        opt = _resnet_optimizer(dev, (x, y), Trigger.max_iteration(6))
        opt.steps_per_call = 2
        opt.set_profile(d, start_iter=2, num_iters=2)
        opt.optimize()
        files = {f: os.path.getsize(os.path.join(d, f))
                 for f in os.listdir(d)}
        text = open(os.path.join(d, next(iter(files)))).read() \
            if files else ""
        del opt
        _release()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = {"phase": "profile_window", "window": [2, 4], "k": 2,
           "trace_files": files,
           "has_bundle_range": "train/bundle" in text,
           "has_device_kernels": '"cat": "kernel"' in text}
    emit(out)
    if len(files) != 1 or not out["has_bundle_range"]:
        raise AssertionError(f"profile window: {out}")
    return out


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
    if sys.argv[1:] == ["--feed-ab"]:
        torch.backends.cudnn.deterministic = True
        feed_ab(dev)
        print(smi, flush=True)
        return 0

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
    launches, spec_pair = serve_spec(dev, prompts, results, tps)
    verify_row["launches"] = launches.get(verify_row["name"], 0)
    sparse_row["launches"] = launches.get(sparse_row["name"], 0)
    try:
        serve_sweep(dev, spec_pair)
    finally:
        for im in spec_pair.values():
            im.stop()
    del spec_pair
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
    lm_bundles = train_lm_bundles(dev)
    for row, kernel in ((fwd_row, "flash_attention_fwd"),
                        (bwd_row, "flash_attention_bwd_dq")):
        row["launches_per_step_in_graph"] = lm_bundles["summary"][
            f"k{BUNDLE['k']}"]["launches_per_step"][kernel]
    train_lenet(dev)
    # the training phases pin cuDNN to deterministic algorithms, so that a
    # resume can be held to the uninterrupted run
    torch.backends.cudnn.deterministic = True
    try:
        data = resnet_train_data()
        in_memory = train_resnet(dev, data)
        torch.cuda.empty_cache()
        train_resnet_remat(dev, data)
        torch.cuda.empty_cache()
        sync_audit(dev, data)
        bundles = train_resnet_bundles(dev, data)
        recovery(dev, data, bundles["losses_k1"])
        profile_window(dev, data)
        del data
        _release()
        with tempfile.TemporaryDirectory(prefix="resnet_records_") as d:
            path, write_s = write_record_images(d)
            emit({"phase": "record_file", "images": RECORDS["n"],
                  "bytes": os.path.getsize(path), "write_s": write_s})
            pipeline_alone(dev, path)
            feed_check(dev, path)
            train_resnet_records(dev, path, in_memory)
            train_resnet_records_bundles(dev, path)
        stream_jpeg(dev)
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"kernels": [decode_row, int8_row, fwd_row, fwd_nc_row, bwd_row,
                      verify_row, int8mm_row, sparse_row, ln_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
