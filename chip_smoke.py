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
   ``warmup()``) beside one running the same programs eagerly and one
   replaying graphs captured in float32 products, two timed runs each,
   alternating (``serve_run`` lines: tokens/s,
   ``serving.decode.step_s`` p50 and p99, launches a step, peak
   memory); every run's tokens and log-probs equal to the bit across
   the two; warmup seconds, graphs captured and the graph pool's bytes;
   the launch counts show the decode steps went through the kernels,
   and every generated token is checked against a full (uncached)
   forward of the same model; then ``serve_profile`` of each engine:
   the device's busy share of the wall time and its time by kernel;
6. serve_spec — the same requests with ``speculative=SpecConfig(k=4,
   sparsity=0.5)``, graphs beside eager and float32 graphs (two pairs):
   every token checked as in serve, every verify through
   ``paged_verify_attention`` and every draft FFN through the
   block-sparse kernel, its bfloat16 instance in bfloat16 products
   (launch counts),
   tokens/s beside serve's, acceptance, agreement with serve's tokens;
   then serve_sweep on the same warmed engines: a mixed stream reaching
   every cache bucket, greedy and sampled, one request disconnecting
   mid-stream — no capture after warmup, the cancel counted, every page
   back, the graphs' tokens equal to the eager engine's; then
   serve_spec_window: ``SpecConfig(k=4, sparsity=0.5, draft_window=128)``
   beside serve_spec's graphs engine (no window) and a
   non-speculative engine, 16 prompts of 512 tokens: verify and
   block-sparse launches by serve_spec's formulas, tokens within the
   bfloat16 tolerance of a full forward, no capture after warmup; the
   acceptance and the draft's device time an iteration with and without
   the window, the tokens against the non-speculative engine (reported);
7. serve_int8 — int8 KV pages and int8 weights, once without and once
   with speculation (the scan verify on the int8 decode kernel), graphs
   beside eager: every token within the int8 tolerance of a full
   forward of the dequantized weights, launch counts of the int8
   kernel, agreement and log-prob drift against serve, page bytes;
7b. the decode engine's fleet half and translation serving, each on
   its own engines: serve_prefix (``prefix_cache_pages=128``: a warm
   448-token system prefix, then 15 requests of it plus 64 tokens, on a
   graphs engine, an eager one and a cold graphs engine without the
   cache, float32 and int8 pages: 15 hits, 1 miss, the shared pages'
   bytes and scales unchanged, graphs equal to eager to the bit, 12
   paged-kernel launches a decode step, no capture after warmup, fewer
   prefill calls than cold, the agreement with cold reported);
   serve_handoff (8 prefill-only requests of 512 tokens on engine A,
   packed, unpacked and imported on B; then 8 live requests migrated
   from A to B after their 8th token; float32 and int8 pages: bytes a
   handoff, pack and unpack ms, the first token A's, every imported and
   migrated slot on the paged kernel, no capture after warmup, an int8
   blob refused by a float32 engine; the tokens against one engine's
   run reported); serve_seq2seq (the Transformer-base translation model
   through ``Seq2SeqService(continuous=True)``: 16 sources of 16-64
   tokens, max_len 64, 6 paged-kernel launches a decode step, no
   capture after warmup, tokens/s, beam 4 over 4 sources; the greedy
   tokens against ``transformer_decode_cached`` reported);
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
   bert_profile; then serve_keras_int8: the same encoder (float32
   products) through ``InferenceModel(m, weight_quant="int8")``,
   ``quantize(m, calibrate(m, batches))`` per tensor and per channel,
   and the fused model with ``weight_quant="int8"``: one int8-kernel
   launch per Dense node (26) a bucket call, 25 LayerNorm-kernel
   launches on the fused model, 12 flash launches, the plain versions
   never run, answers within ``BERT_INT8_LOGP_RTOL``
   (``BERT_INT8_CALIB_LOGP_RTOL`` calibrated) of the float model's and
   top-1 agreeing on ``BERT_INT8_TOP1_FLOOR`` of the rows, a control
   (per-channel scales a quarter of the calibrated ones) outside the
   per-channel bound, sequences/s at bucket 64; then serve_http: a
   ``ServingServer`` of the LM (float32 pages in captured graphs) and
   the int8 fused encoder behind an ``HttpFrontend``, 16 streamed
   ``/generate`` requests beside 4 clients of 10 ``/predict`` requests,
   tracing and a TTFT SLO on: paged decode launches = 12 x steps, 26
   int8, 12 flash and 25 LayerNorm launches a bucket call, no plain
   version, no capture after warmup, predictions within
   ``HTTP_PREDICT_RTOL`` of a direct predict of the batches the server
   assembled (and a control of rows shifted by one past it), each
   request's rows alone reported (C.2) beside the cause of their drift
   (cuBLAS's row bits at M = 128 and 512, the int8 model's answer to a
   one-ulp change of one weight), ``/metrics`` equal to the
   server's stats with both tenants' series, the streams' trace events
   and the SLO burn gauge; then serve_pool: a ``ServingPool`` of 2
   worker processes on the card (the LM, int8 pages), 8 streams, the
   worker holding live streams killed mid-flight: every stream
   finishes, a failover and resumed tokens counted, no orphan, the
   worker respawned, the federated ``/metrics`` of both workers;
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
   train_resnet_bundles — K = 1 and K = 4 alternating (two runs each,
   12 steps): step ms, the host's dispatch of a step onto an idle card,
   busy share, peak memory, graphs captured, K = 4's losses equal to
   K = 1's to the bit with the epoch-tail bundle, and a K = 4 run
   checkpointed off the grid (every 6) and resumed to the same bits;
   recovery — K = 4 runs with ``step_fail@5``, a NaN batch caught by
   ``StepWatchdog(nan_patience=1)``, and SIGTERM sent at a step: each
   recovers or resumes, the steps after it equal the clean run's to the
   bit; profile_window — ``set_profile`` over iterations [2, 4) of a
   K = 2 run writes a trace;
17c. keras_inception — Inception-v1 (1000 classes, dropout 0.4) as
   ``keras.Model(inp, inception_v1()(inp))``, ``compile`` (SGD 0.001,
   momentum 0.9, "nll", top-1 and top-5) and ``fit`` at batch 64 for one
   epoch of train_resnet's 640 images with its 128 for validation: step
   ms, images/s, peak memory, the loss a step, equal to the bit to a
   hand-built ``Optimizer`` on the same Model from the same weights;
   ``predict`` and ``evaluate`` through keras, and ``get_weights`` ->
   ``set_weights`` -> ``predict`` equal to the bit; keras_resnet —
   ResNet-50 (resnet_model()) through keras ``fit`` for 4 steps of
   train_resnet's recipe, its losses equal to the bit to the
   ``Optimizer`` on the bare module;
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
20. train_zero1 — ZeRO-1 data parallelism over ``torch.distributed``:
   (a) ``train_zero1_collectives``: NCCL at world 1 on the card, the
   wire collectives (``reduce_scatter_wire`` fp32, bf16 and int8, the
   int8 delta gather, the fp32 all-gather, and the DCN hop's
   ``psum_wire`` fp32, bf16 and int8) on the LM's flat gradient
   (110,221,824 elements), each eager and then captured in a CUDA graph
   and replayed, every result equal to the bit to the same call over gloo
   on the CPU at world 1, each call's device ms and the int8 codec's
   quantize, dequantize and sum; (b) ``train_zero1_driver``: one process
   a card (world = the card count) trains the LM through
   ``Optimizer.optimize()`` in bundles of 4 (train_lm_bundles' 48 rows,
   12 steps): at world 1 its losses equal the single-process run's to
   the bit; with two or more cards, world min(count, 4) with grad_comm
   fp32 and int8 within 2e-3 of world 1's last loss; step ms, peak
   memory a rank, the byte ledger; (c) ``train_zero1_checkpoint``: two
   gloo processes on the CPU train test_grad_comm's MLP and write a
   sharded checkpoint mid-epoch with a mirror; the card resumes it at
   world 1 (float32 products) on the re-sharded epoch, its losses within
   1e-5 of a CPU resume of the same checkpoint, the mirror equal to the
   primary; (d) ``train_zero1_gloo_card``: two processes on the one card
   try gloo's reduce-scatter, all-to-all and all-gather on CUDA tensors
   (what each did is reported), and when all three run right they train
   the LM run of (b) at K = 1 over gloo, its last loss within 2e-3 of
   the single-process run's;
21. the declarative layouts (``parallel.gspmd``: parameters DTensors on
   a DeviceMesh, the flash kernels reached through ``local_map``), in
   float32 products (``LAYOUT``'s comment says why):
   (a) ``layout_lm``: NCCL at world 1 (a ``file://`` rendezvous);
   ``fit_layout`` trains the LM (batch 8 x 1024, Adam 1e-4, 6 steps of
   48 seeded rows) under ``"dp"``, ``"fsdp"`` and ``"tp"`` (one device
   each here, the policy's axis kept at size 1, so fsdp's and tp's
   ``Shard`` placements, each the whole tensor, go through the LM's ops,
   its attention's ``local_map`` and the vocab lookup): step ms, tokens/s, peak memory, busy share, 12 flash
   forward and 12 + 12 backward launches a step, ``replicated_params``,
   and the losses held to the same 6 steps of a plain single-device
   loop on the same batches (``LAYOUT_LOSS_RTOL``); (b)
   ``layout_serve``: ``InferenceModel(lm, layout="tp")`` at world 1
   (the tp-sharded table's placements on a tp axis of size 1),
   ``predict`` on buckets 1 and 4 equal to the unsharded
   ``InferenceModel``'s to the bit; (c) ``layout_gloo_card``: two
   processes on the one card try the collectives a layout issues on
   CUDA tensors over gloo (``torch.distributed``'s and the functional
   ones DTensor calls), and when they run right train (a)'s LM, cut to
   2 layers at batch 2 x 256 (``LAYOUT``'s comment says why), under
   ``"tp:2"`` over gloo, the last loss within 2e-3 of the same cut run
   in a plain loop; what gloo could not do is reported, and that alone
   fails nothing;
22. the perf gauges and sequence parallelism: (a) ``train_gauges`` and
   ``train_lm_bundles_gauges``, the driver's live accounting of the LM
   runs (``obs.cost`` / ``obs.attr``): ``train.flops_per_step`` within
   2% of the hand figure (12 layers x 2 x 8,192 tokens x 7.08M weights
   plus 12 x 4 x 8 x 1024^2 x 768 for the attention, x 3; the tied head
   counts 0, as in JAX, and is given apart), ``train.mfu`` and
   ``train.effective_mfu`` over the card's dense bfloat16 peak with the
   device name it was resolved from, the hand MFU at the phase's own
   step time, the attribution table, every window's four components
   within 1% of its wall, no unexpected recompile after steady, and the
   CUDA graph captures the sentinel counted equal to the bundle programs
   the phase captured; (b) ``train_zero1_overlap`` (inside train_zero1):
   ``BIGDL_TPU_MEASURE_OVERLAP=1`` at world 1 over NCCL, the audit's
   keys, then train_lm_bundles' K = 4 run to the single-process run's
   bits; (c) ``ring_fold``: the ring's fold on the flash kernels at the
   LM's attention width, 4 blocks of 256 as 4 ranks would hold them,
   causal and not, outputs and gradients against one flash call and the
   plain versions at 2e-5, its launches (causal: 10 forward calls and 10
   backward pairs) and its time beside one call's; (d)
   ``seq_gloo_card``: two gloo processes on the one card with
   ``MeshSpec(seq=2)`` first try the collectives of each strategy on CUDA
   tensors, then train ``SEQ_GLOO``'s model (Embedding,
   ``PositionalEncoding``, 2 causal ``TransformerLayer(768, 12, 3072,
   seq_parallel=...)``, a Linear head; batch 2 x 512, 4 steps, float32)
   with ring and Ulysses attention: the last loss within 2e-3 of the
   unsharded run here, both ranks' losses equal, the flash launches a
   step of each rank; a strategy whose collective gloo cannot carry on
   a CUDA tensor is named;
19b. train_translation — ``Transformer(mode="translation")`` at
   Transformer-base width (6 + 6 layers, d 512, 8 heads, d_ff 2048,
   vocabulary 37,000), dropout 0, batch 32 x source 256 x target 256
   seeded tokens on the reverse task, Adam 5e-4, through the
   ``Optimizer`` at K = 1 and K = 4 (8 steps each) and a profiled K = 4
   run: losses equal to the bit, finite and falling, 18 flash-forward
   and 18 + 18 flash-backward launches a step (encoder, decoder
   self-attention, cross-attention; credited at replay), step ms,
   tokens/s, busy share, peak memory; a float32 gradient check of flash
   against plain attention (translation_gradcheck); greedy and beam (4)
   ``transformer_decode`` and the cached greedy decode of 8 sources to
   64 tokens in float32, the cached tokens held to the uncached ones
   (each first difference a near tie within ``DECODE_GAP_RTOL``);
19c. train_ptb_lstm — ``char_rnn(10000, 650, 650, layers=2)``, PTB's
   medium LM (35 steps, batch 20, SGD 1.0, L2 clipping 5) through the
   ``Optimizer`` at K = 1 and K = 4: the losses equal to the bit,
   tokens/s, step ms, peak memory.
19d. estimator_bert — a stock torch BERT-base classifier (``StockBert``:
   ``torch.nn.TransformerEncoder``, 12 layers, hidden 768, dropout 0.1)
   fine-tuned through ``Estimator.from_torch`` with ``torch.optim.AdamW``
   (2e-5) and ``torch.nn.CrossEntropyLoss``, 640 rows of 128 ids at batch
   32: conversion seconds; K = 1, K = 4 and a profiled K = 4 epoch (step
   ms, sequences/s, peak memory, busy share, 12 flash forward and 12 + 12
   backward launches a step); the losses equal a hand-built Optimizer's
   with ``AdamWeightDecay`` and K = 4's equal K = 1's, to the bit;
   evaluate and predict; the exported ``state_dict`` round trip to the
   bit; the stock module's own float32 forward within BERT_STOCK_ATOL; a
   float32 gradient check of flash against plain attention.
19e. forecast_autoformer, forecast_tcn — ``AutoformerForecaster`` in the
   Autoformer paper's Electricity setting and ``TCNForecaster`` with
   Chronos's defaults, on 1,280 seeded synthetic windows of 321
   variables (input 96, horizon 96): step ms, windows/s, peak memory,
   busy share; losses finite and falling; ``evaluate``; save, load and
   ``predict`` to the bit; the float32 forward on the card against the
   port's CPU forward, with the Autoformer's delays of both.
   (train_translation, train_ptb_lstm, estimator_bert and the forecast
   phases run before train_zero1.)

Compute dtypes.  On the card the port's default compute dtype is
bfloat16 (``tensor.policy``: bfloat16 products with float32 sums, the
JAX package's accelerator policy), so every phase runs in it unless it
says otherwise.  The checks whose reference is float32 semantics run
under ``compute_dtype(torch.float32)`` at their tolerances: gradcheck,
evaluate_lm, resnet_fused, serve_bert_fused's answers, the float32
serve_resnet answers, and the float32 engines' tokens.  Float32 runs
stand beside the bfloat16 ones, alternating in the call: serve and
serve_spec add a float32 graphs engine (``graphs_f32``; two pairs now,
three before), serve_resnet a float32 model, serve_bert_fused and the
two bundle phases float32 runs (``dtype_pairs``), each with its peak
memory.  bfloat16 adds: the block-sparse kernel's bfloat16 instance
(``kernel`` rows ``block_sparse_matmul_bf16``, held within one bfloat16
ulp of its plain version), every served bfloat16 token within
``bf16_gap_tolerance`` of a bfloat16 full forward, graphs equal to eager
and K = 4 to K = 1 to the bit in bfloat16, and the bfloat16 losses
finite and falling beside the float32 run's.

Then the kernel table, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.

Each kernel row also says whether the kernel runs inside a captured
CUDA graph (``in_graph``: one call captured, replayed and held to the
eager call's bits).

``python3 chip_smoke.py --serve-spec`` runs only ``serve`` and
``serve_spec`` (the speculative phase needs serve's spec-off answers):
copied into a checkout of another commit, it runs that commit's port the
same way, for an A/B of the draft's block-sparse kernel in one call
(run parent, change, change, parent).

``python3 chip_smoke.py --phase NAME [NAME ...]`` builds the kernels and
runs only the named phases of keras_inception, keras_resnet,
train_translation, train_ptb_lstm, estimator_bert, forecast_autoformer,
forecast_tcn, train_zero1_collectives, layout_lm (with layout_serve),
layout_gloo_card, serve_keras_int8, serve_prefix, serve_handoff,
serve_spec_window, serve_seq2seq, serve_http, serve_pool, train (with
its gauges), train_lm_bundles (with its gauges), train_zero1_overlap,
ring_fold and seq_gloo_card.

``python3 chip_smoke.py --zero1`` builds the kernels and runs only
``train_zero1`` (its single-process reference run included).

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
import importlib
import json
import multiprocessing as mp
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from collections import Counter

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, TF32, bfloat16 and int8 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
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
# 4 (every 6); train_resnet_bundles and train_resnet_records_bundles run
# one pair each (2 before: the whole script must end within its limit)
BUNDLE = dict(k=4, steps=12, pairs=1, timed_from=4, sync_steps=8,
              ckpt_every=6, records_pairs=1, lm_batches=6)

# train_zero1: the int8 wire's block, timing repetitions, the update
# delta's scale against the gradient for the delta gather, the rows of
# the batch whose gradient the collectives carry; the sharded run's ranks at
# most 4 a run, their last loss within 2e-3 of world 1's (the gate of
# tests/test_distri_optimizer.py); the checkpoint handed from 2 CPU
# ranks: test_grad_comm's MLP on 64 rows, global batch 16, checkpoint at
# 3 (mid-epoch), resumed to 8, the card's losses within 1e-5 of the
# CPU's (float32 products; the sums differ only in order)
ZERO1 = dict(block=1024, reps=10, delta_scale=1e-4, grad_rows=2,
             world_max=4, rel=2e-3, rows=64, batch=16, ckpt_every=3,
             resume_to=8, atol=1e-5, wait_s=900)

# the layout phases (21): fit_layout's LM runs under LAYOUT["policies"]
# at world 1, 4 steps of 32 seeded rows (batch 8 x 1024, Adam 1e-4);
# layout_serve's predict at LAYOUT["serve_seq"] tokens on its buckets;
# the step times are steps 1 to busy_from - 1, the busy share steps
# busy_from on.  layout_gloo_card's "tp:2" run is cut to gloo_layers
# layers at batch gloo_batch x gloo_seq for gloo_steps steps (the widths
# stay): gloo carries each collective through host memory, and at full
# size a step all-gathers the (8, 1024, 32768) logits (1 GB) besides 12
# layers' activations, more than the phase's share of the time limit;
# its last loss within LAYOUT["rel"] of the same cut run's in a plain
# loop in this process (ZERO1["rel"]'s bound: gloo sums the row-split
# products' partials in another order); every gloo wait bounded by
# gloo_wait_s.  Float32 products (compute_dtype pinned): DTensor has
# no sharding rule for the bfloat16 product with a float32 out_dtype, so
# a layout widens those operands to float32 instead (tensor.policy); in
# float32 the layout and the plain loop make the same cuBLAS calls.
LAYOUT = dict(policies=("dp", "fsdp", "tp"), steps=4, serve_seq=128,
              serve_buckets=(1, 4), gloo_policy="tp:2", rel=2e-3,
              busy_from=3, gloo_layers=2, gloo_batch=2, gloo_seq=256,
              gloo_steps=4, gloo_wait_s=300, gloo_probe_s=20)
# the perf gauges (22): train.flops_per_step within MFU_HAND_RTOL of the
# hand figure (_lm_hand_flops), train.mfu within MFU_HAND_RTOL of the hand
# figure over the CUDA-event time of the steps the gauge timed (the
# driver's last timed window), every attribution window's four
# components within ATTR_SUM_RTOL of its wall.  ring_fold: the ring's fold
# over RING["blocks"] blocks at the LM's attention width against one flash
# call and the plain versions at RING["atol"] (the JAX ring test's bound),
# timed over RING["reps"] calls.  seq_gloo_card: SEQ_GLOO's model (the
# LM's widths, 2 causal layers, batch 2 x 512, 4 steps, float32 products)
# on MeshSpec(seq=2) over gloo, its last loss within SEQ_GLOO["rel"]
# (LAYOUT's) of the unsharded run; probes bounded by probe_s, the rest
# by wait_s
MFU_HAND_RTOL = 0.02
ATTR_SUM_RTOL = 0.01
RING = dict(blocks=4, atol=2e-5, reps=10)
SEQ_GLOO = dict(vocab=32768, d=768, heads=12, ffn=3072, layers=2, batch=2,
                seq=512, steps=4, lr=1e-4, strategies=("ulysses", "ring"),
                rel=2e-3, wait_s=300, probe_s=20)
# each layout run's losses against the plain loop's: at world 1 every
# redistribution is a copy within one device and every op the plain
# loop's op on the same operands, so the bound is 0 (equal to the bit)
LAYOUT_LOSS_RTOL = 0.0
# layout_decode (inside layout_lm's world-1 group, float32 products): the
# LM served through InferenceModel(lm, layout="tp", decode=DECODE) with
# its graphs captured by warmup(), the first `requests` of the
# N_REQUESTS prompts of PROMPT_LENS,
# against the unlaid-out graphs engine on a copy of the same weights:
# tokens and summed log-probs equal to the bit (every redistribution a
# copy on one device, LAYOUT_LOSS_RTOL's reason), no capture after
# warmup; then weight_quant="int8" against the unlaid-out int8 engine;
# then a short speculative run (SPEC, eager: spec_prompts prompts,
# spec_max_new tokens) on the layout against the unlaid-out eager one.
LAYOUT_DECODE = dict(layout="tp", requests=8, spec_prompts=2,
                     spec_max_new=16)
# layout_int8_predict: ResNet-50 int8 through InferenceModel(resnet,
# layout="tp", weight_quant="int8") (the generic table's policy for a
# conv net: output channels over tp) at bucket 16 against the unlaid-out
# int8 model, to the bit, float32 products
LAYOUT_INT8 = dict(layout="tp", bucket=16)
# qat_lenet: train_lenet's trained LeNet-5 through prepare_qat, QAT's
# epochs of Adam (lr) through Optimizer.optimize(), convert_qat, then
# InferenceModel.predict of the 1024 validation images at bucket 256;
# the int8 model's top-1 above min_top1
QAT = dict(epochs=2, lr=1e-4, bucket=256, min_top1=0.9)
# lora_bert (inside estimator_bert, on its converted stock BERT-base):
# apply_lora(rank 8, alpha 16) on every Linear node, then rows / batch
# steps through the Estimator with lora_filter as the trainable mask
# (AdamWeightDecay, lr); the base bit-unchanged, the adapters moved;
# merge_lora's float32 forward within merge_atol of the unmerged one
LORA = dict(rank=8, alpha=16.0, rows=192, lr=1e-4, merge_atol=1e-5)

# keras_inception: Inception-v1 (1000 classes, dropout 0.4; NHWC 224^2)
# as keras.Model(inp, inception_v1()(inp)), compiled with SGD (lr 0.001,
# momentum 0.9: random 224^2 images through the v1 tower, which has no
# normalization, start at losses of a few hundred, and 0.01 took a
# CPU probe of 4 steps to NaN), "nll", top-1 and top-5, fit at batch 64
# for one epoch of 640 seeded random images (resnet_train_data's) with
# 128 for validation; then the same run through a hand-built Optimizer
# on the same Model from the same weights, losses equal to the bit.
# keras_resnet: ResNet-50 (resnet_model()) through keras fit for 4 steps
# of train_resnet's recipe against the Optimizer on the bare module.
KERAS = dict(batch=64, lr=0.001, momentum=0.9, dropout=0.4, resnet_steps=4)
# train_translation: Transformer(mode="translation") at Transformer-base
# width (Vaswani et al. 2017, Table 3 "base": 6 + 6 layers, d_model 512,
# 8 heads, d_ff 2048; a shared vocabulary of 37,000 as its WMT En-De
# BPE), dropout 0 (the flash path), batch 32 x source 256 x target 256
# seeded tokens on the reverse task of examples/transformer_translation.py
# (target = the source reversed, teacher-forced after BOS), Adam 5e-4,
# K = 1 then K = 4 for 8 steps each (8 batches an epoch), then a
# profiled K = 4 run; the decoders on 8 sources to max_len 64
TRANSLATION = dict(vocab=37000, d=512, heads=8, ffn=2048, layers=6,
                   batch=32, src=256, tgt=256, lr=5e-4, steps=8,
                   decode_sources=8, max_len=64, beam=4, bos=1, eos=2)
# cached against uncached greedy decoding in float32: the memory is the
# same bits in both; the decoder's 6 layers run ~8 summing stages each
# (self q, k, v, out; cross q, out; the two FFN products), each summing
# up to 2048 float32 terms in another order, a relative error of about
# sqrt(2048 / 2) 2^-24 = 1.9e-6; 48 stages in quadrature give 1.3e-5 of
# the logits' scale, twice that for a gap of two logits: 2.6e-5.  Where
# the tokens differ, the uncached logits' top-two gap at the first
# differing step must be within 1e-4 of max(1, max |logit|) (a factor 4
# of headroom): a near tie, not a fault.
DECODE_GAP_RTOL = 1e-4
# train_ptb_lstm: char_rnn(10000, 650, 650, layers=2), the PTB "medium"
# LM of Zaremba et al. 2014 (35 unrolled steps, batch 20), SGD(1.0) with
# L2 gradient clipping at 5, on seeded random tokens (8 batches an
# epoch), K = 1 then K = 4 for 8 steps each
PTB = dict(vocab=10000, embed=650, hidden=650, layers=2, steps_t=35,
           batch=20, lr=1.0, clip=5.0, steps=8)

# estimator_bert: a stock torch BERT-base encoder (Devlin et al. 2019: 12
# layers, hidden 768, 12 heads, FFN 3072, vocabulary 30,522, dropout 0.1,
# GELU, post-norm) with a pooler (the first token, Linear 768 -> 768,
# tanh) and a two-label head, fine-tuned through Estimator.from_torch with
# torch.optim.AdamW(lr=2e-5) and torch.nn.CrossEntropyLoss on 320 seeded
# rows of 128 token ids at batch 32 (BERT's fine-tuning recipe): one
# epoch, 10 steps, at K = 1 and K = 4, the profiled K = 4 run over one
# bundle.  Cut: no position or token-type
# embeddings (the converter has no arange node), random ids and labels
ESTIMATOR_BERT = dict(vocab=30522, d=768, heads=12, ffn=3072, layers=12,
                      dropout=0.1, length=128, rows=320, batch=32, lr=2e-5,
                      labels=2, check_rows=8)
# the stock module's own float32 forward (erf GELU, on the CPU) against
# the converted model's float32 predict (tanh GELU, ROADMAP C.18): the two
# GELUs differ by at most 4.8e-4 (at |x| = 2.7; the phase measures it);
# per layer the FFN's second product sums 3072 such errors against
# weights of scale 1/sqrt(3 * 3072) (torch's Linear init), at most about
# 2.7e-4 rms a unit, which the LayerNorm after it keeps at the hidden's
# unit scale; 12 layers in quadrature 9.5e-4, through the pooler and head
# about as much in the two logits.  Bound: 5e-3 absolute, five times that
BERT_STOCK_ATOL = 5e-3
GELU_GAP_MAX = 4.8e-4
# forecast_autoformer: AutoformerForecaster in the Autoformer paper's
# Electricity setting (Wu et al. 2021: 321 variables, input 96, horizon 96,
# d_model 512, 8 heads, 2 encoder and 1 decoder layers, d_ff 2048, moving
# average 25, factor 1, batch 32, Adam 1e-4) on 1,280 windows of seeded
# synthetic hourly series (daily and weekly periods plus noise; no
# pandas on the card machine, so numpy (x, y) windows), one epoch, 40
# steps.  forecast_tcn: TCNForecaster on the same windows with
# num_channels [30] * 7, kernel_size 3, dropout 0.1, Adam 1e-3, batch 32
FORECAST = dict(variables=321, lookback=96, horizon=96, windows=1280,
                batch=32, check_windows=8)
AUTOFORMER = dict(d_model=512, n_heads=8, e_layers=2, d_layers=1,
                  d_ff=2048, moving_avg=25, lr=1e-4)
TCN_CFG = dict(num_channels=[30] * 7, kernel_size=3, dropout=0.1, lr=1e-3)
# the float32 forward on the card against the port's CPU forward of the
# same weights, 8 windows: float32 sums in another order (cuBLAS, cuFFT
# and cuDNN against the CPU's), each summing at most 2048 terms, over a
# few dozen stages: far below 1e-4 of max(1, max |y|), the card tests'
# tolerance, which is the bound
FORECAST_ATOL = 1e-4

# speculative decoding of the spec phases: SpecConfig(k=4, sparsity=0.5),
# the draft's FFN blocks (8, 8)
SPEC = dict(k=4, sparsity=0.5)
# the serving phases: an engine replaying CUDA graphs (cuda_graphs=True)
# beside one running the same programs eagerly (cuda_graphs=False), over
# one seeded LM, timed runs alternating eager, graphs, graphs, eager, ...:
# one pair each (serve and serve_spec ran 2 before the serving stack's
# phases joined the script, which must end within its time limit); serve
# and serve_spec add a float32 graphs engine to each pair (eager, graphs,
# graphs_f32, then graphs_f32, graphs, eager); then one profiled run of
# each engine
SERVE_PAIRS = dict(serve=1, spec=1, int8=1)
# the engines of a serving phase, and the compute dtype each runs in
# (None: the card's default, bfloat16)
MODE_DTYPE = {"graphs": None, "eager": None, "graphs_f32": torch.float32}
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
# the block-sparse kernels by the names the profiler gives them: the
# bfloat16 product on wgmma, and the float32 kernel and the bfloat16
# mma.sync one ("block_sparse_matmul_kernel", "..._bf16_kernel")
SPARSE_KERNELS = ("bs_bf16_wgmma_kernel", "block_sparse_matmul")
VERIFY_CHUNK = SPEC["k"] + 1

# the fleet and translation serving phases.  serve_keras_int8: chip_smoke's
# BERT-base keras encoder through InferenceModel(weight_quant="int8") and
# quantize(calibrate(...)) per tensor and per channel (minmax over 16
# batches of 8 seeded sequences), and the IR "fused" model, float32
# products; requests of 1, 3, 16 and 50 sequences, then 10 of 64.
KERAS_INT8 = dict(requests=(1, 3, 16, 50), throughput=(10, 64),
                  calib_batches=16, calib_rows=8)
# int8 against the float model's answers, max |log-prob difference| over
# max |log-prob|.  Derived before the first run as INT8_LOGP_RTOL: a
# dynamic (per-row) layer adds a relative RMS error of sqrt(2/12) *
# (abs-max / RMS) / 127 = 0.013 for a row's abs-max / RMS of 4 (768 or 3072
# near-Gaussian values: 3.2 sigma); the encoder's 26 Dense nodes in
# quadrature give 0.013 * sqrt(26) = 0.066 of the logits' spread, which
# max |log-prob| bounds: budget 0.1.  A calibrated (static) layer scales by
# the abs-max of the whole calibration set, about 5.5 RMS for 32 x 128
# rows (the GELU output's tail longer): 0.018 a layer, 0.09 over 26:
# budget 0.15.  Per channel, calibrate keeps 8192 values of a batch, so a
# channel's maximum comes from 16 x 8192 / C rows: 160 for the 768-wide
# inputs (2.6 sigma), 32 for the FFN's 3072-wide GELU output (2.0
# sigma), and served values past it clip.  A Gaussian's clipped excess
# E[(X - t)^2; X > t] is 0.0017 sigma^2 at t = 2.6 and 0.0085 at 2.0, a
# relative RMS error of 0.04 and 0.09 a layer; 14 + 12 such layers with
# the 0.018 rounding of each, in quadrature: sqrt(14 * 0.0016 + 12 *
# 0.0081 + 26 * 0.0003) = 0.36: the first budget, 0.4.  Two runs on an
# H100 measured 0.113, and 0.4 sits near the max |log-prob| (about 1)
# of this 2-label head, so the budget is now 0.2, and a control must
# drift past it: the per-channel model with every activation scale a
# quarter of the calibrated one (clipping at a quarter of each
# channel's maximum).
BERT_INT8_LOGP_RTOL = 0.1
BERT_INT8_CALIB_LOGP_RTOL = {"tensor": 0.15, "channel": 0.2}
BERT_INT8_CONTROL_SCALE = 0.25
# each int8 model's argmax equals the float model's on at least this
# share of the rows (134 in all): a model that lost its input agrees
# only on the rows of the label it is stuck at
BERT_INT8_TOP1_FLOOR = 0.9
# serve_prefix: the LM with prefix_cache_pages=128; one warm request of a
# seeded 448-token system prefix (28 pages of 16), then 15 requests of that
# prefix plus 64 distinct tokens, 16 new tokens each
PREFIX = dict(pages=128, prefix=448, suffix=64, requests=15, max_new=16)
# serve_handoff: 8 prefill-only requests of 512 tokens on engine A,
# imported on B with 32 new tokens; then 8 live requests of 128 new tokens
# migrated from A to B once each has its 8th token (the engine runs on
# while the caller takes the lock: 128 leaves it room)
HANDOFF = dict(requests=8, prompt=512, max_new=32, live_new=128,
               migrate_after=8)
# serve_spec_window: serve_spec's speculation with draft_window=128, 16
# prompts of 512 tokens (every cache bucket past 128 positions windowed)
SPEC_WINDOW = dict(window=128, prompt=512)
# serve_seq2seq: the Transformer-base translation model (TRANSLATION)
# through Seq2SeqService(continuous=True), 16 seeded sources of 16, 32,
# 48 and 64 tokens (four each), max_len 64, 16 slots of 5 pages of 16;
# beam 4 over 4 sources of 32
SEQ2SEQ = dict(src_lens=(16, 32, 48, 64), per_len=4, max_len=64,
               src_buckets=(16, 32, 64), beam=4, beam_sources=4,
               beam_len=32)

# serve_http: the HTTP serving stack.  One ServingServer with two tenants
# behind an HttpFrontend on 127.0.0.1:0: "lm" (the LM, float32 pages, its
# graphs captured at warmup) and "bert_int8" (bert_model rebuilt by the
# IR "fused" rewrite, weight_quant="int8", BERT_BUCKETS).  At once: the
# 16 streamed greedy /generate requests of serve's prompts (32 new
# tokens), one client thread each, and 4 client threads of 10 /predict
# requests of 1-16 seeded sequences of 128 token ids.  Tracing on, a TTFT
# SLO on the LM tenant.
HTTP = dict(predict_clients=4, predict_requests=10, max_rows=16,
            ttft_slo_s=2.0, slo_window_s=60.0)
# predictions over HTTP against the same InferenceModel's predict of the
# batches the server assembled (each serving/batch span's request ids,
# their rows in that order), run again on the main thread once the
# server has stopped: max |log-prob difference| over max |log-prob|.
# The same rows in the same bucket on the same kernels: budget 1e-4.  A
# server that answered a request with another request's rows, or
# computed otherwise on its predict thread, lands far past it; the
# control, each answer against its batch's rows shifted by one, must.
# Against each request's rows predicted alone the answers are reported,
# not held (C.2): a request of 1-4 rows runs alone in bucket 1 or 4, M
# = 128 or 512 token rows, where cuBLAS rounds the float32 attention
# projections' rows otherwise than at M >= 2048, and the int8 model
# answers a one-ulp change anywhere with a drift of the order of its
# own int8 error (both measured beside it).
HTTP_PREDICT_RTOL = 1e-4
# serve_pool: a ServingPool of 2 worker processes on the card, each the
# LM with int8 pages warmed at load (_pool_lm_loader); 8 streamed greedy
# requests of serve's first 8 prompts, 128 new tokens each so that a
# worker killed after every stream's second token holds live streams
POOL = dict(workers=2, requests=8, max_new=128, spawn_timeout_s=300.0)

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
# the block-sparse product's bfloat16 instance against its plain version
# (the float32 masked product of the widened operands, rounded once to
# bfloat16): each element within one bfloat16 step of the larger
# magnitude, a float32 sum in another order rounding to the neighbour;
# the step floored at the float32 sums' own noise, sqrt(K) 2^-24 of the
# largest |value|, where an element cancels to near zero
BF16_ULP_TOLERANCE = ("one bf16 ulp elementwise, floored at "
                      "sqrt(K) 2^-24 max|out|")
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
# bfloat16 against float32 ResNet-50 answers, max |log-prob difference|
# over max |log-prob|.  Derived before the first run: each of the 54
# products rounds three operands to bfloat16 (the activation, the weight
# and, for a conv, its output), each an independent relative error
# within +-2^-8, RMS 2^-8 / sqrt(3) = 2.3e-3: 3.9e-3 a layer; over 54
# layers in quadrature, undamped, 0.029 of the logits' spread; the
# largest of 134 x 1000 log-probs sits within 4.5 RMS (a Gaussian's tail
# at 1 / 134000): 0.13, and max |log-prob| bounds the spread.  Budget
# 0.15.
BF16_LOGP_RTOL = 0.15
# the fold of a BatchNorm into the conv before it rounds the folded weights
# to float32 once: fused ResNet-50 predict within 1e-4 of max |log-prob|
# of the unfused model's
FOLD_LOGP_RTOL = 1e-4


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the script
    started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 3)}
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


def _bound_bf16(nbytes: float, flops: float) -> dict:
    """The bound of a product on bfloat16 operands: the bytes over HBM's
    rate or the operations over the bfloat16 tensor-core peak, whichever
    is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def _bf16_ulp_excess(got, want, terms) -> float:
    """The largest amount by which ``got`` sits past one bfloat16 ulp of
    ``want`` (of the larger magnitude), elementwise: <= 0 when every
    element is within one ulp.  The ulp is floored at the float32 sum's
    own noise, sqrt(terms) 2^-24 of the largest |value|: where a sum of
    ``terms`` products cancels to near zero, its bfloat16 step is finer
    than two float32 sums in different orders stand apart."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=terms ** 0.5 * 2.0 ** -24 * float(want.abs().max()))
    return float(((got - want).abs() - ulp).max())


def check_block_sparse_bf16(dev, flush):
    """The block-sparse product's bfloat16 instance at the draft FFN's
    shapes in bfloat16 products — M = 16 (a decode step of 16 slots) and
    256 (a prefill call), K/N = 768/3072 (l1) and 3072/768 (l2), the
    draft's (8, 8) blocks, half of them kept — against the plain version
    (the float32 masked product of the widened operands, rounded once):
    every element within one bfloat16 ulp (``BF16_ULP_TOLERANCE``), twice
    on the same inputs and inside a captured graph for the same bits.
    Each shape's row names the path the kernel took (``bf16_plan``: wgmma
    tiles and splits of K) and times it beside the mma.sync kernel on the
    same inputs (the path of shapes wgmma cannot take, the whole kernel
    before its wgmma path), held to the same tolerance.  A shape with K
    not a multiple of 8 takes the mma.sync path by itself and is held the
    same way.  The yardstick is ``torch.matmul`` of the bfloat16 operands
    with the masked weight; the bound is the bytes at 2 bytes a value or
    the bfloat16 tensor-core rate.  The row reports the draft step's
    l1."""
    from bigdl_tpu_torch.ops.block_sparse import (Bf16Plan, ColumnPlan,
                                                  _bs_bf16, _bs_raw,
                                                  bf16_plan,
                                                  block_sparse_matmul_ref)

    d, f = LM["hidden_size"], LM["ffn_size"]
    rs = np.random.RandomState(SEED + 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mma_sync = Bf16Plan("mma_sync", 0, 0, 1, 0)

    def held(name, out, ref, k):
        excess = _bf16_ulp_excess(out, ref, k)
        if out.dtype != torch.bfloat16 or excess > 0:
            raise AssertionError(f"{name}: {out.dtype}, {excess} past one "
                                 f"bf16 ulp of the plain version")
        return float((out.float() - ref.float()).abs().max())

    rows, worst = [], 0.0
    shapes = [(m, k, n, SPARSE_BLOCK) for k, n in ((d, f), (f, d))
              for m in (16, 256)] + [(16, 772, 384, (4, 8))]
    for m, k, n, blk in shapes:
        nkb, nnb = -(-k // blk[0]), -(-n // blk[1])
        mask = np.zeros(nkb * nnb, bool)
        mask[rs.permutation(nkb * nnb)[: nkb * nnb // 2]] = True
        plan = ColumnPlan(mask.reshape(nkb, nnb), *blk)
        g = torch.Generator().manual_seed(SEED)
        w = torch.randn(k, n, generator=g).to(dev).bfloat16()
        wm = torch.where(plan.on(w.device, k, n)[2], w, 0.0)
        kept = int(mask.sum()) * blk[0] * blk[1]
        x = torch.randn(m, k, generator=g).to(dev).bfloat16()
        tp = bf16_plan(m, k, n, blk[1], True, sms)
        out = _bs_raw(x, w, plan)
        again = _bs_raw(x, w, plan)
        ref = block_sparse_matmul_ref(x, w, plan)
        old = _bs_bf16(x, w, plan, mma_sync)
        torch.cuda.synchronize()
        shape = {"m": m, "k": k, "n": n, "block": list(blk),
                 "density": float(mask.mean()), "dtype": "bfloat16"}
        _assert_bit_equal(f"block_sparse_matmul_bf16 {shape}", [out],
                          [again])
        err = held(f"block_sparse_matmul_bf16 {shape}", out, ref, k)
        held(f"block_sparse_matmul_bf16 mma.sync {shape}", old, ref, k)
        worst = max(worst, err)
        graph = _in_graph(lambda: _bs_raw(x, w, plan), out)
        if not graph["in_graph"]:
            raise AssertionError(f"block_sparse_matmul_bf16 {shape} in "
                                 f"a graph: {graph}")
        r = _share({
            "shape": shape, "path": tp.path, "tile_m": tp.tile_m,
            "splits": tp.splits, "chunks_per_split": tp.chunks_per_split,
            "blocks": tp.blocks, "max_abs_err": err,
            "within_one_bf16_ulp": True, "bit_equal": True,
            "ms": time_cold(lambda: _bs_raw(x, w, plan), flush),
            "mma_sync_ms": time_cold(lambda: _bs_bf16(x, w, plan, mma_sync),
                                     flush),
            "plain_ms": time_cold(
                lambda: block_sparse_matmul_ref(x, w, plan), flush),
            "library_ms": time_cold(lambda: torch.matmul(x, wm), flush),
            **_bound_bf16(2 * (m * k + kept + m * n), 2 * m * kept),
            **graph})
        emit({"phase": "kernel", "name": "block_sparse_matmul_bf16",
              "tolerance": BF16_ULP_TOLERANCE, **r})
        rows.append(r)
    main = rows[0]          # M = 16, l1 (768 -> 3072)
    keys = ("shape", "path", "tile_m", "splits", "blocks", "ms",
            "mma_sync_ms", "plain_ms", "bound_ms", "bound_by", "share",
            "library_ms")
    return {"name": "block_sparse_matmul_bf16", "route": "cuda",
            "source": "bigdl_tpu_torch/ops/csrc/block_sparse_matmul.cu",
            "replaces": "bigdl_tpu/ops/block_sparse.py:148",
            "launches": None, "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "share": main["share"], "shape": main["shape"],
            "path": main["path"], "tile_m": main["tile_m"],
            "splits": main["splits"], "mma_sync_ms": main["mma_sync_ms"],
            "in_graph": main["in_graph"],
            "tolerance": BF16_ULP_TOLERANCE,
            "other_shapes": [{k: r[k] for k in keys} for r in rows[1:]]}


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


def bf16_gap_tolerance(rows):
    """How far below the top logit a bfloat16 token may sit, per row of
    the reference logits, derived from bfloat16's rounding step: a value
    rounded to bfloat16 (8 significant bits) moves by at most 2^-8 of
    itself.  The served run and the full forward round the same bfloat16
    weights, so only their rounded activations can differ: a layer
    rounds four product inputs (the LayerNorm output feeding q/k/v, the
    attention output feeding wo, the LayerNorm output feeding the FFN,
    the FFN's hidden state) and the head one (the final hidden state).
    Counting each once, undamped, the logits of the two runs differ by
    at most (4 num_layers + 1) 2^-8 of the row's largest |logit|.  The
    served token maximised its own run's logits, so its reference logit
    sits at most twice that below the top one:
    2 (4 num_layers + 1) / 256 * max|logit| of the row."""
    return 2 * (4 * LM["num_layers"] + 1) / 256.0 * rows.abs().amax(dim=1)


def _spec_launches_check(launches, steps, calls, k, name,
                         kernel="block_sparse_matmul"):
    """Hard check of a speculative run: every draft FFN of every draft
    step and draft prefill call went through the block-sparse kernel
    (``kernel``: its float32 or bfloat16 instance)."""
    L = LM["num_layers"]
    want_bs = 2 * L * (k + 1) * steps + 2 * L * calls
    if launches.get(kernel, 0) != want_bs:
        raise AssertionError(f"{name}: {kernel} launched "
                             f"{launches.get(kernel, 0)} "
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


def _dtype(mode):
    """The compute-dtype context a serving mode runs in."""
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    dt = MODE_DTYPE[mode]
    return compute_dtype(dt) if dt is not None else contextlib.nullcontext()


def _lm_pair(dev, weight_quant=None, modes=("graphs", "eager"), **cfg):
    """InferenceModels of the seeded LM, one a mode: ``graphs`` replays
    CUDA graphs (``cuda_graphs=True``), ``eager`` runs the same programs
    eagerly (``cuda_graphs=False``), ``graphs_f32`` replays graphs
    captured in float32 products; each warmed up in its compute dtype:
    ({mode: im}, {mode: warmup row})."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    model = Transformer(**LM, dropout=0.0, seed=SEED)
    pair, rows = {}, {}
    for mode in modes:
        im = InferenceModel(model, decode=DecodeConfig(
            **DECODE, cuda_graphs=mode != "eager", **cfg), device=dev,
            weight_quant=weight_quant)
        pair[mode] = im
        eng = im.decode_engine
        eng.metrics = _sample_metrics()
        torch.cuda.synchronize()
        with _dtype(mode):
            im.warmup()
        pool = eng.graph_pool_bytes()
        rows[mode] = {
            "warmup_s": eng.warmup_s, "graphs_captured": eng.graphs_captured,
            "graph_captures_counted": eng.metrics.counter(
                "serving.decode.graph_captures"),
            "graph_pool_gb": None if pool is None else pool / 2**30,
            "graph_dtype": str(eng.graph_dtype),
            "closed_set": len(eng.closed_set())}
    return pair, rows


def _percentile_ms(samples, q):
    return 1e3 * float(np.percentile(samples, q)) if samples else None


def _serve_run(im, prompts, mode="graphs"):
    """One timed ``generate`` of ``prompts`` on ``im`` in ``mode``'s
    compute dtype, its engine on a fresh metrics registry: a dict of the
    results, wall s, launches, the engine's stats delta and the run's
    row."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches

    eng = im.decode_engine
    eng.metrics = _sample_metrics()
    before = dict(eng.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with _dtype(mode):
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


def _serve_pairs(pair, prompts, n_pairs, name, busy=None, named=()):
    """``n_pairs`` timed runs of each engine, alternating eager, graphs
    (graphs_f32 where the pair has it), then graphs_f32, graphs, eager,
    ...: every run's tokens and log-probs equal to the bit to the first
    run of its compute dtype (eager's for bfloat16), and every run's
    launches equal to that run's (a replay credits its capture's
    counts); then one profiled run of each engine in ``busy`` (the
    modes to profile; None: every mode) for the device's busy share (the
    device time of the kernels whose names hold a substring of
    ``named``).  Returns {mode: summary} and the first run of each
    mode."""
    first = [m for m in ("eager", "graphs", "graphs_f32") if m in pair]
    order = []
    for i in range(n_pairs):
        order += first if i % 2 == 0 else first[::-1]
    runs = {mode: [] for mode in first}
    for mode in order:
        run = _serve_run(pair[mode], prompts, mode)
        emit({"phase": f"{name}_run", "mode": mode,
              "compute_dtype": str(MODE_DTYPE[mode] or torch.bfloat16)[6:],
              "run": len(runs[mode]), **run["row"]})
        runs[mode].append(run)
    refs = {}
    for mode in order:     # the first run of each dtype is its reference
        refs.setdefault(MODE_DTYPE[mode], runs[mode][0])
    for mode, rs in runs.items():
        ref = refs[MODE_DTYPE[mode]]
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
        if "spec_draft_step_ms_p50" in rows[0]:
            summary[mode]["spec_draft_step_ms_p50"] = [
                r["spec_draft_step_ms_p50"] for r in rows]
        if mode != "eager":
            summary[mode]["replay_host_ms"] = _replay_host_ms(
                pair[mode].decode_engine)
        if busy is None or mode in busy:
            with _dtype(mode):
                prof = _profile(lambda im=pair[mode]: im.generate(prompts),
                                named)
            summary[mode]["device_busy_share"] = prof["device_busy_share"]
            if named:
                summary[mode]["named"] = prof["named"]
            emit({"phase": f"{name}_profile", "mode": mode, **prof})
    summary["bits_equal"] = True
    return summary, {mode: rs[0] for mode, rs in runs.items()}


def serve(dev):
    """Drive the serving main path: the seeded LM answers the requests
    through ``InferenceModel.generate``, an engine replaying CUDA graphs
    beside one running the same programs eagerly (bfloat16 products, the
    card's default) and one replaying graphs captured in float32, and
    check what comes out."""
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    t0 = time.perf_counter()
    pair, setup = _lm_pair(dev, modes=("graphs", "eager", "graphs_f32"))
    try:
        setup_s = time.perf_counter() - t0
        rs = np.random.RandomState(SEED)
        prompts = [rs.randint(2, LM["vocab_size"], n).astype(np.int32)
                   for n in rs.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                       N_REQUESTS)]
        modes, first = _serve_pairs(pair, prompts, SERVE_PAIRS["serve"],
                                    "serve")
        run = first["graphs"]
        results, launches = run["results"], run["launches"]
        steps = run["delta"]["steps"]
        want = LM["num_layers"] * steps
        for mode, r in first.items():
            n = r["launches"].get("paged_decode_attention", 0)
            if r["delta"]["steps"] < 1 or n != want \
                    or r["delta"]["steps"] != steps:
                raise AssertionError(f"{mode}: paged_decode_attention "
                                     f"launched {r['launches']} times over "
                                     f"{r['delta']['steps']} decode steps "
                                     f"of {LM['num_layers']} layers")
        im = pair["graphs"]
        # every bfloat16 token against a bfloat16 full uncached forward of
        # the same model: finite logits, each token within
        # bf16_gap_tolerance of its row's top logit
        worst_gap, worst_logp = check_tokens(im, prompts, results, dev,
                                             bf16_gap_tolerance)
        # the float32 engine's tokens against a float32 full forward: the
        # token within 1e-3 of the top logit, the request's summed
        # log-prob within 1e-3
        f32 = first["graphs_f32"]["results"]
        with compute_dtype(torch.float32):
            f32_gap, f32_logp = check_tokens(pair["graphs_f32"], prompts,
                                             f32, dev)
        if f32_gap > 1e-3 or f32_logp > 1e-3:
            raise AssertionError(f"float32 served tokens disagree with the "
                                 f"full forward: logit gap {f32_gap}, logp "
                                 f"{f32_logp}")
        # continuous vs static decoding on the card: reported, not assumed
        eng = im.decode_engine
        from bigdl_tpu_torch.serving import DecodeRequest

        static = eng.static_generate([DecodeRequest(tokens=p)
                                      for p in prompts])
        agree = sum(a.tokens.tolist() == b.tokens.tolist()
                    for a, b in zip(results, static))
        f32_agree = sum(a.tokens.tolist() == b.tokens.tolist()
                        for a, b in zip(results, f32))
        n_tok = int(sum(len(r.tokens) for r in results))
        tps = float(np.median(modes["graphs"]["tokens_per_s"]))
        emit({"phase": "serve", "model": LM, "decode": DECODE,
              "compute_dtype": "bfloat16",
              "requests": len(results), "answered": len(results),
              "finish_reasons": sorted({r.finish_reason for r in results}),
              "prompt_tokens": int(sum(len(p) for p in prompts)),
              "generated_tokens": n_tok, "decode_steps": steps,
              "prefill_calls": run["delta"]["prefill_calls"],
              "launches": launches, "nan_logits": False,
              "max_logit_gap": worst_gap,
              "gap_tolerance": f"2 * (4 * {LM['num_layers']} + 1) / 256 * "
                               f"max|logit| of the row",
              "max_logp_err": worst_logp,
              "f32_max_logit_gap": f32_gap, "f32_max_logp_err": f32_logp,
              "f32_agree": f"{f32_agree}/{len(results)}",
              "static_agree": f"{agree}/{len(results)}",
              "kv_bytes_per_page": eng.kv_bytes_per_page(),
              "tokens_per_s": tps,
              "f32_tokens_per_s": float(np.median(
                  modes["graphs_f32"]["tokens_per_s"])),
              "setup_s": setup_s, "warmup": setup, "modes": modes})
        return launches, prompts, results, tps
    finally:
        for im in pair.values():
            im.stop()


def serve_spec(dev, prompts, ref_results, ref_tps):
    """Drive the speculative serving path, graphs beside eager (bfloat16)
    and a float32 graphs engine, and check what comes out: the bfloat16
    draft FFNs on the bfloat16 block-sparse kernel, the float32 ones on
    the float32 kernel.  Returns the bfloat16 graphs run's launches and
    the engines (serve_sweep runs on them next)."""
    from bigdl_tpu_torch.serving import SpecConfig
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    t0 = time.perf_counter()
    pair, setup = _lm_pair(dev, modes=("graphs", "eager", "graphs_f32"),
                           speculative=SpecConfig(**SPEC))
    try:
        setup_s = time.perf_counter() - t0
        # the graphs engine's profile only (the block-sparse device ms
        # read below): the three took 56 of the script's 986 s on one H100
        modes, first = _serve_pairs(pair, prompts, SERVE_PAIRS["spec"],
                                    "serve_spec", busy=("graphs",),
                                    named=SPARSE_KERNELS)
        run = first["graphs"]
        results, launches, d = run["results"], run["launches"], run["delta"]
        steps, calls = d["steps"], d["prefill_calls"]
        L = LM["num_layers"]
        for mode, r in first.items():
            n, dm = r["launches"], r["delta"]
            if dm["steps"] < 1 or n.get("paged_verify_attention", 0) \
                    != L * dm["steps"]:
                raise AssertionError(f"{mode}: paged_verify_attention "
                                     f"launched {n} times over "
                                     f"{dm['steps']} speculative iterations "
                                     f"of {L} layers")
            f32 = MODE_DTYPE[mode] == torch.float32
            kernel, other = ("block_sparse_matmul", "block_sparse_matmul_bf16")
            if not f32:
                kernel, other = other, kernel
            _spec_launches_check(n, dm["steps"], dm["prefill_calls"],
                                 SPEC["k"], f"serve_spec {mode}", kernel)
            if n.get(other):
                raise AssertionError(f"serve_spec {mode}: {other} launched "
                                     f"{n[other]} times")
        im = pair["graphs"]
        gap, dlogp = check_tokens(im, prompts, results, dev,
                                  bf16_gap_tolerance)
        with compute_dtype(torch.float32):
            f32_gap, f32_logp = check_tokens(
                pair["graphs_f32"], prompts,
                first["graphs_f32"]["results"], dev)
        if f32_gap > 1e-3:
            raise AssertionError(f"float32 speculative tokens disagree with "
                                 f"the full forward: logit gap {f32_gap}")
        n_tok = int(sum(len(r.tokens) for r in results))
        agree = sum(a.tokens.tolist() == b.tokens.tolist()
                    for a, b in zip(results, ref_results))
        emit({"phase": "serve_spec", "spec": SPEC,
              "sparse_block": list(SPARSE_BLOCK), "requests": len(results),
              "answered": len(results), "generated_tokens": n_tok,
              "spec_iterations": steps, "prefill_calls": calls,
              "launches": launches, "compute_dtype": "bfloat16",
              "max_logit_gap": gap,
              "gap_tolerance": f"2 * (4 * {L} + 1) / 256 * max|logit| of "
                               f"the row",
              "max_logp_err": dlogp, "f32_max_logit_gap": f32_gap,
              "f32_max_logp_err": f32_logp,
              "f32_launches": first["graphs_f32"]["launches"],
              "drafted": d["spec_drafted"], "accepted": d["spec_accepted"],
              "rejected": d["spec_rejected"],
              "accept_rate": d["spec_accepted"] / max(d["spec_drafted"], 1),
              "tokens_per_iteration": n_tok / max(steps, 1),
              "spec_off_agree": f"{agree}/{len(results)}",
              "tokens_per_s": float(np.median(
                  modes["graphs"]["tokens_per_s"])),
              "f32_tokens_per_s": float(np.median(
                  modes["graphs_f32"]["tokens_per_s"])),
              "spec_off_tokens_per_s": ref_tps, "setup_s": setup_s,
              "block_sparse": {
                  "device_ms": modes["graphs"]["named"],
                  "spec_draft_step_ms_p50": modes["graphs"].get(
                      "spec_draft_step_ms_p50"),
                  "tokens_per_s": modes["graphs"]["tokens_per_s"]},
              "warmup": setup,
              "kv_bytes_per_page": im.decode_engine.kv_bytes_per_page(),
              "modes": modes})
        return {m: r["launches"] for m, r in first.items()}, pair
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
            # the graphs engine's profile only: the eager engines' took 61
            # of the script's 950 s on one H100
            modes, first = _serve_pairs(pair, prompts,
                                        SERVE_PAIRS["int8"], "serve_int8",
                                        busy=("graphs",))
            run = first["graphs"]
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
                                     SPEC["k"], "serve_int8 spec",
                                     "block_sparse_matmul_bf16")
            im = pair["graphs"]
            # int8 pages and weights in bfloat16 products: the two
            # tolerances add
            gap, dlogp = check_tokens(
                im, prompts, results, dev,
                lambda rows: int8_gap_tolerance(rows)
                + bf16_gap_tolerance(rows))
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
                   "compute_dtype": "bfloat16",
                   "gap_tolerance": f"(2 * {L} / 254 + 2 * (4 * {L} + 1) / "
                                    f"256) * max|logit| of the row",
                   "max_logp_err_vs_forward": dlogp,
                   "serve_agree": f"{agree}/{len(results)}",
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


def _counting(module, name, counter):
    """Patch ``module.name`` to count its calls into ``counter[name]``;
    returns the undo."""
    fn = getattr(module, name)

    def counted(*a, **kw):
        counter[name] += 1
        return fn(*a, **kw)

    setattr(module, name, counted)
    return lambda: setattr(module, name, fn)


def serve_keras_int8(dev, cfg=BERT):
    """The BERT-base keras encoder served int8 (keras ``quantize`` /
    ``calibrate``): ``InferenceModel(m, weight_quant="int8")`` (dynamic
    per-row activations), ``quantize(m, calibrate(m, batches))`` per
    tensor and per channel (static activations), and the IR ``"fused"``
    model with ``weight_quant="int8"``.  Every bucket call launches the
    int8 kernel once per Dense node of the graph (and, fused, the
    LayerNorm kernel once per LayerNorm node); the plain versions never
    run.  Answers are held to the float model's, in float32 products
    (the caller's ``compute_dtype``)."""
    from bigdl_tpu_torch.keras.engine import Model as KModel
    from bigdl_tpu_torch.nn import Linear
    from bigdl_tpu_torch.nn.quantized import (QuantizedLinear, calibrate,
                                              quantize)
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.ops import fused as fused_mod
    from bigdl_tpu_torch.ops import quantized as q8
    from bigdl_tpu_torch.serving import InferenceModel
    from bigdl_tpu_torch.utils.intermediate import IRGraph

    t0 = time.perf_counter()
    model = bert_model(cfg).to(dev)
    n_dense = sum(type(n.layer) is Linear for n in model.order)
    n_ln = 1 + 2 * cfg["layers"]
    rs = np.random.RandomState(SEED + 5)

    def tokens(n):
        return rs.randint(0, cfg["vocab"], (n, cfg["length"])).astype(
            np.int32)

    requests = [tokens(n) for n in KERAS_INT8["requests"]]
    n_tp, b_tp = KERAS_INT8["throughput"]
    burst = tokens(b_tp)
    batches = [torch.from_numpy(tokens(KERAS_INT8["calib_rows"])).to(dev)
               for _ in range(KERAS_INT8["calib_batches"])]
    ref = InferenceModel(model, device=dev, batch_buckets=BERT_BUCKETS)
    refs = [ref.predict(x) for x in requests + [burst]]
    ims = {"dynamic": (InferenceModel(model, device=dev, weight_quant="int8",
                                      batch_buckets=BERT_BUCKETS),
                       BERT_INT8_LOGP_RTOL)}
    for gran in ("tensor", "channel"):
        calib = calibrate(model, batches, method="minmax", granularity=gran)
        if len(calib) != n_dense:
            raise AssertionError(f"calibrate ({gran}) recorded {len(calib)} "
                                 f"nodes of {n_dense}")
        ims[f"calibrated_{gran}"] = (
            InferenceModel(quantize(model, calib), device=dev,
                           batch_buckets=BERT_BUCKETS),
            BERT_INT8_CALIB_LOGP_RTOL[gran])
    fused = IRGraph.from_model(model).to_model("fused")
    ims["fused_dynamic"] = (InferenceModel(fused, device=dev,
                                           weight_quant="int8",
                                           batch_buckets=BERT_BUCKETS),
                            BERT_INT8_LOGP_RTOL)
    # the control: wrong scales must fail the per-channel bound
    wrong = {k: v * BERT_INT8_CONTROL_SCALE for k, v in calib.items()}
    control = "control_channel_scales_x%g" % BERT_INT8_CONTROL_SCALE
    ims[control] = (InferenceModel(quantize(model, wrong), device=dev,
                                   batch_buckets=BERT_BUCKETS),
                    BERT_INT8_CALIB_LOGP_RTOL["channel"])
    for im, _ in ims.values():
        im.warmup(requests[0])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows, failures = {}, []
    for tag, (im, rtol) in ims.items():
        if not isinstance(im.model, KModel):
            raise AssertionError(f"{tag}: serves {type(im.model).__name__}")
        twins = sum(isinstance(n.layer, QuantizedLinear)
                    for n in im.model.order)
        calls, plain = [], Counter()
        hook = im.model.register_forward_pre_hook(
            lambda m, a: calls.append(a[0].shape[0]))
        undo = [_counting(q8, "int8_matmul_plain", plain),
                _counting(fused_mod, "fused_layernorm_plain", plain)]
        try:
            torch.cuda.synchronize()
            reset_launches()
            outs = [im.predict(x) for x in requests]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(n_tp):
                last = im.predict(burst)
            torch.cuda.synchronize()
            tp_s = time.perf_counter() - t1
            launches = dict(LAUNCHES)
        finally:
            for u in undo:
                u()
            hook.remove()
        outs.append(last)
        worst = max(float(np.abs(y - r).max() / np.abs(r).max())
                    for y, r in zip(outs, refs))
        agree = sum(int((y.argmax(1) == r.argmax(1)).sum())
                    for y, r in zip(outs, refs))
        total = sum(r.shape[0] for r in refs)
        want = {"int8_matmul": n_dense * len(calls),
                "flash_attention_fwd": cfg["layers"] * len(calls)}
        if tag.startswith("fused"):
            want["fused_layernorm"] = n_ln * len(calls)
        rows[tag] = {"dense_nodes": n_dense, "int8_twins": twins,
                     "bucket_calls": calls, "launches": launches,
                     "want_launches": want, "plain_calls": dict(plain),
                     "max_logp_rel_err_vs_float": worst, "rtol": rtol,
                     "top1_agree_vs_float": f"{agree}/{total}",
                     "top1_floor": BERT_INT8_TOP1_FLOOR,
                     "sequences_per_s_bucket_64": n_tp * b_tp / tp_s,
                     "weight_bytes_at_rest": sum(
                         b.numel() * b.element_size()
                         for n, b in im.model.named_buffers()
                         if n.rsplit(".", 1)[-1] in ("weight_q", "scales"))}
        if twins != n_dense or any(launches.get(k, 0) != v
                                   for k, v in want.items()) or plain \
                or not all(np.isfinite(y).all() for y in outs):
            failures.append(f"{tag}: twins {twins} of {n_dense}, launches "
                            f"{launches} (want {want}), plain {dict(plain)}")
        if tag == control:
            if worst <= rtol:
                failures.append(f"{tag}: wrong scales drift {worst}, within "
                                f"the per-channel bound {rtol}")
            continue
        if worst > rtol:
            failures.append(f"{tag}: {worst} of max |log-prob| from the "
                            f"float model's, past {rtol}")
        if agree < BERT_INT8_TOP1_FLOOR * total:
            failures.append(f"{tag}: top-1 {agree}/{total} against the "
                            f"float model, under {BERT_INT8_TOP1_FLOOR}")
    emit({"phase": "serve_keras_int8", "model": cfg,
          "compute_dtype": "float32", "requests": list(KERAS_INT8[
              "requests"]), "throughput": {"requests": n_tp,
                                           "sequences": b_tp},
          "calibration": {"method": "minmax",
                          "batches": KERAS_INT8["calib_batches"],
                          "rows": KERAS_INT8["calib_rows"]},
          "float_labels": np.bincount(
              np.concatenate([r.argmax(1) for r in refs])).tolist(),
          "setup_s": setup_s, "variants": rows})
    if failures:
        raise AssertionError("serve_keras_int8: " + "; ".join(failures))
    # the control checks the check: its launches are not the path's
    return {k: sum(r["launches"].get(k, 0) for t, r in rows.items()
                   if t != control)
            for k in ("int8_matmul", "fused_layernorm",
                      "flash_attention_fwd")}


def _lm_model():
    from bigdl_tpu_torch.nn import Transformer

    return Transformer(**LM, dropout=0.0, seed=SEED)


def _lm_engine(dev, model, **cfg):
    """An InferenceModel of ``model`` with a decode engine of ``DECODE``
    and ``cfg``, on a sample-keeping metrics registry, warmed up."""
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    im = InferenceModel(model, decode=DecodeConfig(**{**DECODE, **cfg}),
                        device=dev)
    im.decode_engine.metrics = _sample_metrics()
    im.warmup()
    return im


def _captures_after_warmup(im, captured):
    eng = im.decode_engine
    return {"graphs_captured": eng.graphs_captured,
            "captured_at_warmup": captured,
            "unexpected_captures": eng.metrics.counter(
                "serving.decode.unexpected_captures")}


def _agree(a, b):
    return sum(x.tokens.tolist() == y.tokens.tolist() for x, y in zip(a, b))


def serve_prefix(dev):
    """The prefix cache (``DecodeConfig.prefix_cache_pages``) on the
    12-layer LM, float32 and int8 pages: one warm request of a 448-token
    system prefix, then 15 requests of that prefix plus 64 tokens, on a
    graphs engine beside an eager one, and on a cold graphs engine (no
    cache).  Holds: 15 hits and 1 miss, the prefix's pages unchanged by
    the attached prefills (bytes and int8 scales), the graphs' tokens
    equal to eager's to the bit, every decode step through the paged
    kernel, no capture after warmup, fewer prefill calls than cold.
    Reports the agreement with the cold engine (ROADMAP C.2)."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches

    c = PREFIX
    rs = np.random.RandomState(SEED + 6)
    V = LM["vocab_size"]
    prefix = rs.randint(2, V, c["prefix"]).astype(np.int32)
    rest = [np.concatenate([prefix, rs.randint(2, V, c["suffix"])]).astype(
        np.int32) for _ in range(c["requests"])]
    model = _lm_model()
    out, failures, launches_all = {}, [], Counter()
    for kv in ("float32", "int8"):
        kernel = ("paged_decode_attention_int8" if kv == "int8"
                  else "paged_decode_attention")
        t0 = time.perf_counter()
        engines = {
            "graphs": _lm_engine(dev, model, kv_dtype=kv,
                                 prefix_cache_pages=c["pages"],
                                 cuda_graphs=True),
            "eager": _lm_engine(dev, model, kv_dtype=kv,
                                prefix_cache_pages=c["pages"],
                                cuda_graphs=False),
            "cold": _lm_engine(dev, model, kv_dtype=kv, cuda_graphs=True)}
        setup_s = time.perf_counter() - t0
        runs = {}
        try:
            for name, im in engines.items():
                eng = im.decode_engine
                captured = eng.graphs_captured
                warm = im.generate([prefix], max_new_tokens=c["max_new"],
                                   return_results=True)
                snap = None
                if eng._prefix_cache is not None:
                    entries = list(eng._prefix_cache._entries.values())
                    ids = torch.tensor(entries[0].pages, device=dev) \
                        if entries else None
                    pools = [eng._kv_k, eng._kv_v] + (
                        [eng._kv_sk, eng._kv_sv] if kv == "int8" else [])
                    snap = [p[:, ids].clone() for p in pools] \
                        if ids is not None else []
                before = dict(eng.stats)
                torch.cuda.synchronize()
                reset_launches()
                t1 = time.perf_counter()
                res = im.generate(rest, max_new_tokens=c["max_new"],
                                  return_results=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                launches = dict(LAUNCHES)
                launches_all.update(launches)
                d = {k: v - before.get(k, 0) for k, v in eng.stats.items()}
                row = {"wall_s": wall, "steps": d["steps"],
                       "prefill_calls": d["prefill_calls"],
                       "prefill_chunks": d["prefill_chunks"],
                       "launches": launches,
                       "tokens_per_s": sum(len(r.tokens) for r in res) / wall,
                       "prefill_ms_p50": _percentile_ms(
                           eng.metrics.samples.get(
                               "serving.decode.prefill_s", []), 50),
                       "ttft_ms_p50": _percentile_ms(eng.metrics.samples.get(
                           "serving.decode.ttft_s", []), 50),
                       **_captures_after_warmup(im, captured)}
                if eng._prefix_cache is not None:
                    row["prefix_cache"] = eng._prefix_cache.stats()
                    row["shared_pages_unchanged"] = snap is not None and all(
                        torch.equal(a, p[:, ids]) for a, p in zip(
                            snap, [eng._kv_k, eng._kv_v] + (
                                [eng._kv_sk, eng._kv_sv] if kv == "int8"
                                else [])))
                    st = row["prefix_cache"]
                    if st["hits"] != c["requests"] or st["misses"] != 1 \
                            or not row["shared_pages_unchanged"]:
                        failures.append(f"{kv} {name}: {st}, shared pages "
                                        f"unchanged "
                                        f"{row['shared_pages_unchanged']}")
                if launches.get(kernel, 0) != LM["num_layers"] * d["steps"] \
                        or d["steps"] < 1:
                    failures.append(f"{kv} {name}: {kernel} {launches} over "
                                    f"{d['steps']} steps")
                if name != "eager" and (row["unexpected_captures"]
                                        or row["graphs_captured"]
                                        != captured):
                    failures.append(f"{kv} {name}: captures after warmup "
                                    f"{row}")
                runs[name] = (warm + res, row)
        finally:
            for im in engines.values():
                im.stop()
        g, e, cold = (runs[k][0] for k in ("graphs", "eager", "cold"))
        try:
            _same_bits(f"serve_prefix {kv}", e, g)
        except AssertionError as err:
            failures.append(str(err))
        rows = {k: r for k, (_, r) in runs.items()}
        if rows["graphs"]["prefill_calls"] >= rows["cold"]["prefill_calls"]:
            failures.append(f"{kv}: attached prefill calls "
                            f"{rows['graphs']['prefill_calls']} not below "
                            f"cold {rows['cold']['prefill_calls']}")
        out[kv] = {"setup_s": setup_s, "runs": rows,
                   "cold_agree": f"{_agree(g, cold)}/{len(g)}",
                   "graphs_equal_eager": True}
    emit({"phase": "serve_prefix", "model": LM, "decode": DECODE,
          "prefix": c, "compute_dtype": "bfloat16", "pages": out})
    if failures:
        raise AssertionError("serve_prefix: " + "; ".join(failures))
    return dict(launches_all)


def serve_handoff(dev):
    """The prefill/decode split and live migration on the 12-layer LM,
    float32 and int8 pages, two graphs engines A and B: 8 prefill-only
    requests of 512 tokens on A (``export_kv``), each handoff packed,
    unpacked and imported on B (``submit_prefilled``); then 8 live
    requests on A migrated to B after their 8th token
    (``migrate_live_slots``, the frozen slots evicted with ``cancel``).
    Reports the bytes a handoff, pack and unpack ms, and the tokens
    against one engine's run (ROADMAP C.2).  Holds: every imported and
    migrated slot decodes through the paged kernel, the first token is
    A's, no capture after warmup, an int8 blob refused by a float32
    engine, every page back."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.serving import DecodeRequest, RequestCancelledError
    from bigdl_tpu_torch.serving.fleet import pack_handoff, unpack_handoff

    c = HANDOFF
    rs = np.random.RandomState(SEED + 7)
    prompts = [rs.randint(2, LM["vocab_size"], c["prompt"]).astype(np.int32)
               for _ in range(c["requests"])]
    model = _lm_model()
    out, failures, launches_all = {}, [], Counter()
    keep = {}
    for kv in ("float32", "int8"):
        kernel = ("paged_decode_attention_int8" if kv == "int8"
                  else "paged_decode_attention")
        a = _lm_engine(dev, model, kv_dtype=kv, cuda_graphs=True)
        b = _lm_engine(dev, model, kv_dtype=kv, cuda_graphs=True)
        ea, eb = a.decode_engine, b.decode_engine
        captured = (ea.graphs_captured, eb.graphs_captured)
        row = {}
        try:
            ref = a.generate(prompts, max_new_tokens=c["max_new"],
                             return_results=True)
            pre = ea.submit_many([DecodeRequest(tokens=p, max_new_tokens=1,
                                                export_kv=True)
                                  for p in prompts])
            for r in pre:
                r.wait(timeout=300)
            t1 = time.perf_counter()
            blobs = [pack_handoff(r.kv_export) for r in pre]
            pack_ms = (time.perf_counter() - t1) * 1e3 / len(blobs)
            t1 = time.perf_counter()
            handoffs = [unpack_handoff(x) for x in blobs]
            unpack_ms = (time.perf_counter() - t1) * 1e3 / len(blobs)
            before = dict(eb.stats)
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            got = [r.wait(timeout=300) for r in [
                eb.submit_prefilled(h, max_new_tokens=c["max_new"])
                for h in handoffs]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = dict(LAUNCHES)
            launches_all.update(launches)
            steps = eb.stats["steps"] - before["steps"]
            first_ok = all(int(r.kv_export["first_token"]) == int(g.tokens[0])
                           for r, g in zip(pre, got))
            row["handoff"] = {
                "bytes_per_handoff": len(blobs[0]),
                "pack_ms": pack_ms, "unpack_ms": unpack_ms,
                "decode_wall_s": wall, "steps": steps, "launches": launches,
                "kv_imports": eb.stats["kv_imports"],
                "first_token_from_prefill": first_ok,
                "one_engine_agree": f"{_agree(got, ref)}/{len(ref)}"}
            if launches.get(kernel, 0) != LM["num_layers"] * steps \
                    or steps < 1 or not first_ok:
                failures.append(f"{kv} handoff: {kernel} {launches} over "
                                f"{steps} steps, first token {first_ok}")
            # live migration after the 8th token of every request
            reached = threading.Event()
            counts = Counter()

            def on_token(rid, tok, idx):
                if idx + 1 == c["migrate_after"]:
                    counts["n"] += 1
                    if counts["n"] == len(prompts):
                        reached.set()

            ref_live = a.generate(prompts, max_new_tokens=c["live_new"],
                                  return_results=True)
            live = ea.submit_many([DecodeRequest(tokens=p,
                                                 max_new_tokens=c["live_new"],
                                                 on_token=on_token)
                                   for p in prompts])
            if not reached.wait(timeout=300):
                raise AssertionError(f"{kv}: the live requests never reached "
                                     f"token {c['migrate_after']}")
            t1 = time.perf_counter()
            exports, frozen, left = ea.migrate_live_slots()
            migrate_ms = (time.perf_counter() - t1) * 1e3
            for rid in frozen + left:
                ea.cancel(rid, reason="migrated")
            for r in live:
                try:
                    r.wait(timeout=300)
                except RequestCancelledError:
                    pass
            before = dict(eb.stats)
            reset_launches()
            cont = {}
            for e in exports:
                done = e["resume_len"] - 1
                res = eb.submit_prefilled(
                    unpack_handoff(pack_handoff(e)),
                    max_new_tokens=c["live_new"] - done).wait(timeout=300)
                cont[e["request_id"]] = np.concatenate(
                    [e["tokens"][c["prompt"]:], res.tokens]).tolist()
            launches = dict(LAUNCHES)
            launches_all.update(launches)
            steps = eb.stats["steps"] - before["steps"]
            rid_ref = {r.rid: want for r, want in zip(live, ref_live)}
            agree = sum(cont[rid] == rid_ref[rid].tokens.tolist()
                        for rid in cont)
            row["migrate"] = {
                "exported": len(exports), "frozen": len(frozen),
                "leftover": len(left), "migrate_ms": migrate_ms,
                "resume_lens": [e["resume_len"] for e in exports],
                "steps_on_b": steps, "launches_on_b": launches,
                "unmigrated_agree": f"{agree}/{len(cont)}"}
            if len(exports) < 1 or launches.get(kernel, 0) \
                    != LM["num_layers"] * steps:
                failures.append(f"{kv} migrate: {len(exports)} exports, "
                                f"{kernel} {launches} over {steps} steps")
            deadline = time.time() + 30
            while len(ea._free_pages) != ea.cfg.total_pages \
                    or len(eb._free_pages) != eb.cfg.total_pages:
                if time.time() > deadline:
                    failures.append(f"{kv}: pages never came back")
                    break
                time.sleep(0.01)
            row["captures"] = {
                "a": _captures_after_warmup(a, captured[0]),
                "b": _captures_after_warmup(b, captured[1])}
            for side in row["captures"].values():
                if side["unexpected_captures"] \
                        or side["graphs_captured"] != side[
                            "captured_at_warmup"]:
                    failures.append(f"{kv}: captures {row['captures']}")
            if kv == "int8":
                try:
                    keep["float32"].decode_engine.submit_prefilled(
                        handoffs[0])
                    row["int8_refused_by_float32"] = False
                    failures.append("an int8 handoff was accepted by a "
                                    "float32 engine")
                except ValueError as err:
                    row["int8_refused_by_float32"] = str(err)
            out[kv] = row
        finally:
            a.stop()
            if kv == "float32":
                keep["float32"] = b
            else:
                b.stop()
                keep["float32"].stop()
    emit({"phase": "serve_handoff", "model": LM, "decode": DECODE,
          "handoff": c, "compute_dtype": "bfloat16", "pages": out})
    if failures:
        raise AssertionError("serve_handoff: " + "; ".join(failures))
    return dict(launches_all)


def serve_spec_window(dev, nowin=None):
    """serve_spec's speculation with ``draft_window=128`` against the
    same speculation without it (``nowin``, serve_spec's warmed graphs
    engine, or a new one) and the non-speculative engine, 16 prompts of
    512 tokens, greedy: two timed runs of each speculative engine,
    alternating.  Holds: the windowed engine's verify and block-sparse
    launches by serve_spec's formulas, every token within the bfloat16
    tolerance of a full forward, no capture after warmup.  Reports the
    tokens against the non-speculative engine, the acceptance and the
    draft's device time an iteration with and without the window."""
    from bigdl_tpu_torch.serving import SpecConfig

    c = SPEC_WINDOW
    rs = np.random.RandomState(SEED + 8)
    prompts = [rs.randint(2, LM["vocab_size"], c["prompt"]).astype(np.int32)
               for _ in range(N_REQUESTS)]
    model = _lm_model()
    t0 = time.perf_counter()
    ims = {"window": _lm_engine(dev, model, cuda_graphs=True,
                                speculative=SpecConfig(
                                    **SPEC, draft_window=c["window"]))}
    owned = ["window"]
    if nowin is None:
        ims["no_window"] = _lm_engine(dev, model, cuda_graphs=True,
                                      speculative=SpecConfig(**SPEC))
        owned.append("no_window")
    else:
        ims["no_window"] = nowin
    ims["spec_off"] = _lm_engine(dev, model, cuda_graphs=True)
    owned.append("spec_off")
    setup_s = time.perf_counter() - t0
    captured = ims["window"].decode_engine.graphs_captured
    failures, rows, first = [], {}, {}
    try:
        first["spec_off"] = _serve_run(ims["spec_off"], prompts)
        for name in ("window", "no_window", "no_window", "window"):
            r = _serve_run(ims[name], prompts)
            first.setdefault(name, r)
            rows.setdefault(name, []).append(r["row"])
        run = first["window"]
        d = run["delta"]
        L = LM["num_layers"]
        if run["launches"].get("paged_verify_attention", 0) \
                != L * d["steps"] or d["steps"] < 1:
            failures.append(f"verify launched {run['launches']} over "
                            f"{d['steps']} iterations")
        try:
            _spec_launches_check(run["launches"], d["steps"],
                                 d["prefill_calls"], SPEC["k"],
                                 "serve_spec_window",
                                 "block_sparse_matmul_bf16")
        except AssertionError as err:
            failures.append(str(err))
        gap, dlogp = check_tokens(ims["window"], prompts, run["results"],
                                  dev, bf16_gap_tolerance)
        caps = _captures_after_warmup(ims["window"], captured)
        if caps["unexpected_captures"] or caps["graphs_captured"] != captured:
            failures.append(f"captures after warmup {caps}")
        off = first["spec_off"]["results"]

        def acc(r):
            dd = r["delta"]
            return {"drafted": dd["spec_drafted"],
                    "accepted": dd["spec_accepted"],
                    "rejected": dd["spec_rejected"],
                    "accept_rate": dd["spec_accepted"]
                    / max(dd["spec_drafted"], 1),
                    "iterations": dd["steps"]}

        emit({"phase": "serve_spec_window", "spec": SPEC,
              "draft_window": c["window"], "prompt": c["prompt"],
              "requests": N_REQUESTS, "compute_dtype": "bfloat16",
              "launches": run["launches"], "max_logit_gap": gap,
              "max_logp_err": dlogp,
              "spec_off_agree": {
                  name: f"{_agree(first[name]['results'], off)}/{len(off)}"
                  for name in ("window", "no_window")},
              "acceptance": {name: acc(first[name])
                             for name in ("window", "no_window")},
              "draft_ms_per_iteration_p50": {
                  name: [r.get("spec_draft_step_ms_p50") for r in rows[name]]
                  for name in rows},
              "verify_ms_per_iteration_p50": {
                  name: [r.get("spec_verify_step_ms_p50") for r in rows[name]]
                  for name in rows},
              "tokens_per_s": {name: [r["tokens_per_s"] for r in rows[name]]
                               for name in rows},
              "spec_off_tokens_per_s": first["spec_off"]["row"][
                  "tokens_per_s"],
              "captures": caps, "setup_s": setup_s})
    finally:
        for name in owned:
            ims[name].stop()
    if failures:
        raise AssertionError("serve_spec_window: " + "; ".join(failures))
    return run["launches"]


def serve_seq2seq(dev):
    """Translation serving: the Transformer-base model (``TRANSLATION``,
    random weights) through ``Seq2SeqService(continuous=True)``, 16
    sources of 16-64 tokens in one ``translate``, max_len 64, warmed up
    first; then beam 4 through a beam service.  Holds: every decoder
    layer's self-attention through the paged decode kernel (6 launches a
    decode step), no capture after warmup, finite scores.  Reports
    tokens/s and the greedy tokens against ``transformer_decode_cached``
    on the same model (ROADMAP C.2)."""
    from bigdl_tpu_torch.nn.attention import transformer_decode_cached
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.serving import DecodeConfig, Seq2SeqService

    c, t = SEQ2SEQ, TRANSLATION
    model = _translation_model()
    rs = np.random.RandomState(SEED + 9)
    srcs = [rs.randint(3, t["vocab"], n).astype(np.int32)
            for n in c["src_lens"] for _ in range(c["per_len"])]
    cfg = DecodeConfig(slots=len(srcs), page_size=16,
                       pages_per_slot=-(-(c["max_len"] + 1) // 16),
                       prompt_chunk=16, prefill_batch=4,
                       max_new_tokens=c["max_len"], eos_id=t["eos"])
    t0 = time.perf_counter()
    svc = Seq2SeqService(model, t["bos"], t["eos"], max_len=c["max_len"],
                         src_buckets=c["src_buckets"], decode_config=cfg,
                         device=dev)
    eng = svc._engine()
    eng.metrics = _sample_metrics()
    svc.warmup()
    setup_s = time.perf_counter() - t0
    captured = eng.graphs_captured
    failures = []
    try:
        before = dict(eng.stats)
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        toks, scores = svc.translate(srcs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        steps = eng.stats["steps"] - before["steps"]
        gen = [row[1:] for row in toks]
        lengths = []
        for row in gen:
            hit = np.nonzero(row == t["eos"])[0]
            lengths.append(int(hit[0]) + 1 if len(hit) else len(row))
        n_tok = sum(lengths)
        if launches.get("paged_decode_attention", 0) != t["layers"] * steps \
                or steps < 1:
            failures.append(f"paged_decode_attention {launches} over "
                            f"{steps} decode steps of {t['layers']} layers")
        if not np.isfinite(scores).all():
            failures.append("non-finite scores")
        caps = _captures_after_warmup(svc, captured)
        if caps["unexpected_captures"] or caps["graphs_captured"] != captured:
            failures.append(f"captures after warmup {caps}")
        # the cached greedy decoder, a batch of each source length
        agree = 0
        with torch.no_grad():
            for i in range(0, len(srcs), c["per_len"]):
                batch = np.stack(srcs[i:i + c["per_len"]])
                ref, _ = transformer_decode_cached(
                    svc.model, torch.from_numpy(batch).to(dev), t["bos"],
                    t["eos"], max_len=c["max_len"])
                for j, row in enumerate(ref.cpu().numpy()):
                    n = lengths[i + j]
                    agree += int(row[1:1 + n].tolist() == gen[i + j][:n]
                                 .tolist())
        beam = Seq2SeqService(model, t["bos"], t["eos"], max_len=c["max_len"],
                              beam_size=c["beam"], device=dev)
        bsrc = rs.randint(3, t["vocab"], (c["beam_sources"], c["beam_len"])
                          ).astype(np.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        btoks, bscores = beam.translate(bsrc)
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t1
        if btoks.shape != (c["beam_sources"], c["max_len"] + 1) \
                or not np.isfinite(bscores).all():
            failures.append(f"beam: {btoks.shape}, finite "
                            f"{np.isfinite(bscores).all()}")
        emit({"phase": "serve_seq2seq", "model": {k: t[k] for k in (
                  "vocab", "d", "heads", "ffn", "layers")},
              "sources": len(srcs), "src_lens": list(c["src_lens"]),
              "max_len": c["max_len"], "decode_steps": steps,
              "prefill_calls": eng.stats["prefill_calls"]
              - before["prefill_calls"], "launches": launches,
              "generated_tokens": n_tok, "wall_s": wall,
              "tokens_per_s": n_tok / wall,
              "step_ms_p50": _percentile_ms(eng.metrics.samples.get(
                  "serving.decode.step_s", []), 50),
              "cached_decoder_agree": f"{agree}/{len(srcs)}",
              "beam": {"beam_size": c["beam"], "sources": c["beam_sources"],
                       "src_len": c["beam_len"], "wall_s": beam_s,
                       "best_scores": bscores.tolist()},
              "captures": caps, "setup_s": setup_s,
              "compute_dtype": "bfloat16"})
    finally:
        svc.stop()
    if failures:
        raise AssertionError("serve_seq2seq: " + "; ".join(failures))
    return launches


def _serve_prompts():
    """serve's 16 seeded prompts of 16-512 tokens."""
    rs = np.random.RandomState(SEED)
    return [rs.randint(2, LM["vocab_size"], n).astype(np.int32)
            for n in rs.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                N_REQUESTS)]


def _http_stream(host, port, rid, payload, mid=None):
    """One streamed ``/generate`` over its own connection: the status,
    the token lines' tokens and host receive times, the final line and
    the send time.  ``mid`` is set at the second token (and at the end)."""
    import http.client

    out = {"rid": rid, "tokens": [], "recv": [], "final": None}
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        out["t0"] = time.time()
        conn.request("POST", "/generate", body=json.dumps(
            dict(payload, stream=True)).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": rid, "Connection": "close"})
        resp = conn.getresponse()
        out["status"] = resp.status
        while True:
            line = resp.readline()
            if not line:
                break
            ev = json.loads(line)
            if ev.get("done"):
                out["final"] = ev
                break
            out["tokens"].append(int(ev["token"]))
            out["recv"].append(time.time())
            if mid is not None and len(out["tokens"]) == 2:
                mid.set()
    except Exception as e:  # noqa: BLE001 — reported as the stream's error
        out["error"] = repr(e)
    finally:
        if mid is not None:
            mid.set()
        conn.close()
    return out


def _scrape(url):
    """``GET url/metrics`` parsed: {family: [(labels, value)]}."""
    from bigdl_tpu_torch.obs.export import parse_exposition

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    return {f["name"]: [(lab, float(v)) for _, lab, v in f["samples"]]
            for f in parse_exposition(text)}


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def _replay_batches(im, events, rows_of):
    """The batches a ``ServingServer`` assembled for ``im``'s tenant, from
    the ``serving/batch`` spans of a Chrome trace (their request ids, in
    the rows' order), each predicted again through ``im`` on this thread:
    {request id: (its rows of the output, its rows of the output shifted
    by one row, or None in a batch of one row)}.  ``rows_of`` maps the
    tenant's request ids to their inputs; a span of other ids is
    another tenant's."""
    out = {}
    for e in events:
        rids = e["args"].get("request_ids", "").split(",")
        if e["name"] != "serving/batch" or not all(r in rows_of
                                                    for r in rids):
            continue
        y = im.predict(np.concatenate([rows_of[r] for r in rids]))
        shifted = np.roll(y, 1, axis=0) if len(y) > 1 else None
        at = 0
        for r in rids:
            n = len(rows_of[r])
            out[r] = (y[at:at + n],
                      None if shifted is None else shifted[at:at + n])
            at += n
    return out


def _row_drift_cause(q8, fused, dev, x, cfg):
    """Why a request's rows alone drift from the same rows in a wider
    bucket on the int8 encoder ``q8``: cuBLAS's float32 product of the
    first attention's query projection at M = 1, 4 and 16 sequences of
    token rows against the same rows of M = 64 sequences (max |diff|),
    and ``q8``'s and the float model's (``fused`` served unquantized)
    answers to ``x`` after a one-ulp change of that projection's first
    weight (max |diff| over max |answer|)."""
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.serving import InferenceModel

    def first_attention(im):
        return next(m for m in im.model.modules()
                    if isinstance(m, MultiHeadAttention))

    length = cfg["length"]
    w = first_attention(q8).wq.detach()
    g = torch.Generator().manual_seed(SEED)
    a = torch.randn(64 * length, cfg["d"], generator=g).to(dev)
    with torch.no_grad():
        full = torch.matmul(a, w)
        rows = {f"M={m * length}": float(
            (torch.matmul(a[:m * length], w) - full[:m * length]).abs()
            .max()) for m in (1, 4, 16)}
    f32 = InferenceModel(fused, device=dev, batch_buckets=BERT_BUCKETS)
    one_ulp = {}
    for tag, im in (("int8", q8), ("float", f32)):
        base = im.predict(x)
        wq = first_attention(im).wq
        with torch.no_grad():
            old = wq[0, 0].clone()
            wq[0, 0] = torch.nextafter(old, old + 1)
            one_ulp[tag] = _rel_err(im.predict(x), base)
            wq[0, 0] = old
    return {"matmul_rows_vs_64_sequences": rows, "one_ulp_weight": one_ulp,
            "int8_vs_float": _rel_err(q8.predict(x), f32.predict(x))}


def serve_http(dev, cfg=BERT):
    """The HTTP serving stack on the card (``HTTP``): a ``ServingServer``
    of the LM tenant and the int8 fused BERT tenant behind an
    ``HttpFrontend``, both warmed before the frontend starts, tracing on
    (to a temporary file) and a TTFT SLO on the LM tenant.  16 streamed
    ``/generate`` requests and 4 clients of 10 ``/predict`` requests run
    at once; ``/metrics`` is scraped during the traffic and after it.
    Holds: paged decode launches = 12 x decode steps, int8 = Dense nodes,
    flash = 12 and LayerNorm = 25 a BERT bucket call, no plain version
    runs, no capture after warmup, predictions within HTTP_PREDICT_RTOL
    of the model's predict of the batches the server assembled (each
    ``serving/batch`` span's rows, run again on this thread) and a
    control of those rows shifted by one past it, every ``server.stats``
    key in the scrape as its ``serving_*`` counter with the same value
    (a key still 0 may be absent: a counter appears at its first
    increment), both tenants' series, ``/health`` and ``/models``, each
    stream's trace (its ``serving/http_generate`` span,
    ``decode/admission`` and ``decode/prefill_chunk`` events) and the SLO
    burn gauge.  Reports each request's answer against its rows
    predicted alone with the cause of their drift (``_row_drift_cause``)
    and the streams' tokens against the engine's in-process
    ``generate`` (C.2), TTFT over HTTP against in-process,
    tokens/s, sequences/s and the host time a streamed token spends
    between the engine and the socket.  The caller holds the compute
    dtype for the server's lifetime."""
    from bigdl_tpu_torch.nn import Linear
    from bigdl_tpu_torch.obs import trace
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.ops import fused as fused_mod
    from bigdl_tpu_torch.ops import quantized as q8
    from bigdl_tpu_torch.optim.metrics import Metrics
    from bigdl_tpu_torch.serving import (DecodeConfig, HttpClient,
                                         HttpFrontend, InferenceModel,
                                         ServingConfig, ServingServer)
    from bigdl_tpu_torch.utils.intermediate import IRGraph

    # the module (the package's ``flash_attention`` is its function)
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    t0 = time.perf_counter()
    lm = InferenceModel(_lm_model(), decode=DecodeConfig(**DECODE),
                        device=dev)
    eng = lm.decode_engine
    eng.metrics = _sample_metrics()
    lm.warmup()
    captured = eng.graphs_captured
    model = bert_model(cfg)
    n_dense = sum(type(n.layer) is Linear for n in model.order)
    n_ln = 1 + 2 * cfg["layers"]
    fused = IRGraph.from_model(model).to_model("fused")
    bert = InferenceModel(fused, device=dev, weight_quant="int8",
                          batch_buckets=BERT_BUCKETS)
    rs = np.random.RandomState(SEED + 7)
    bert.warmup(rs.randint(0, cfg["vocab"], (1, cfg["length"])))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = _serve_prompts()
    batches = [[rs.randint(0, cfg["vocab"], (rs.randint(
        1, HTTP["max_rows"] + 1), cfg["length"])).astype(np.int32)
        for _ in range(HTTP["predict_requests"])]
        for _ in range(HTTP["predict_clients"])]
    tmp = tempfile.mkdtemp(prefix="serve_http_")
    tracer = trace.enable()
    slo = [{"tenant": "lm", "window_s": HTTP["slo_window_s"],
            "objectives": {"ttft_p99_s": HTTP["ttft_slo_s"]}}]
    reg = Metrics()
    srv = ServingServer(models={"lm": lm, "bert_int8": bert},
                        config=ServingConfig(batch_size=HTTP["max_rows"],
                                             slo=slo,
                                             result_gc_interval_s=0.2),
                        metrics=reg).start()
    fe = HttpFrontend(srv, port=0).start()
    calls, plain = [], Counter()
    hook = bert.model.register_forward_pre_hook(
        lambda m, a: calls.append(a[0].shape[0]))
    undo = [_counting(q8, "int8_matmul_plain", plain),
            _counting(fused_mod, "fused_layernorm_plain", plain),
            _counting(fa, "flash_attention_fwd_ref", plain),
            _counting(fa, "paged_decode_attention_ref", plain)]
    streams, preds, errors = {}, {}, []
    try:
        before = dict(eng.stats)
        torch.cuda.synchronize()
        reset_launches()

        def stream(i):
            streams[i] = _http_stream(fe.host, fe.port, f"http-{i}", {
                "tokens": prompts[i].tolist(), "model": "lm",
                "max_new_tokens": DECODE["max_new_tokens"]})

        def predict(c):
            client = HttpClient(fe.url, timeout=600)
            for j, x in enumerate(batches[c]):
                t1 = time.perf_counter()
                try:
                    y = client.predict(x, model="bert_int8",
                                       request_id=f"bert-{c}-{j}")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"predict {c}/{j}: {e!r}")
                    return
                preds[(c, j)] = (y, time.perf_counter() - t1)

        threads = ([threading.Thread(target=stream, args=(i,))
                    for i in range(len(prompts))]
                   + [threading.Thread(target=predict, args=(c,))
                      for c in range(HTTP["predict_clients"])])
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(1.0)
        during = _scrape(fe.url)
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        steps = eng.stats["steps"] - before["steps"]
        srv.slo.evaluate()
        after = _scrape(fe.url)
        health = _get_json(fe.url + "/health")
        models = _get_json(fe.url + "/models")
        stats = dict(srv.stats)
    finally:
        for u in undo:
            u()
        hook.remove()
        fe.stop()
        srv.stop()
    try:
        path = tracer.export_chrome_trace(os.path.join(tmp, "trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        trace.disable()
        # the same engine in process: its tokens and TTFT
        ref = lm.generate(prompts, return_results=True)
        replay = _replay_batches(bert, events, {
            f"bert-{c}-{j}": batches[c][j] for c, j in preds})
        direct = {k: bert.predict(batches[k[0]][k[1]]) for k in preds}
        cause = _row_drift_cause(bert, fused, dev, np.concatenate(
            batches[0])[:HTTP["max_rows"]], cfg)
        captures = eng.metrics.counter("serving.decode.unexpected_captures")
    finally:
        lm.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    failures = list(errors)
    for i, s in streams.items():
        if s.get("status") != 200 or s["final"] is None \
                or "error" in s["final"] or "error" in s:
            failures.append(f"stream {i}: {s.get('status')} "
                            f"{s.get('error') or s['final']}")
    agree = sum(streams[i]["tokens"] == ref[i].tokens.tolist()
                for i in range(len(prompts)) if i in streams)
    # every answer against its batch run again, and against its batch's
    # rows shifted by one (the control a row-mixing server would meet)
    rids = {k: f"bert-{k[0]}-{k[1]}" for k in preds}
    unreplayed = sorted(r for r in rids.values() if r not in replay)
    worst = max((_rel_err(y, replay[rids[k]][0])
                 for k, (y, _) in preds.items() if rids[k] in replay),
                default=None)
    control = min((_rel_err(y, replay[rids[k]][1])
                   for k, (y, _) in preds.items() if rids[k] in replay
                   and replay[rids[k]][1] is not None), default=None)
    if unreplayed or worst is None or worst > HTTP_PREDICT_RTOL \
            or control is None or control <= HTTP_PREDICT_RTOL:
        failures.append(f"predictions {worst} of max |log-prob| from the "
                        f"server's batches run again (past "
                        f"{HTTP_PREDICT_RTOL}?), the rows-shifted control "
                        f"{control} (within it?), not in a batch span: "
                        f"{unreplayed}")
    # C.2, reported: each request's rows predicted alone, by the bucket
    # they run in alone
    alone = {"1-4 rows": [], "5-16 rows": []}
    for k, (y, _) in preds.items():
        alone["1-4 rows" if len(y) <= 4 else "5-16 rows"].append(
            _rel_err(y, direct[k]))
    alone = {g: {"requests": len(v), "bit_equal": sum(e == 0.0 for e in v),
                 "max": max(v, default=None)} for g, v in alone.items()}
    want = {"paged_decode_attention": LM["num_layers"] * steps,
            "int8_matmul": n_dense * len(calls),
            "flash_attention_fwd": cfg["layers"] * len(calls),
            "fused_layernorm": n_ln * len(calls)}
    if any(launches.get(k, 0) != v for k, v in want.items()) or plain \
            or steps < 1 or not calls:
        failures.append(f"launches {launches} (want {want}), plain "
                        f"{dict(plain)}")
    if captures:
        failures.append(f"{captures} captures after warmup")
    # /metrics: every key of server.stats as its serving_* counter (one
    # still at 0 may be absent: a counter appears at its first increment),
    # both tenants' series
    counters = {k: dict(after.get(f"serving_{k}", [])).get("")
                for k in stats}
    if any((counters[k] or 0) != v for k, v in stats.items()) \
            or not (stats["requests"] and stats["batches"]):
        failures.append(f"/metrics counters {counters} against stats "
                        f"{stats}")
    tenants = {lab for lab, _ in after.get(
        "serving_tenant_requests_total", [])}
    if tenants != {'tenant="lm"', 'tenant="bert_int8"'} \
            or "serving_tenant_requests_total" not in during:
        failures.append(f"per-tenant series {sorted(tenants)} (during the "
                        f"traffic: {'serving_tenant_requests_total' in during})")
    burn = [v for lab, v in after.get("slo_burn_rate", [])
            if 'tenant="lm"' in lab and "ttft_p99_s" in lab]
    if not burn:
        failures.append("no slo_burn_rate gauge for the LM tenant's TTFT")
    if health.get("status") != "ok" or set(health.get("models", {})) \
            != {"lm", "bert_int8"} or "decode" not in health \
            or set(models.get("models", {})) != {"lm", "bert_int8"}:
        failures.append(f"/health {sorted(health)} models "
                        f"{sorted(models.get('models', {}))}")
    # every stream's trace: its HTTP span, admission and prefill events
    by_rid = {}
    for e in events:
        rid = e["args"].get("request_id")
        if rid is not None:
            by_rid.setdefault(rid, set()).add(e["name"])
    missing = {r: sorted({"serving/http_generate", "decode/admission",
                          "decode/prefill_chunk"} - by_rid.get(r, set()))
               for r in (f"http-{i}" for i in range(len(prompts)))}
    missing = {r: m for r, m in missing.items() if m}
    if missing:
        failures.append(f"trace events missing: {missing}")
    # the host time of a streamed token between the engine (the end of
    # its decode step) and the client's read
    step_end = {(e["args"]["request_id"], e["args"]["index"]):
                (e["ts"] + e["dur"]) / 1e6 for e in events
                if e["name"] == "decode/token_step"}
    host_s = [t - step_end[(s["rid"], k)] for s in streams.values()
              for k, t in enumerate(s["recv"]) if (s["rid"], k) in step_end]
    ttft_http = [s["recv"][0] - s["t0"] for s in streams.values()
                 if s["recv"]]
    ttft_inproc = [r.ttft_s for r in ref]
    n_tok = sum(len(s["tokens"]) for s in streams.values())
    n_seq = sum(len(y) for y, _ in preds.values())
    emit({"phase": "serve_http", "model": LM, "decode": DECODE,
          "bert": cfg, "compute_dtype": "float32", "traffic": HTTP,
          "streams": len(streams), "predict_requests": len(preds),
          "predict_sequences": n_seq, "bucket_calls": len(calls),
          "decode_steps": steps, "launches": launches,
          "want_launches": want, "plain_calls": dict(plain),
          "dense_nodes": n_dense, "captures_after_warmup": captures,
          "graphs_captured_at_warmup": captured,
          "inprocess_agree": f"{agree}/{len(prompts)}",
          "max_logp_rel_err_vs_batch_replay": worst,
          "rtol": HTTP_PREDICT_RTOL, "rows_shifted_control": control,
          "vs_rows_alone": alone, "row_drift_cause": cause,
          "ttft_ms_http": {"p50": _percentile_ms(ttft_http, 50),
                           "p99": _percentile_ms(ttft_http, 99)},
          "ttft_ms_inprocess": {"p50": _percentile_ms(ttft_inproc, 50),
                                "p99": _percentile_ms(ttft_inproc, 99)},
          "tokens_per_s": n_tok / wall, "sequences_per_s": n_seq / wall,
          "wall_s": wall,
          "token_host_ms": {"p50": _percentile_ms(host_s, 50),
                            "p99": _percentile_ms(host_s, 99),
                            "tokens": len(host_s)},
          "predict_ms_p50": _percentile_ms([t for _, t in preds.values()],
                                           50),
          "metrics_counters": counters, "stats": stats,
          "tenants": sorted(tenants), "slo_burn_ttft": burn,
          "slo_health": health.get("slo_health"),
          "trace_events": len(events), "setup_s": setup_s})
    if failures:
        raise AssertionError("serve_http: " + "; ".join(failures))
    return launches


def _pool_lm_loader():
    """The serve_pool workers' model (``chip_smoke:_pool_lm_loader``,
    imported in each worker process): the seeded LM with int8 pages on
    the card, its graphs captured at load."""
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    return InferenceModel(_lm_model(), decode=DecodeConfig(**{
        **DECODE, "kv_dtype": "int8", "max_new_tokens": POOL["max_new"]})
    ).warmup()


def serve_pool(dev):
    """A ``ServingPool`` of 2 worker processes on the card (``POOL``):
    8 streamed greedy requests through the proxy; the worker that holds
    live streams (``/health``) is killed after every stream's second
    token.  Holds: every stream finishes, the proxy counts a failover and
    resumed tokens and no orphan, the supervisor respawns the worker, and
    the federated ``/metrics`` shows both workers' series and
    ``serving_fleet_failovers``.  Reports the streams' tokens against an
    uninterrupted in-process run of the same model (C.2) and each
    spawn's seconds to ``WORKER_URL``.  The workers' kernel launches live
    in their processes: the proof that the kernels ran is that the
    workers compute on CUDA tensors, which launch a kernel or raise."""
    from bigdl_tpu_torch.serving import (DecodeConfig, InferenceModel,
                                         ServingPool)

    prompts = _serve_prompts()[:POOL["requests"]]
    t0 = time.perf_counter()
    ref_im = InferenceModel(_lm_model(), decode=DecodeConfig(**{
        **DECODE, "kv_dtype": "int8", "max_new_tokens": POOL["max_new"]}),
        device=dev).warmup()
    try:
        ref = [r.tokens.tolist() for r in ref_im.generate(
            prompts, max_new_tokens=POOL["max_new"], return_results=True)]
    finally:
        ref_im.stop()
    del ref_im
    _release()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    pool = ServingPool("chip_smoke:_pool_lm_loader",
                       workers=POOL["workers"], batch_size=8,
                       worker_env=env, supervise_interval_s=0.5,
                       predict_timeout=600.0, fleet_health_max_age_s=0.0)
    failures = []
    try:
        pool.start()
        start_s = time.perf_counter() - t0
        spawns = {w.name: w.spawn_s for w in pool.worker_list()}
        # one short request on each worker, so that each has served
        for w in pool.worker_list():
            req = urllib.request.Request(w.url + "/generate", data=json.dumps(
                {"tokens": prompts[0][:8].tolist(), "max_new_tokens": 2}
            ).encode(), headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=300).read()
        mids = [threading.Event() for _ in prompts]
        streams = {}

        def run(i):
            streams[i] = _http_stream(pool.host, pool.port, f"pool-{i}", {
                "tokens": prompts[i].tolist(),
                "max_new_tokens": POOL["max_new"]}, mids[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for m in mids:
            m.wait(300)
        fed_before = _scrape(pool.url)
        health = _get_json(pool.url + "/health")
        held = {w["name"]: w.get("decode", {}).get("generate_inflight", 0)
                for w in health["workers"]}
        victim_name = max(held, key=held.get)
        victim = next(w for w in pool.worker_list()
                      if w.name == victim_name)
        restarts = pool.restarts
        victim.proc.kill()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        deadline = time.time() + POOL["spawn_timeout_s"]
        while time.time() < deadline and not (
                victim.routable() and pool.restarts > restarts):
            time.sleep(0.5)
        respawned = victim.routable() and pool.restarts > restarts
        respawn_s = victim.spawn_s if respawned else None
        stats = dict(pool.stats)
        fed = _scrape(pool.url)
    finally:
        pool.stop()
    for i in range(len(prompts)):
        s = streams.get(i, {})
        if s.get("status") != 200 or s.get("final") is None \
                or "error" in s.get("final", {}) or "error" in s:
            failures.append(f"stream {i}: {s.get('status')} "
                            f"{s.get('error') or s.get('final')}")
    agree = sum(streams.get(i, {}).get("tokens") == ref[i]
                for i in range(len(prompts)))
    if stats.get("fleet_failovers", 0) < 1 \
            or stats.get("fleet_resumed_tokens", 0) < 1 \
            or stats.get("fleet_orphans", 0) != 0:
        failures.append(f"pool stats {stats}")
    if not respawned:
        failures.append(f"the supervisor did not respawn {victim_name}")
    labels = {lab for fam in fed_before.values() for lab, _ in fam}
    workers = {w for w in (f"worker-{i}" for i in range(POOL["workers"]))
               if any(f'worker="{w}"' in lab for lab in labels)}
    if len(workers) != POOL["workers"] \
            or "serving_fleet_failovers" not in fed:
        failures.append(f"federated /metrics: workers {sorted(workers)}, "
                        f"serving_fleet_failovers "
                        f"{'serving_fleet_failovers' in fed}")
    n_tok = sum(len(s.get("tokens", [])) for s in streams.values())
    emit({"phase": "serve_pool", "model": LM,
          "decode": {**DECODE, "kv_dtype": "int8",
                     "max_new_tokens": POOL["max_new"]},
          "workers": POOL["workers"], "streams": len(streams),
          "killed": victim_name, "streams_held_at_kill": held,
          "uninterrupted_agree": f"{agree}/{len(prompts)}",
          "fleet_failovers": stats.get("fleet_failovers"),
          "fleet_resumed_tokens": stats.get("fleet_resumed_tokens"),
          "fleet_orphans": stats.get("fleet_orphans"),
          "spawn_s": spawns, "respawn_s": respawn_s,
          "start_s": start_s, "tokens_per_s": n_tok / wall,
          "wall_s": wall, "federated_workers": sorted(workers),
          "pool_stats": stats,
          "launches": "in the worker processes (CUDA tensors: each "
                      "wrapper launches its kernel or raises)"})
    if failures:
        raise AssertionError("serve_pool: " + "; ".join(failures))


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


def _copy_ms(kernels) -> float:
    """Device ms of the kernels named for copies: torch's dtype casts
    (the bfloat16 casts of weights and activations at every product) run
    as its copy kernels, beside the other copies."""
    return sum(e.self_device_time_total for e in kernels
               if "copy" in e.key.lower()) / 1e3


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
           "copy_kernels_ms": _copy_ms(kernels),
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


# ---------------------------------------------------------------------------
# 22: the perf gauges (obs.cost, obs.attr) on the training phases
# ---------------------------------------------------------------------------

# every compile event of the run, by kind (a listener registered once)
_COMPILES = []
_LISTENING = []


def _compile_listener(name, duration_s, **kw):
    from bigdl_tpu_torch.obs import attr

    if name == attr.COMPILE_EVENT:
        _COMPILES.append(kw.get("kind"))


@contextlib.contextmanager
def _perf_watch():
    """Around a training phase: every attribution window the driver
    closes (steps, wall, its four components), every compile event by
    kind, and the sentinel's counters (``train.xla_compiles_total``,
    ``train.unexpected_recompiles_total``), into the dict it yields."""
    from bigdl_tpu_torch.obs import attr
    from bigdl_tpu_torch.optim.metrics import global_metrics

    if not _LISTENING:
        attr.register_event_duration_secs_listener(_compile_listener)
        _LISTENING.append(True)
    g = global_metrics()
    keys = ("train.xla_compiles_total", "train.unexpected_recompiles_total")
    base, n0 = [g.counter(k) for k in keys], len(_COMPILES)
    windows, real = [], attr.StepAttribution.window

    def window(self, steps, wall_s, data_s, dispatch_s, overhead_s):
        comps = real(self, steps, wall_s, data_s, dispatch_s, overhead_s)
        windows.append({"steps": steps, "wall_s": wall_s, **comps})
        return comps

    attr.StepAttribution.window = window
    out = {}
    try:
        yield out
    finally:
        attr.StepAttribution.window = real
        kinds = Counter(_COMPILES[n0:])
        out.update(windows=windows, compile_events=dict(kinds),
                   xla_compiles_total=g.counter(keys[0]) - base[0],
                   unexpected_recompiles_total=g.counter(keys[1]) - base[1])


def _window_sums(windows):
    """Each window's largest |sum of components - wall| / wall."""
    return max((abs(sum(w[c] for c in ("data", "dispatch", "device",
                                       "overhead")) - w["wall_s"])
                / w["wall_s"] for w in windows), default=0.0)


def _gauges(opt) -> dict:
    """The driver's accounting after a run: FLOPs, MFU, the peak and the
    device name it was resolved from, the step time and the
    attribution."""
    g = opt.metrics.gauges
    out = {k[len("train."):]: g.get(k) for k in (
        "train.flops_per_step", "train.effective_flops_per_step",
        "train.mfu", "train.effective_mfu", "train.achieved_flops_per_chip")}
    h = opt.metrics.hists.get("train.step_time_s")
    out.update(peak_flops=opt.peak_flops, peak_device=opt.peak_device,
               step_time_s_p50=(h.percentile(50) if h is not None and h.n
                                else None),
               timed_window=opt.timed_window,
               attribution=opt.attribution.report())
    return out


def _window_events_s(opt, events):
    """Seconds a step of the driver's last timed window (``opt.
    timed_window``: the steps its ``train.mfu`` is over), from the step
    clock's CUDA ``events`` at the window's two edges; None when a run
    had no timed window."""
    if opt.timed_window is None:
        return None
    a, b, _ = opt.timed_window
    return events[a].elapsed_time(events[b]) / 1e3 / (b - a)


def _lm_hand_flops(batch, seq, lm=LM):
    """A training step's FLOPs counted as JAX's formulas count them, by
    hand: 3 x (the layers' projections and FFN, 2 x tokens x weights,
    plus the attention products, 4 x batch x seq^2 x d); the tied head,
    a product the ``Transformer`` container computes, counts 0 there, and
    its forward FLOPs are given apart."""
    L, d, f = lm["num_layers"], lm["hidden_size"], lm["ffn_size"]
    tokens = batch * seq
    fwd = L * 2 * tokens * (4 * d * d + 2 * d * f) + L * 4 * batch * seq \
        * seq * d
    return {"train_flops_per_step": 3.0 * fwd,
            "tied_head_flops_forward": 2.0 * tokens * d * lm["vocab_size"]}


def _check_gauges(name, g, table, watch, captures_expected, step_s,
                  window_s):
    """A phase's gauges ``g`` (:func:`_gauges` of its last run) against
    the hand figure: the FLOPs, and ``train.mfu`` over the CUDA-event
    time ``window_s`` of the steps the gauge timed; the hand MFU at the
    phase's median step ``step_s`` beside them; and ``watch``'s checks:
    every window's components sum to its wall within ATTR_SUM_RTOL, no
    unexpected recompile, the captures counted equal to the bundle
    programs the phase captures."""
    hand = _lm_hand_flops(TRAIN["batch"], TRAIN["seq"])
    rel = abs(g["flops_per_step"] - hand["train_flops_per_step"]) \
        / hand["train_flops_per_step"]
    mfu_window = (hand["train_flops_per_step"] / window_s / g["peak_flops"]
                  if window_s else None)
    mfu_rel = (abs(g["mfu"] - mfu_window) / mfu_window
               if mfu_window and g["mfu"] is not None else None)
    out = {"phase": f"{name}_gauges", "nvidia_smi": nvidia_smi(),
           "gauges": g, "hand": hand, "flops_rel_to_hand": rel,
           "hand_rtol": MFU_HAND_RTOL, "window_step_s_events": window_s,
           "mfu_hand_window": mfu_window, "mfu_rel_to_hand": mfu_rel,
           "step_s_events": step_s,
           "mfu_hand": hand["train_flops_per_step"] / step_s
           / g["peak_flops"],
           "mfu_with_tied_head_hand": (
               hand["train_flops_per_step"]
               + 3 * hand["tied_head_flops_forward"]) / step_s
           / g["peak_flops"],
           "attribution_table": table,
           "windows": len(watch["windows"]),
           "window_sum_max_rel_err": _window_sums(watch["windows"]),
           "window_sum_rtol": ATTR_SUM_RTOL,
           "compile_events": watch["compile_events"],
           "captures_expected": captures_expected,
           "xla_compiles_total": watch["xla_compiles_total"],
           "unexpected_recompiles_total": watch[
               "unexpected_recompiles_total"]}
    emit(out)
    bad = []
    if rel > MFU_HAND_RTOL:
        bad.append("train.flops_per_step against the hand figure")
    if g["mfu"] is None or not 0 < g["mfu"] < 1:
        bad.append("train.mfu unset or outside (0, 1)")
    if mfu_rel is None or mfu_rel > MFU_HAND_RTOL:
        bad.append("train.mfu against the hand figure over its steps")
    if out["window_sum_max_rel_err"] > ATTR_SUM_RTOL or not watch["windows"]:
        bad.append("attribution components against the window wall")
    if watch["unexpected_recompiles_total"]:
        bad.append("unexpected recompiles")
    if watch["compile_events"].get("cuda_graph_capture", 0) \
            != captures_expected:
        bad.append("captures counted against the bundle programs")
    if bad:
        raise AssertionError(f"{name} gauges: {bad}: {out}")
    return out



def _train_data():
    rs = np.random.RandomState(SEED)
    shape = (TRAIN["batch"], TRAIN["seq"])
    ids = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    tgt = rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
    return ids, tgt


def grad_check(model, ids, tgt, dev, phase="gradcheck", key=None) -> dict:
    """One batch's gradients of every parameter with the flash kernels
    (``use_flash=None``, auto on CUDA) against plain attention
    (``use_flash=False``), on the same weights; ``ids`` an array or a
    tuple of the model's inputs; ``key`` the dropout key of both runs
    (the same masks) for a model that drops."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, MultiHeadAttention

    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    xs = tuple(torch.from_numpy(a).to(dev)
               for a in (ids if isinstance(ids, tuple) else (ids,)))
    y = torch.from_numpy(tgt).to(dev)
    model.to(dev).train(True)

    def grads(use_flash):
        for m in mhas:
            m.use_flash = use_flash
        model.zero_grad(set_to_none=True)
        out = model(*xs) if key is None else model(*xs, key=key)
        loss = CrossEntropyCriterion()(out, y)
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
    others = {n: e for n, e in rel.items() if not n.endswith(".bk")}
    worst_other = max(others, key=others.get)
    out = {"loss_flash": loss_f, "loss_plain": loss_p,
           "params": len(g_p), "grad_norm": total, "rtol": GRAD_RTOL,
           "floor": GRAD_FLOOR, "worst_param": worst,
           "worst_err": floored[worst],
           "key_bias_max_rel_err": max(e for n, e in rel.items()
                                       if n.endswith(".bk")),
           "worst_other_param": worst_other,
           "worst_other_rel_err": others[worst_other]}
    emit({"phase": phase, **out})
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
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    ids, tgt = _train_data()
    model = Transformer(**LM, dropout=0.0, seed=SEED)
    # flash against plain attention is a float32 check: plain attention
    # rounds q and k in bfloat16 products, the flash kernel does not
    with compute_dtype(torch.float32):
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
    with _perf_watch() as watch:
        trained = opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    losses = opt.losses
    step_ms = _step_ms(events, 0, steps)
    med = float(np.median(step_ms[1:]))
    # the live gauges of this eager run (K = 1: no capture)
    _check_gauges("train", _gauges(opt), opt.attribution.table(), watch, 0,
                  med / 1e3, _window_events_s(opt, events))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    want = LM["num_layers"] * steps
    out = {"phase": "train", "model": LM, "train": TRAIN,
           "compute_dtype": "bfloat16", "losses": losses, "step_ms": step_ms, "median_step_ms": med,
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
    return out, opt.model


def qat_lenet(dev, model):
    """Quantization-aware training of train_lenet's LeNet-5 (its EMA
    weights): ``prepare_qat``, QAT["epochs"] epochs through
    ``Optimizer.optimize()``, ``convert_qat``, then
    ``InferenceModel.predict`` of the validation set; the int8 model's
    top-1 beside the QAT model's and the float model's, the drift of its
    log-probs from the QAT model's, and its int8 matmul launches (4
    layers a bucket call)."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.qat import QATConv2D, QATLinear, convert_qat, \
        prepare_qat
    from bigdl_tpu_torch.nn.quantized import (QuantizedConv2D,
                                              QuantizedLinear)
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.serving import InferenceModel

    c, lc = QAT, LENET_TRAIN
    (x, y), (xv, yv) = lenet_data()

    def predict(m):
        return InferenceModel(m, device=dev,
                              batch_buckets=(c["bucket"],)).predict(xv)

    def top1(p):
        return float(np.mean(np.argmax(p, -1) == yv))

    float_pred = predict(model)
    qat = prepare_qat(model)
    wrapped = sum(isinstance(m, (QATLinear, QATConv2D))
                  for m in qat.modules())
    events = {}
    opt = (Optimizer(qat, DataSet.array(x, y), CrossEntropyCriterion(),
                     batch_size=lc["batch"], device=dev)
           .set_optim_method(Adam(learning_rate=c["lr"]))
           .set_end_when(Trigger.or_(_step_clock(events),
                                     Trigger.max_epoch(c["epochs"]))))
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = opt.final_state["iteration"]
    amax = [float(m.act_amax) for m in qat.modules()
            if isinstance(m, (QATLinear, QATConv2D))]
    qat_pred = predict(qat)
    int8 = convert_qat(qat)
    twins = sum(isinstance(m, (QuantizedLinear, QuantizedConv2D))
                for m in int8.modules())
    reset_launches()
    int8_pred = predict(int8)
    launches = LAUNCHES.get("int8_matmul", 0)
    calls = -(-len(xv) // c["bucket"])
    scale = float(np.abs(qat_pred).max())
    out = {"phase": "qat_lenet", "config": c, "wrapped": wrapped,
           "int8_layers": twins, "steps": steps, "wall_s": wall,
           "median_step_ms": float(np.median(_step_ms(events, 0, steps)[2:])),
           "first_loss": opt.losses[0], "last_loss": opt.losses[-1],
           "act_amax": amax, "float_top1": top1(float_pred),
           "qat_top1": top1(qat_pred), "int8_top1": top1(int8_pred),
           "int8_vs_qat_max_abs_drift": float(
               np.abs(int8_pred - qat_pred).max()),
           "int8_vs_qat_rel_drift": float(
               np.abs(int8_pred - qat_pred).max()) / scale,
           "int8_vs_float_max_abs_drift": float(
               np.abs(int8_pred - float_pred).max()),
           "int8_matmul_launches": launches, "bucket_calls": calls}
    emit(out)
    if wrapped != 4 or twins != 4 or launches != 4 * calls:
        raise AssertionError(f"qat_lenet: {wrapped} wrapped, {twins} int8 "
                             f"layers, {launches} int8 launches over "
                             f"{calls} bucket calls")
    if not (all(a > 0 for a in amax) and np.all(np.isfinite(opt.losses))
            and np.isfinite(int8_pred).all()
            and out["int8_top1"] > c["min_top1"]):
        raise AssertionError(f"qat_lenet: {out}")
    return launches


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
    # the convs run in bfloat16 on the tensor cores (the card's default);
    # the float32 CUDA-core bound stands beside it
    bound_ms = RESNET_TRAIN_FLOPS / BF16_FLOPS * 1e3
    out = {"phase": "train_resnet", "config": c,
           "compute_dtype": "bfloat16",
           "f32_cuda_core_bound_ms": RESNET_TRAIN_FLOPS / F32_FLOPS * 1e3,
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
            "copy_kernels_ms": _copy_ms(kernels),
            "top": [{"kernel": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}


def serve_resnet(dev, model):
    """Serve ResNet-50 through ``InferenceModel.predict`` in bfloat16
    products (the card's default), in float32 products and int8: requests
    of 1, 3, 16 and 50 images (buckets 1, 4, 16, 64), then 20 requests of
    64, and the throughput again in the reverse order (float32, then
    bfloat16).  Float32 answers are held to a direct forward of the same
    rows, bfloat16 and int8 answers to the float32 ones; every int8
    bucket call goes through 54 launches of the int8 kernel and the plain
    version never runs.  Then a profile of each."""
    from bigdl_tpu_torch.nn import Conv2D, Linear
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.ops import quantized as q8
    from bigdl_tpu_torch.serving import InferenceModel
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    def in_dtype(tag):
        return (compute_dtype(torch.float32) if tag == "float32"
                else contextlib.nullcontext())

    t0 = time.perf_counter()
    ims = {"float32": InferenceModel(model, device=dev,
                                     batch_buckets=RESNET_BUCKETS),
           "bfloat16": InferenceModel(model, device=dev,
                                      batch_buckets=RESNET_BUCKETS),
           "int8": InferenceModel(model, device=dev, weight_quant="int8",
                                  batch_buckets=RESNET_BUCKETS)}
    rs = np.random.RandomState(SEED)
    sample = rs.randn(1, *IMAGE).astype(np.float32)
    for tag, im in ims.items():
        with in_dtype(tag):
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
        calls, plain = [], Counter()
        hook = im.model.register_forward_pre_hook(
            lambda m, a: calls.append(a[0].shape[0]))
        undo = _counting(q8, "int8_matmul_plain", plain)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            with in_dtype(tag):
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
            undo()
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
        if launches.get("int8_matmul", 0) != want_launches or plain:
            raise AssertionError(f"serve_resnet {tag}: int8_matmul launched "
                                 f"{launches} times over {len(calls)} bucket "
                                 f"calls (want {want_launches}), the plain "
                                 f"version ran {sum(plain.values())} times")
        results[tag] = outs
        if tag == "int8":
            wq = sum(b.numel() * b.element_size()
                     for n, b in im.model.named_buffers()
                     if n.rsplit(".", 1)[-1] in ("weight_q", "scales"))
        else:
            wq = weights_f32
        rows[tag] = {"phase": "serve_resnet", "precision": tag,
                     "compute_dtype": ("float32" if tag == "float32"
                                       else "bfloat16"),
                     "requests": [int(x.shape[0]) for x in requests],
                     "answered": len(requests), "bucket_calls": calls,
                     "launches": launches,
                     "plain_calls": sum(plain.values()),
                     "requests_wall_s": req_s,
                     "throughput": {"requests": n_tp, "images": b_tp},
                     "throughput_wall_s": tp_s,
                     "images_per_s": [n_tp * b_tp / tp_s],
                     "matmul_weight_bytes_at_rest": wq,
                     "peak_mem_gb": peak}

    # the throughput again, float32 then bfloat16: the two alternate
    for tag in ("float32", "bfloat16"):
        with in_dtype(tag):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(n_tp):
                ims[tag].predict(burst)
            torch.cuda.synchronize()
        rows[tag]["images_per_s"].append(
            n_tp * b_tp / (time.perf_counter() - t1))

    # float32 predict against a direct forward of the same rows
    f32 = ims["float32"]
    worst_f32 = 0.0
    with torch.no_grad(), compute_dtype(torch.float32):
        for x, y in zip(requests, results["float32"]):
            direct = f32.model(torch.from_numpy(x).to(dev)).cpu().numpy()
            worst_f32 = max(worst_f32, float(np.abs(y - direct).max()
                                             / np.abs(direct).max()))
    # bfloat16 and int8 against float32: top-1 agreement and log-prob
    # drift
    drift = {}
    for tag in ("bfloat16", "int8"):
        agree = total = 0
        worst = 0.0
        for a, b in zip(results[tag], results["float32"]):
            agree += int((a.argmax(1) == b.argmax(1)).sum())
            total += a.shape[0]
            worst = max(worst, float(np.abs(a - b).max()
                                     / np.abs(b).max()))
        drift[tag] = worst
        rows[tag].update(top1_agree=f"{agree}/{total}",
                         max_logp_rel_err_vs_f32=worst,
                         rtol=(INT8_LOGP_RTOL if tag == "int8"
                               else BF16_LOGP_RTOL))
    rows["float32"].update(max_rel_err_vs_direct=worst_f32,
                           rtol=RESNET_F32_RTOL)
    rows["int8"].update(f32_matmul_weight_bytes=weights_f32)
    for tag in ims:
        rows[tag]["setup_s"] = setup_s
        emit(rows[tag])
    if worst_f32 > RESNET_F32_RTOL:
        raise AssertionError(f"float32 predict disagrees with a direct "
                             f"forward: {worst_f32}")
    for tag, rtol in (("int8", INT8_LOGP_RTOL), ("bfloat16", BF16_LOGP_RTOL)):
        if drift[tag] > rtol:
            raise AssertionError(f"{tag} log-probs drift {drift[tag]} of max "
                                 f"|log-prob| from float32's, past {rtol}")
    for tag, im in ims.items():
        with in_dtype(tag):
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
    calls, plain = [], Counter()
    hook = im.model.register_forward_pre_hook(
        lambda m, a: calls.append(a[0].shape[0]))
    undo = _counting(fused_mod, "fused_layernorm_plain", plain)
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
        undo()
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
            or plain):
        raise AssertionError(f"serve_bert_fused: launches {launches} over "
                             f"{len(calls)} bucket calls (want "
                             f"fused_layernorm {want_ln}, "
                             f"flash_attention_fwd {want_flash}); the plain "
                             f"LayerNorm ran {sum(plain.values())} times")

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
          "launches": launches,
          "plain_layernorm_calls": sum(plain.values()),
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
    # the throughput in bfloat16 and float32 products, alternating; the
    # kernels' launches a bucket call the same in both
    pairs = _predict_dtype_pairs(im, burst, n_tp)
    for dt, row in pairs.items():
        want = {"fused_layernorm": want_ln // len(calls) * n_tp,
                "flash_attention_fwd": want_flash // len(calls) * n_tp}
        if row["launches"] != want or not np.isfinite(row["out"]).all():
            raise AssertionError(f"serve_bert_fused {dt}: launches "
                                 f"{row['launches']} (want {want}), finite "
                                 f"{np.isfinite(row['out']).all()}")
    bf, f32 = pairs["bfloat16"]["out"], pairs["float32"]["out"]
    emit({"phase": "serve_bert_dtypes", "sequences": b_tp, "requests": n_tp,
          "order": ["bfloat16", "float32", "float32", "bfloat16"],
          "bf16_top1_agree_vs_f32":
              f"{int((bf.argmax(1) == f32.argmax(1)).sum())}/{len(bf)}",
          "bf16_max_logp_rel_err_vs_f32": float(
              np.abs(bf - f32).max() / np.abs(f32).max()),
          **{dt: {"sequences_per_s": row["per_s"],
                  "peak_mem_gb": row["peak_mem_gb"],
                  "launches": row["launches"]}
             for dt, row in pairs.items()}})
    emit({"phase": "bert_profile", "requests": 3, "sequences": b_tp,
          **_profile(lambda: [im.predict(burst) for _ in range(3)],
                     named=("fused_layernorm_kernel", "flash_fwd_kernel"))})
    return launches


def _predict_dtype_pairs(im, batch, n):
    """``n`` predicts of ``batch`` in bfloat16 and in float32 products,
    alternating bfloat16, float32, float32, bfloat16: {dtype: rows a
    second of each run, peak memory, the launches of the last run, its
    last output}."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    out = {}
    for dt in (torch.bfloat16, torch.float32, torch.float32,
               torch.bfloat16):
        with compute_dtype(dt):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t1 = time.perf_counter()
            for _ in range(n):
                y = im.predict(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        row = out.setdefault(str(dt).split(".")[-1],
                             {"per_s": [], "peak_mem_gb": 0.0})
        row["per_s"].append(n * len(batch) / wall)
        row["peak_mem_gb"] = max(row["peak_mem_gb"],
                                 torch.cuda.max_memory_allocated() / 2**30)
        row["launches"] = dict(LAUNCHES)
        row["out"] = y
    return out


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
                        "copy_kernels_ms": _copy_ms(kernels),
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
           "window_step_s_events": _window_events_s(opt, events),
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


def _dtype_pairs(make_opt, steps):
    """K = 4 runs in float32 and in bfloat16 products, alternating
    (float32, bfloat16, bfloat16, float32), then one profiled run of each
    over [4, 8): step ms, busy share, peak memory and the losses of each
    dtype, its two runs' losses equal to the bit.  The bfloat16 losses
    must be finite and falling."""
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    k = BUNDLE["k"]
    runs = {"float32": [], "bfloat16": []}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        with compute_dtype(dt):
            runs[dt].append(_bundle_run(make_opt, k, steps))
    out = {}
    for dt, rs in runs.items():
        with compute_dtype(dt):
            prof = _bundle_run(make_opt, k, BUNDLE["sync_steps"],
                               busy=_BusyWindow(BUNDLE["timed_from"],
                                                BUNDLE["sync_steps"]))
        losses = rs[0]["losses"]
        out[dt] = {"step_ms": [r["step_ms"] for r in rs],
                   "median_step_ms": float(np.median(
                       [r["step_ms"] for r in rs])),
                   "busy_share": prof["busy"]["busy_share"],
                   "copy_kernels_ms": prof["busy"]["copy_kernels_ms"],
                   "peak_mem_gb": max(r["peak_mem_gb"] for r in rs),
                   "launches_per_step": rs[0]["launches_per_step"],
                   "graphs_captured": sum(r["graphs_captured"]
                                          for r in rs + [prof]),
                   "losses": losses,
                   "losses_bit_equal": all(r["losses"] == losses
                                           for r in rs)}
    bf = out["bfloat16"]
    if not (bf["losses_bit_equal"] and out["float32"]["losses_bit_equal"]
            and np.all(np.isfinite(bf["losses"]))
            and bf["losses"][-1] < bf["losses"][0]):
        raise AssertionError(f"bfloat16 / float32 bundles: {out}")
    return {"k": k, "order": ["float32", "bfloat16", "bfloat16", "float32"],
            **out}


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
    out["compute_dtype"] = "bfloat16"
    out["dtype_pairs"] = _dtype_pairs(make, steps)
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


def _lm_bundle_maker(dev):
    """``make(end)``: the LM's Optimizer on train_lm_bundles' 48 seeded
    rows (batch 8 x 1024, Adam 1e-4), ending at ``end``."""
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

    return make


def train_lm_bundles(dev):
    """The LM (12 layers, d 768, batch 8 x 1024) at K = 1 and K = 4: the
    flash forward and backward launch counts a step the same under replay
    as eager (credited at each replay), the losses equal to the bit, step
    ms, tokens/s, the host's dispatch, busy share and peak memory.  48
    seeded rows: 6 steps an epoch."""
    make = _lm_bundle_maker(dev)
    with _perf_watch() as watch:
        out, equal = _bundle_pairs(make, BUNDLE["steps"], 1,
                                   "train_lm_bundles",
                                   extra=lambda opt: {"gauges": _gauges(opt)})
        out["compute_dtype"] = "bfloat16"
        out["dtype_pairs"] = _dtype_pairs(make, BUNDLE["steps"])
    # every run's graphs (one a K = 4 run: one batch shape) are the
    # captures the sentinel counted, none after steady
    captured = sum(r["graphs_captured"] for r in out["runs"]) + sum(
        out["dtype_pairs"][dt]["graphs_captured"]
        for dt in ("float32", "bfloat16"))
    k4 = [r for r in out["runs"] if r["k"] == BUNDLE["k"]
          and "run" not in r]
    gauges = dict(k4[-1]["gauges"])
    timed = [r for r in out["runs"] if "gauges" in r]
    out["mfu_by_run"] = [{"k": r["k"], "mfu": r["gauges"]["mfu"],
                          "effective_mfu": r["gauges"]["effective_mfu"],
                          "step_ms": r["step_ms"],
                          "window_step_s_events": r["window_step_s_events"],
                          "timed_window": r["gauges"]["timed_window"]}
                         for r in timed]
    for r in timed:
        del r["gauges"]["attribution"]
    _check_gauges("train_lm_bundles", gauges,
                  f"(K = {BUNDLE['k']}) {gauges['attribution']}", watch,
                  captured, k4[-1]["step_ms"] / 1e3,
                  k4[-1]["window_step_s_events"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    for summary in (*out["summary"].values(),
                    out["dtype_pairs"]["float32"],
                    out["dtype_pairs"]["bfloat16"]):
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


# ---------------------------------------------------------------------------
# train_zero1: ZeRO-1 data parallelism over torch.distributed
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _device_ms(fn, reps) -> float:
    """Median device ms of ``fn()`` over ``reps`` calls, CUDA events around
    each, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _lm_flat_grad(dev):
    """The LM's flat gradient of one batch and its flat parameters, in
    the JAX ravel order (the ZeRO-1 layout's)."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.utils.convert import flat_order

    model = Transformer(**LM, dropout=0.0, seed=SEED).to(dev)
    rs = np.random.RandomState(SEED + 5)
    shape = (ZERO1["grad_rows"], TRAIN["seq"])
    ids, tgt = (torch.as_tensor(rs.randint(0, LM["vocab_size"], shape)
                                ).to(dev) for _ in range(2))
    CrossEntropyCriterion()(model(ids), tgt).backward()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    order = flat_order([n for n, _ in named])
    g = torch.cat([named[i][1].grad.reshape(-1) for i in order]).float()
    w = torch.cat([named[i][1].detach().reshape(-1) for i in order])
    del model, named
    return g, w


def _zero1_collectives(dev):
    """NCCL at world 1: each wire collective on the LM's flat gradient,
    eager and replayed from a captured graph, held to the same call over
    gloo on the CPU to the bit; device ms of each and of the int8 codec.
    Leaves no process group behind."""
    import torch.distributed as dist

    from bigdl_tpu_torch.ops.quantized import (dequantize_blockwise,
                                               quantize_blockwise)
    from bigdl_tpu_torch.parallel import collectives as pc
    from bigdl_tpu_torch.runtime import Engine, EngineConfig, init_engine

    block, reps = ZERO1["block"], ZERO1["reps"]
    eng = init_engine(EngineConfig(
        coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1,
        process_id=0, timeout_s=ZERO1["wait_s"]))
    try:
        nccl = eng.mesh.group
        if dist.get_backend(nccl) != "nccl":
            raise AssertionError(f"the card's group runs "
                                 f"{dist.get_backend(nccl)}, not NCCL")
        gloo = dist.new_group(ranks=[0], backend="gloo")
        g, w = _lm_flat_grad(dev)
        n = g.numel()
        delta = g * ZERO1["delta_scale"]

        def gather(t, grp):
            out = torch.empty_like(t)
            pc.all_gather(out, t, grp)
            return out

        ops = {
            "reduce_scatter_fp32": ((g,), lambda a, grp: pc.reduce_scatter_wire(
                a[0].view(1, -1), grp, "fp32")),
            "reduce_scatter_bf16": ((g,), lambda a, grp: pc.reduce_scatter_wire(
                a[0].view(1, -1), grp, "bf16")),
            "reduce_scatter_int8": ((g,), lambda a, grp: pc.reduce_scatter_wire(
                a[0].view(1, -1), grp, "int8", block=block)),
            "delta_gather_int8": ((delta, w), lambda a, grp:
                                  pc.all_gather_delta_quantized(
                                      a[0], a[1].view(1, -1), grp,
                                      block=block)),
            "all_gather_fp32": ((w,), lambda a, grp: gather(a[0], grp)),
            # the DCN hop of a multislice step, at world 1 on its group
            "psum_fp32": ((g,), lambda a, grp: pc.psum_wire(
                a[0], grp, 1, "fp32")),
            "psum_bf16": ((g.to(torch.bfloat16),), lambda a, grp:
                          pc.psum_wire(a[0], grp, 1, "bf16")),
            "psum_int8": ((g,), lambda a, grp: pc.psum_wire(
                a[0], grp, 1, "int8", block=block)),
        }
        rows = {}
        side = torch.cuda.Stream(dev)
        for name, (inputs, fn) in ops.items():
            want = fn(tuple(t.cpu() for t in inputs), gloo)
            got = fn(inputs, nccl)
            torch.cuda.synchronize()
            equal = torch.equal(got.cpu(), want)
            row = {"bit_equal_to_gloo_cpu": equal,
                   "ms": _device_ms(lambda: fn(inputs, nccl), reps)}
            if not equal:
                # every wire, the int8 codec included, divides as the CPU
                # does (ops.quantized.div127): any differing bit fails
                diff = (got.cpu().float() - want.float()).abs()
                row["elements_differing"] = int((diff > 0).sum())
                raise AssertionError(f"{name}: card and CPU differ: {row}")
            # captured: the communicator exists (the eager calls made it)
            graph = torch.cuda.CUDAGraph()
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.graph(graph, stream=side):
                out = fn(inputs, nccl)
            graph.replay()
            torch.cuda.synchronize()
            row["graph_bit_equal_to_eager"] = torch.equal(out, got)
            row["graph_ms"] = _device_ms(graph.replay, reps)
            if not row["graph_bit_equal_to_eager"]:
                raise AssertionError(f"{name}: replay differs from eager")
            del graph, out, got, want
            rows[name] = row
            print(json.dumps({name: row}), flush=True)
        g2d = pc._pad_last(g.view(1, -1), block)
        q, sc = quantize_blockwise(g2d, block)
        deq = dequantize_blockwise(q, sc)
        codec = {"quantize_ms": _device_ms(
                     lambda: quantize_blockwise(g2d, block), reps),
                 "dequantize_ms": _device_ms(
                     lambda: dequantize_blockwise(q, sc), reps),
                 "sum_ms": _device_ms(lambda: deq[0].clone(), reps)}
        out = {"phase": "train_zero1_collectives", "world": 1,
               "backend": "nccl", "n_real": n, "block": block,
               "bytes_fp32": 4 * n, "collectives": rows,
               "int8_codec": codec,
               "ledger_by_world": {
                   k: pc.layout_ledger(n, k, mode=mode, block=block)
                   for k in (2, 4, 8) for mode in ("fp32",)},
               "ledger_int8_by_world": {
                   k: pc.layout_ledger(n, k, mode="int8", block=block,
                                       param_comm="int8")
                   for k in (2, 4, 8)}}
        emit(out)
        return out
    finally:
        dist.destroy_process_group()
        Engine.reset()
        _release()


def _zero1_lm_rank(rank, world, port, grad_comm, audit, q):
    """One rank of the sharded LM driver: NCCL over ``world`` processes,
    one card each; train_lm_bundles' run at K = 4 (with ``audit``, the
    driver's overlap audit first, ``BIGDL_TPU_MEASURE_OVERLAP=1``)."""
    import torch.distributed as dist

    if audit:
        os.environ["BIGDL_TPU_MEASURE_OVERLAP"] = "1"
    try:
        from bigdl_tpu_torch.runtime import EngineConfig, init_engine
        from bigdl_tpu_torch.tensor.policy import apply_precision_policy

        eng = init_engine(EngineConfig(
            coordinator_address=f"127.0.0.1:{port}", num_processes=world,
            process_id=rank, grad_comm=grad_comm,
            timeout_s=ZERO1["wait_s"]))
        apply_precision_policy()

        def ledger(opt):
            snap = opt.metrics.snapshot()["gauges"]
            return {"gauges": {k: v for k, v in snap.items()
                               if "collective" in k or "buckets" in k
                               or "overlap" in k or "exposed" in k},
                    "overlap_audit": opt.overlap_audit,
                    "device": str(eng.device),
                    "backend": dist.get_backend()}

        out = _bundle_run(_lm_bundle_maker(eng.device), BUNDLE["k"],
                          BUNDLE["steps"], extra=ledger)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(target, world, args):
    """``target(rank, world, *args, queue)`` in ``world`` spawned
    processes; their results in rank order.  Raises if a rank raised or
    hung; every process is stopped before it returns."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, val = q.get(timeout=ZERO1["wait_s"])
            except queue.Empty:
                errors.append(f"ranks {sorted(set(range(world)) - set(out))}"
                              f" gave no answer in {ZERO1['wait_s']} s")
                break
            (out.__setitem__(rank, val) if ok
             else errors.append(f"rank {rank}: {val}"))
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
                p.join(30)
    if errors or len(out) != world:
        raise AssertionError("ranks failed:\n" + "\n".join(errors))
    return [out[r] for r in range(world)]


def _zero1_driver(dev, ref):
    """The sharded driver at world = the card count: world 1's losses
    equal the single-process run's (``ref``) to the bit; with more cards,
    fp32 and int8 wires at world min(count, 4) within 2e-3 of world 1."""
    count = torch.cuda.device_count()
    runs = {}
    ranks = _run_ranks(_zero1_lm_rank, count, (_free_port(), "fp32", False))
    runs[f"world{count}_fp32"] = ranks
    one = ranks[0] if count == 1 else None
    if count >= 2:
        one = _run_ranks(_zero1_lm_rank, 1,
                         (_free_port(), "fp32", False))[0]
        runs["world1_fp32"] = [one]
        world = min(count, ZERO1["world_max"])
        for wire in ("fp32", "int8"):
            runs[f"world{world}_{wire}"] = _run_ranks(
                _zero1_lm_rank, world, (_free_port(), wire, False))
    if one["losses"] != ref:
        raise AssertionError(f"world 1's losses differ from the single-"
                             f"process run's: {one['losses']} vs {ref}")
    want = {nm: float(LM["num_layers"]) for nm in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}
    summary = {}
    for key, ranks in runs.items():
        r0 = ranks[0]
        got = {nm: r0["launches_per_step"].get(nm) for nm in want}
        if got != want:
            raise AssertionError(f"{key}: flash launches a step {got}")
        last = r0["losses"][-1]
        rel = abs(last - one["losses"][-1]) / abs(one["losses"][-1])
        if rel > ZERO1["rel"] or not np.all(np.isfinite(r0["losses"])):
            raise AssertionError(f"{key}: last loss {last} against world "
                                 f"1's {one['losses'][-1]}")
        summary[key] = {
            "world": len(ranks), "step_ms": [r["step_ms"] for r in ranks],
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
            "graphs_captured": r0["graphs_captured"],
            "devices": [r["device"] for r in ranks],
            "backend": r0["backend"], "gauges": r0["gauges"],
            "losses": r0["losses"], "last_loss_rel_to_world1": rel,
            "launches_per_step": {nm: r0["launches_per_step"].get(nm)
                                  for nm in want}}
    out = {"phase": "train_zero1_driver", "device_count": count,
           "worlds_run": sorted({len(r) for r in runs.values()}),
           "world1_losses_bit_equal_to_single_process": True,
           "runs": summary}
    emit(out)
    _zero1_overlap(ref)
    return out


def _zero1_overlap(ref):
    """The driver's overlap audit (``BIGDL_TPU_MEASURE_OVERLAP=1``) at
    world 1 over NCCL before train_lm_bundles' K = 4 run: the audit's
    keys and gauges, and the run's losses equal to the single-process
    run's (``ref``) to the bit, as a run without the audit's are."""
    r = _run_ranks(_zero1_lm_rank, 1, (_free_port(), "fp32", True))[0]
    ov = r["overlap_audit"]
    out = {"phase": "train_zero1_overlap", "world": 1, "backend":
           r["backend"], "nvidia_smi": nvidia_smi(), "overlap_audit": ov,
           "gauges": {k: v for k, v in r["gauges"].items()
                      if "overlap" in k or "exposed" in k},
           "losses": r["losses"],
           "losses_bit_equal_to_unaudited": r["losses"] == ref}
    emit(out)
    keys = {"step_s", "compute_s", "collective_s", "exposed_collective_s",
            "overlap_efficiency", "comm_buckets", "grad_comm"}
    if not (ov and set(ov) == keys and 0.0 <= ov["overlap_efficiency"]
            <= 1.0 and r["losses"] == ref):
        raise AssertionError(f"overlap audit: {out}")
    return out


def _zero1_mlp(ckpt_dir, dev, end, mirror=None):
    """test_grad_comm's MLP and data through the Optimizer: global batch
    16, SGD 0.2 with momentum, checkpoints every 3 (a mirror beside)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    rs = np.random.RandomState(0)
    x = rs.randn(ZERO1["rows"], 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    torch.manual_seed(SEED)
    opt = Optimizer(nn.Sequential([nn.Linear(8, 16), nn.ReLU(),
                                   nn.Linear(16, 2)]),
                    DataSet.array(x, y), nn.CrossEntropyCriterion(),
                    batch_size=ZERO1["batch"], seed=3, device=dev)
    opt.set_optim_method(SGD(learning_rate=0.2, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(end))
    opt.set_checkpoint(ckpt_dir, Trigger.several_iteration(
        ZERO1["ckpt_every"]), mirror=mirror)
    opt.optimize()
    return opt


def _zero1_cpu_rank(rank, world, rdv, ckpt_dir, mirror, q):
    """One of the CPU gloo ranks that write the sharded checkpoint."""
    import torch.distributed as dist

    try:
        from bigdl_tpu_torch.runtime import EngineConfig, init_engine

        torch.set_num_threads(1)
        init_engine(EngineConfig(coordinator_address=rdv,
                                 num_processes=world, process_id=rank,
                                 timeout_s=ZERO1["wait_s"]), device="cpu")
        opt = _zero1_mlp(ckpt_dir, "cpu", ZERO1["ckpt_every"], mirror)
        q.put((rank, True, opt.losses))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _zero1_checkpoint(dev):
    """Two CPU gloo ranks write a sharded checkpoint mid-epoch with a
    mirror; the card resumes it at world 1 (re-sharded epoch) and its
    losses are held to a CPU resume of the same checkpoint."""
    from bigdl_tpu_torch.optim import checkpoint as ckpt
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    with tempfile.TemporaryDirectory(prefix="zero1_ckpt_") as d:
        primary, mirror = os.path.join(d, "ck"), os.path.join(d, "mirror")
        written = _run_ranks(_zero1_cpu_rank, 2, (
            f"file://{d}/rendezvous", primary, mirror))
        latest = ckpt.latest_checkpoint(primary)
        names = sorted(os.listdir(latest))
        with open(os.path.join(latest, "manifest.json")) as f:
            manifest = json.load(f)
        shards = [nm for nm in names if nm.startswith("opt_state.shard")]
        mirror_equal = all(
            _tree_bytes(os.path.join(mirror, c))
            == _tree_bytes(os.path.join(primary, c))
            for c in os.listdir(primary)) and \
            sorted(os.listdir(mirror)) == sorted(os.listdir(primary))
        if len(shards) != 2 or manifest["opt_shards"] != 2 \
                or manifest["driver_state"]["process_count"] != 2 \
                or not mirror_equal:
            raise AssertionError(f"sharded checkpoint: {names} {manifest} "
                                 f"mirror equal {mirror_equal}")
        resumed = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            copy = os.path.join(d, where)
            shutil.copytree(primary, copy)
            with compute_dtype(torch.float32):
                opt = _zero1_mlp(copy, device, ZERO1["resume_to"])
            resumed[where] = {
                "losses": opt.losses,
                "elastic_resharded": opt.metrics.counter(
                    "elastic_resharded_total"),
                "final_iteration": opt.final_state["iteration"]}
    diff = float(np.max(np.abs(np.asarray(resumed["card"]["losses"])
                               - np.asarray(resumed["cpu"]["losses"]))))
    out = {"phase": "train_zero1_checkpoint", "writer_world": 2,
           "writer_backend": "gloo", "checkpoint": os.path.basename(latest),
           "shard_files": shards, "mirror_equal_to_primary": mirror_equal,
           "writer_losses": written[0], "resumed": resumed,
           "max_abs_loss_diff_card_cpu": diff, "atol": ZERO1["atol"]}
    emit(out)
    steps = ZERO1["resume_to"] - ZERO1["ckpt_every"]
    for r in resumed.values():
        if (r["elastic_resharded"] != 1 or len(r["losses"]) != steps
                or r["final_iteration"] != ZERO1["resume_to"]):
            raise AssertionError(f"resume: {out}")
    if not diff <= ZERO1["atol"]:
        raise AssertionError(f"card resume against CPU resume: {out}")
    return out


def _zero1_gloo_rank(rank, world, rdv, q):
    """gloo on CUDA tensors of the one card: each wire collective once,
    its result checked; when all three run, the LM run of the sharded
    phase at K = 1 (gloo cannot run inside a captured graph) over the two
    ranks, each on the same card."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import collectives as pc

    try:
        dist.init_process_group("gloo", init_method=rdv, world_size=world,
                                rank=rank)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        x = torch.arange(world * 8, dtype=torch.float32, device=dev)
        grp = dist.group.WORLD

        def gather():
            out = torch.empty(world * 8, device=dev)
            pc.all_gather(out, x[:8].contiguous(), grp)
            return out

        tries = {
            "reduce_scatter": (lambda: pc.reduce_scatter_wire(
                x.view(world, -1), grp, "fp32"),
                world * x.view(world, -1)[rank]),
            "all_to_all": (lambda: pc.reduce_scatter_wire(
                x.view(world, -1), grp, "int8", block=8),
                world * x.view(world, -1)[rank]),
            "all_gather": (gather, x[:8].repeat(world)),
        }
        res = {}
        for name, (fn, want) in tries.items():
            try:
                got = fn()
                torch.cuda.synchronize()
                # the int8 wire: one quantization step a source
                tol = world * float(x.abs().max()) / 127.0 \
                    if name == "all_to_all" else 0.0
                res[name] = ("ran, right" if got.device == dev and float(
                    (got - want).abs().max()) <= tol else "ran, WRONG")
            except Exception as e:       # what gloo says, reported
                res[name] = f"{type(e).__name__}: {str(e)[:200]}"
        out = {"collectives": res}
        if all(v == "ran, right" for v in res.values()):
            from bigdl_tpu_torch.runtime import init_engine

            init_engine()                # joins the gloo group
            out["lm"] = _bundle_run(_lm_bundle_maker(dev), 1,
                                    BUNDLE["steps"])
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _zero1_gloo_card(ref):
    """Two ranks on the one card over gloo: what each collective did,
    and, when all ran right, the LM's last loss against the single-process
    run's (``ref``) within 2e-3."""
    with tempfile.TemporaryDirectory(prefix="zero1_gloo_") as d:
        res = _run_ranks(_zero1_gloo_rank, 2, (f"file://{d}/rendezvous",))
    out = {"phase": "train_zero1_gloo_card", "world": 2, "devices": "cuda:0",
           "backend": "gloo",
           "what_each_collective_did": res[0]["collectives"]}
    if "lm" in res[0]:
        lm = res[0]["lm"]
        rel = abs(lm["losses"][-1] - ref[-1]) / abs(ref[-1])
        out.update(trained=True, k=1, step_ms=[r["lm"]["step_ms"]
                                               for r in res],
                   peak_mem_gb=[r["lm"]["peak_mem_gb"] for r in res],
                   losses=lm["losses"], last_loss_rel_to_world1=rel,
                   launches_per_step=lm["launches_per_step"])
        emit(out)
        if not (rel <= ZERO1["rel"] and res[1]["lm"]["losses"]
                == lm["losses"]):
            raise AssertionError(f"two ranks on one card over gloo: {out}")
    else:
        out["trained"] = False
        emit(out)
    return out


def train_zero1(dev, ref=None):
    """train_zero1's four parts (the module docstring, 20).  ``ref``: the
    single-process run's losses (train_lm_bundles'); without it the same
    run is made here first."""
    if ref is None:
        ref = _bundle_run(_lm_bundle_maker(dev), BUNDLE["k"],
                          BUNDLE["steps"])["losses"]
    _release()
    out = {"collectives": _zero1_collectives(dev)}
    out["driver"] = _zero1_driver(dev, ref)
    out["checkpoint"] = _zero1_checkpoint(dev)
    out["gloo_card"] = _zero1_gloo_card(ref)
    return out


@contextlib.contextmanager
def _nccl_world1():
    """A process group of this process alone over NCCL (a ``file://``
    rendezvous), destroyed after."""
    import torch.distributed as dist

    from bigdl_tpu_torch.runtime import Engine, EngineConfig, init_engine

    with tempfile.TemporaryDirectory(prefix="layout_rdv_") as d:
        init_engine(EngineConfig(
            coordinator_address=f"file://{d}/rendezvous", num_processes=1,
            process_id=0, timeout_s=ZERO1["wait_s"]))
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"the card's group runs "
                                     f"{dist.get_backend()}, not NCCL")
            yield
        finally:
            dist.destroy_process_group()
            Engine.reset()
            _release()


def _layout_data(batch=None, seq=None, steps=None):
    rs = np.random.RandomState(SEED + 7)
    shape = ((batch or TRAIN["batch"]) * (steps or LAYOUT["steps"]),
             seq or TRAIN["seq"])
    return tuple(rs.randint(0, LM["vocab_size"], shape).astype(np.int32)
                 for _ in range(2))


def _layout_plain(dev, ids, tgt, lm=None, batch=None):
    """fit_layout's steps in a plain single-device loop: its batch plan,
    the LM (``lm``, LM by default) from the same seed, Adam 1e-4 on the
    plain parameters.  Returns (losses, step seconds)."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.optim import Adam

    model = Transformer(**(lm or LM), dropout=0.0, seed=SEED).to(dev)
    model.train(True)
    crit, opt = CrossEntropyCriterion(), Adam(learning_rate=TRAIN["lr"])
    params = list(model.parameters())
    state = opt.init_state(params)
    losses, times = [], []
    for i, mb in enumerate(DataSet.array(ids, tgt).batches(
            batch or TRAIN["batch"], shuffle=True, seed=SEED, epoch=0)):
        t0 = time.perf_counter()
        for p in params:
            p.grad = None
        x = torch.as_tensor(mb["input"]).to(dev)
        y = torch.as_tensor(mb["target"]).to(dev)
        loss = crit(model(x), y)
        loss.backward()
        with torch.no_grad():
            opt.apply(opt.step_tensors(i, dev), [p.grad for p in params],
                      params, state)
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t0)
    del model, state
    _release()
    return losses, times


class _StepClock:
    """Wraps ``GSPMDTrainStep.train_step``: the time of each step (the
    step ends synchronized: fit_layout reads its loss) and a profiled
    window of steps [busy_from, the end): the device's kernel time over
    the wall time.  ``busy_from=None`` profiles nothing."""

    def __init__(self, busy_from=None):
        from bigdl_tpu_torch.parallel import gspmd

        self.cls, self.orig, self.busy_from = gspmd.GSPMDTrainStep, None, \
            busy_from
        self.step_s, self.prof, self.busy = [], None, None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        orig = self.orig = self.cls.train_step

        def timed(step, it, *a, **k):
            if it == self.busy_from:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.t_busy = time.perf_counter()
            t0 = time.perf_counter()
            loss = orig(step, it, *a, **k)
            float(loss)                  # what fit_layout does next
            self.step_s.append(time.perf_counter() - t0)
            return loss

        self.cls.train_step = timed
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig
        if self.prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t_busy
            self.prof.stop()
            kernels = _device_kernels(self.prof.key_averages())
            dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
            self.busy = {"steps": len(self.step_s) - self.busy_from,
                         "wall_s": wall, "device_busy_s": dev_s,
                         "busy_share": dev_s / wall,
                         "kernel_launches": sum(e.count for e in kernels)}


def _layout_fit(dev, policy, ids, tgt, lm=None, batch=None,
                busy_from=None):
    """One fit_layout run of the LM (``lm``, LM by default) under
    ``policy``: its stats, step times (the profiled window's apart),
    flash launches a step, peak memory and busy share."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.ops.common import LAUNCHES, reset_launches
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.parallel import fit_layout

    lm = lm or LM
    batch = batch or TRAIN["batch"]
    model = Transformer(**lm, dropout=0.0, seed=SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with _StepClock(busy_from) as clock:
        trained, stats = fit_layout(
            model, CrossEntropyCriterion(), Adam(learning_rate=TRAIN["lr"]),
            DataSet.array(ids, tgt), parallelism=policy, batch_size=batch,
            epochs=1, seed=SEED, log_every=0, device=dev)
    steps = stats["iterations"]
    launches = {k: LAUNCHES.get(k, 0) / steps for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}
    timed = clock.step_s[1:busy_from]      # after the first, unprofiled
    placements = sorted({str(p.placements) for p in trained._step.params})
    out = {"policy": policy, "mesh": stats["mesh"],
           "dtensor_mesh": str(trained._step.mesh), "placements": placements,
           "losses": stats["losses"],
           "step_ms": [s * 1e3 for s in clock.step_s],
           "median_step_ms": float(np.median(timed)) * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "busy": clock.busy, "flash_launches_per_step": launches,
           "replicated_params": stats["replicated_params"],
           "collective_bytes_by_axis": stats["collective_bytes_by_axis"],
           "param_bytes_per_chip": stats["param_bytes_per_chip"]}
    out["tokens_per_s"] = (batch * ids.shape[1]
                           / out["median_step_ms"] * 1e3)
    del trained, model
    _release()
    return out


def layout_lm(dev):
    """Phase 21(a): the LM through fit_layout at world 1 over NCCL under
    each of LAYOUT["policies"], held to the plain loop."""
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    ids, tgt = _layout_data()
    with compute_dtype(torch.float32):
        plain, plain_s = _layout_plain(dev, ids, tgt)
        runs = {}
        with _nccl_world1():
            for policy in LAYOUT["policies"]:
                runs[policy] = _layout_fit(dev, policy, ids, tgt,
                                           busy_from=LAYOUT["busy_from"])
            serve = layout_serve(dev)
            decode = layout_decode(dev)
            int8 = layout_int8_predict(dev)
    want = {k: float(LM["num_layers"]) for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}
    for run in runs.values():
        diff = np.abs(np.asarray(run["losses"]) - np.asarray(plain))
        run["max_rel_loss_diff_to_plain"] = float(
            np.max(diff / np.abs(np.asarray(plain))))
        run["bit_equal_to_plain"] = run["losses"] == plain
    out = {"phase": "layout_lm", "world": 1, "backend": "nccl",
           "compute_dtype": "float32", "steps": LAYOUT["steps"],
           "plain_losses": plain,
           "plain_median_step_ms": float(np.median(
               plain_s[1:LAYOUT["busy_from"]])) * 1e3,
           "loss_rtol": LAYOUT_LOSS_RTOL, "runs": runs}
    emit(out)
    for policy, run in runs.items():
        if run["flash_launches_per_step"] != want:
            raise AssertionError(f"layout_lm {policy}: flash launches a "
                                 f"step {run['flash_launches_per_step']}")
        if not (run["max_rel_loss_diff_to_plain"] <= LAYOUT_LOSS_RTOL
                and run["replicated_params"] == 0
                and np.all(np.isfinite(run["losses"]))
                and (policy == "dp" or any("Shard" in p
                                           for p in run["placements"]))):
            raise AssertionError(f"layout_lm {policy}: {run}")
    out["serve"] = serve
    out["decode_launches"] = decode
    out["int8_predict_launches"] = int8
    return out


def layout_serve(dev):
    """Phase 21(b), inside layout_lm's world-1 group:
    ``InferenceModel(lm, layout="tp")`` against the unsharded one."""
    import copy

    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.ops.common import LAUNCHES, reset_launches
    from bigdl_tpu_torch.serving.inference_model import InferenceModel

    model = Transformer(**LM, dropout=0.0, seed=SEED)
    ref = InferenceModel(copy.deepcopy(model), device=dev,
                         batch_buckets=LAYOUT["serve_buckets"])
    im = InferenceModel(model, device=dev,
                        batch_buckets=LAYOUT["serve_buckets"], layout="tp")
    rs = np.random.RandomState(SEED + 8)
    x = rs.randint(0, LM["vocab_size"],
                   (max(LAYOUT["serve_buckets"]), LAYOUT["serve_seq"]))
    rows = {}
    for n in LAYOUT["serve_buckets"]:
        reset_launches()
        got = im.predict(x[:n])
        fwd = LAUNCHES.get("flash_attention_fwd", 0)
        want = ref.predict(x[:n])
        rows[n] = {"bit_equal": bool(np.array_equal(got, want)),
                   "shape": list(got.shape),
                   "flash_fwd_launches": fwd,
                   "max_abs_diff": float(np.max(np.abs(got - want)))}
    out = {"phase": "layout_serve", "world": 1, "layout": "tp",
           "mesh": im.layout.sizes, "buckets": rows,
           "embedding_placements": str(im.model.embedding.placements)}
    emit(out)
    if "Shard" not in out["embedding_placements"]:
        raise AssertionError(f"layout_serve: the embedding is "
                             f"{out['embedding_placements']}, not sharded")
    for n, row in rows.items():
        if not row["bit_equal"] or row["flash_fwd_launches"] != \
                LM["num_layers"]:
            raise AssertionError(f"layout_serve bucket {n}: {row}")
    del im, ref, model
    _release()
    return out


def _layout_engine(dev, model, layout, **cfg):
    """An InferenceModel of ``model`` with a decode engine of DECODE and
    ``cfg`` (``layout`` None: unlaid-out), on a sample-keeping registry,
    warmed up (its graphs captured, eager engines capture nothing):
    (im, warmup row)."""
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    wq = cfg.pop("weight_quant", None)
    im = InferenceModel(model, decode=DecodeConfig(**{**DECODE, **cfg}),
                        device=dev, layout=layout, weight_quant=wq)
    eng = im.decode_engine
    eng.metrics = _sample_metrics()
    torch.cuda.synchronize()
    im.warmup()
    return im, {"warmup_s": eng.warmup_s,
                "graphs_captured": eng.graphs_captured,
                "graph_captures_counted": eng.metrics.counter(
                    "serving.decode.graph_captures")}


def _layout_pair(dev, prompts, name, **cfg):
    """The unlaid-out engine and the one on LAYOUT_DECODE["layout"], each
    on its own copy of the seeded LM, one timed run each: their rows,
    and the check that the tokens and summed log-probs are equal to the
    bit, that the layout's run captured nothing and that every decode
    step of every layer launched the paged decode kernel."""
    import copy

    model = _lm_model()
    out, results = {}, {}
    for key, layout in (("plain", None), ("layout", LAYOUT_DECODE["layout"])):
        im, warm = _layout_engine(
            dev, copy.deepcopy(model) if layout else model, layout, **cfg)
        try:
            r = _serve_run(im, prompts)     # graphs, the ambient float32
            eng = im.decode_engine
            results[key] = r["results"]
            steps = r["delta"]["steps"]
            row = {**r["row"], "warmup": warm,
                   "graph_captures_after_warmup": eng.metrics.counter(
                       "serving.decode.graph_captures"),
                   "unexpected_captures": eng.metrics.counter(
                       "serving.decode.unexpected_captures"),
                   "paged_decode_launches": r["launches"].get(
                       "paged_decode_attention", 0),
                   "decode_steps": steps, "launches": r["launches"]}
            if layout:
                row["wq_placements"] = str(
                    eng.adapter.model.decoder[0].attn.wq.placements)
                w8 = eng.adapter._w8
                if w8 is not None:
                    row["int8_weight_bytes_a_rank"] = sum(
                        w.to_local().numel() + 4 * s.to_local().numel()
                        for _, w, s in w8._q.values())
            out[key] = row
            if row["graph_captures_after_warmup"] or \
                    row["unexpected_captures"]:
                raise AssertionError(f"{name} {key}: graphs captured after "
                                     f"warmup: {row}")
            if steps < 1 or row["paged_decode_launches"] != \
                    LM["num_layers"] * steps:
                raise AssertionError(f"{name} {key}: paged_decode_attention "
                                     f"launched {row['launches']} over "
                                     f"{steps} steps")
        finally:
            im.stop()
            del im
            _release()
    a, b = results["plain"], results["layout"]
    out["tokens_equal"] = all(x.tokens.tolist() == y.tokens.tolist()
                              for x, y in zip(a, b)) and len(a) == len(b)
    out["logp_equal"] = all(x.logp == y.logp for x, y in zip(a, b))
    if not (out["tokens_equal"] and out["logp_equal"]):
        raise AssertionError(f"{name}: the layout's tokens differ from the "
                             f"unlaid-out engine's")
    return out


def layout_decode(dev):
    """Inside layout_lm's world-1 group, float32 products: the LM through
    ``InferenceModel(lm, layout="tp", decode=DecodeConfig(**DECODE))``,
    its graphs captured by warmup, against the unlaid-out graphs engine,
    float32 then int8 weights, then a short speculative run on the
    layout (eager) against the unlaid-out one: tokens to the bit, the
    paged decode and verify kernels' launches counted."""
    import copy

    from bigdl_tpu_torch.serving import SpecConfig

    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(2, LM["vocab_size"], n).astype(np.int32)
               for n in rs.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                   N_REQUESTS)][:LAYOUT_DECODE["requests"]]
    out = {"phase": "layout_decode", "world": 1, "backend": "nccl",
           "layout": LAYOUT_DECODE["layout"], "compute_dtype": "float32",
           "decode": DECODE, "requests": len(prompts)}
    out["f32"] = _layout_pair(dev, prompts, "layout_decode f32")
    out["int8"] = _layout_pair(dev, prompts, "layout_decode int8",
                               weight_quant="int8")
    # speculation on the layout, eager: the draft's FFNs on the float32
    # block-sparse kernel through local_map, every iteration's verify on
    # the paged verify kernel
    c = LAYOUT_DECODE
    model = _lm_model()
    spec, n_calls = {}, {}
    for key, layout in (("plain", None), ("layout", c["layout"])):
        im, warm = _layout_engine(
            dev, copy.deepcopy(model) if layout else model, layout,
            speculative=SpecConfig(**SPEC), cuda_graphs=False,
            max_new_tokens=c["spec_max_new"])
        try:
            r = _serve_run(im, prompts[:c["spec_prompts"]], mode="eager")
        finally:
            im.stop()
            del im
            _release()
        d, n = r["delta"], r["launches"]
        _spec_launches_check(n, d["steps"], d["prefill_calls"], SPEC["k"],
                             f"layout_decode spec {key}")
        if n.get("paged_verify_attention", 0) != LM["num_layers"] * \
                d["steps"]:
            raise AssertionError(f"layout_decode spec {key}: "
                                 f"paged_verify_attention launched {n}")
        spec[key] = {**r["row"], "spec_iterations": d["steps"],
                     "prefill_calls": d["prefill_calls"],
                     "drafted": d["spec_drafted"],
                     "accepted": d["spec_accepted"],
                     "verify_launches": n.get("paged_verify_attention", 0),
                     "block_sparse_launches": n.get("block_sparse_matmul",
                                                    0)}
        n_calls[key] = [(x.tokens.tolist(), x.logp) for x in r["results"]]
    spec["tokens_equal"] = n_calls["plain"] == n_calls["layout"]
    out["spec"] = spec
    emit(out)
    if not spec["tokens_equal"]:
        raise AssertionError("layout_decode spec: the layout's tokens "
                             "differ from the unlaid-out engine's")
    return {"paged_decode_attention": out["f32"]["layout"][
                "paged_decode_launches"],
            "paged_decode_attention_int8_weights": out["int8"]["layout"][
                "paged_decode_launches"],
            "paged_verify_attention": spec["layout"]["verify_launches"],
            "block_sparse_matmul": spec["layout"]["block_sparse_launches"]}


def layout_int8_predict(dev):
    """Inside layout_lm's world-1 group, float32 products: ResNet-50 int8
    through ``InferenceModel(resnet, layout="tp", weight_quant="int8")``
    at one bucket against the unlaid-out int8 model, to the bit, with
    the int8 matmul's launches and the int8 weight bytes a rank."""
    import copy

    from bigdl_tpu_torch.nn.quantized import (QuantizedConv2D,
                                              QuantizedLinear)
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.serving import InferenceModel

    c = LAYOUT_INT8
    model = resnet_model()
    x = np.random.RandomState(SEED + 9).rand(
        c["bucket"], *IMAGE).astype(np.float32)
    rows = {}
    for key, layout in (("plain", None), ("layout", c["layout"])):
        im = InferenceModel(copy.deepcopy(model) if layout else model,
                            device=dev, weight_quant="int8",
                            batch_buckets=(c["bucket"],), layout=layout)
        twins = [m for m in im.model.modules()
                 if isinstance(m, (QuantizedConv2D, QuantizedLinear))]
        local = (lambda t: t.to_local()) if layout else (lambda t: t)
        im.predict(x[:1])                       # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pred = im.predict(x)
        torch.cuda.synchronize()
        rows[key] = {
            "pred": pred, "ms": (time.perf_counter() - t0) * 1e3,
            "int8_matmul_launches": LAUNCHES.get("int8_matmul", 0),
            "int8_layers": len(twins),
            "int8_weight_bytes_a_rank": sum(
                local(m.weight_q).numel() + 4 * local(m.scales).numel()
                for m in twins)}
        if layout:
            rows[key]["weight_q_placements"] = sorted(
                {str(m.weight_q.placements) for m in twins})
        del im
        _release()
    a, b = rows["plain"].pop("pred"), rows["layout"].pop("pred")
    out = {"phase": "layout_int8_predict", "world": 1, "backend": "nccl",
           "layout": c["layout"], "bucket": c["bucket"],
           "compute_dtype": "float32", "shape": list(b.shape),
           "bit_equal": bool(np.array_equal(a, b)),
           "max_abs_diff": float(np.max(np.abs(a - b))), **rows}
    emit(out)
    for key, row in rows.items():
        if row["int8_matmul_launches"] != row["int8_layers"] or \
                row["int8_layers"] != 54:
            raise AssertionError(f"layout_int8_predict {key}: {row}")
    if not (out["bit_equal"] and np.isfinite(b).all()):
        raise AssertionError(f"layout_int8_predict: the layout's answers "
                             f"differ from the unlaid-out model's: {out}")
    return rows["layout"]["int8_matmul_launches"]


def _gloo_lm():
    """layout_gloo_card's LM: LM's widths at LAYOUT["gloo_layers"]."""
    return dict(LM, num_layers=LAYOUT["gloo_layers"])


def _gloo_data():
    return _layout_data(LAYOUT["gloo_batch"], LAYOUT["gloo_seq"],
                        LAYOUT["gloo_steps"])


def _layout_gloo_rank(rank, world, rdv, q):
    """One of two processes on the one card over gloo (every gloo wait
    bounded by LAYOUT["gloo_wait_s"]): the collectives a layout's
    DTensors issue, through ``torch.distributed`` and through the
    functional collectives DTensor calls, each announced on ``q`` before
    it starts and reported after, then, when all ran right,
    layout_gloo_card's LM under LAYOUT["gloo_policy"]."""
    import datetime

    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from bigdl_tpu_torch.parallel import collectives as pc
    from bigdl_tpu_torch.tensor.policy import (apply_precision_policy,
                                               compute_dtype)

    try:
        dist.init_process_group(
            "gloo", init_method=rdv, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=LAYOUT["gloo_wait_s"]))
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        apply_precision_policy()
        x = torch.arange(world * 8, dtype=torch.float32, device=dev)
        grp = dist.group.WORLD

        def gather():
            out = torch.empty(world * 8, device=dev)
            pc.all_gather(out, x[:8].contiguous(), grp)
            return out

        def reduce():
            out = x.clone()
            dist.all_reduce(out, group=grp)
            return out

        tries = {
            "reduce_scatter": (lambda: pc.reduce_scatter_wire(
                x.view(world, -1), grp, "fp32"),
                world * x.view(world, -1)[rank]),
            "all_gather": (gather, x[:8].repeat(world)),
            "all_reduce": (reduce, world * x),
            "funcol_all_reduce": (lambda: funcol.all_reduce(
                x, "sum", grp).wait(), world * x),
            "funcol_all_gather": (lambda: funcol.all_gather_tensor(
                x[:8].contiguous(), 0, grp).wait(), x[:8].repeat(world)),
            "funcol_reduce_scatter": (lambda: funcol.reduce_scatter_tensor(
                x, "sum", 0, grp).wait(), world * x.view(world, -1)[rank]),
        }
        res = {}
        for name, (fn, want) in tries.items():
            q.put(("start", rank, name))
            try:
                got = fn()
                torch.cuda.synchronize()
                res[name] = ("ran, right" if got.device == dev and float(
                    (got - want).abs().max()) == 0.0 else "ran, WRONG")
            except Exception as e:       # what gloo says, reported
                res[name] = f"{type(e).__name__}: {str(e)[:200]}"
            q.put(("did", rank, name, res[name]))
        out = {"collectives": res}
        if all(v == "ran, right" for v in res.values()):
            q.put(("train", rank))
            ids, tgt = _gloo_data()
            with compute_dtype(torch.float32):
                out["lm"] = _layout_fit(dev, LAYOUT["gloo_policy"], ids, tgt,
                                        lm=_gloo_lm(),
                                        batch=LAYOUT["gloo_batch"])
        q.put(("done", rank, out))
    except BaseException:
        q.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _gloo_card_ranks(rdv, target=None, wait_s=None, probe_s=None,
                     name="layout_gloo_card"):
    """Two processes of ``target`` (layout_gloo_card's by default): (what
    each collective did, each rank's result or None).  A collective that
    gives no answer within ``probe_s`` (LAYOUT["gloo_probe_s"]) is
    reported as hung (what gloo can do, which fails nothing); a hang at
    start-up or in the training (``2 x wait_s``), or an error, raises.
    Every process is stopped before it returns."""
    target = target or _layout_gloo_rank
    wait_s = wait_s or LAYOUT["gloo_wait_s"]
    probe_s = probe_s or LAYOUT["gloo_probe_s"]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, 2, rdv, q))
             for r in range(2)]
    for p in procs:
        p.start()
    did, started, done, errors, training = {}, {}, {}, [], False
    heard = set()
    try:
        while len(done) + len(errors) < 2:
            # start-up (spawn, imports, the rendezvous) and the training
            # take long; once both ranks probe, each collective is short
            wait = (probe_s if len(heard) == 2 and not training
                    else 2 * wait_s)
            try:
                msg = q.get(timeout=wait)
            except queue.Empty:
                if training or len(heard) < 2:
                    errors.append(f"the {'training' if training else 'start'}"
                                  f" over gloo gave no answer in {wait} s")
                for rank, name in started.items():
                    did.setdefault(name, f"hung (no answer in {wait} s, "
                                         f"rank {rank})")
                break
            kind, rank = msg[0], msg[1]
            heard.add(rank)
            if kind == "start":
                started[rank] = msg[2]
            elif kind == "did":
                started.pop(rank, None)
                if msg[3] != "ran, right" or msg[2] not in did:
                    did[msg[2]] = msg[3]
            elif kind == "train":
                training = True
            elif kind == "trained":
                training = False
            elif kind == "done":
                done[rank] = msg[2]
            else:
                errors.append(f"rank {rank}: {msg[2]}")
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(10)
    if errors:
        raise AssertionError(f"{name}:\n" + "\n".join(errors))
    return did, [done.get(r) for r in range(2)]


def layout_gloo_card(dev):
    """Phase 21(c): two gloo processes on the one card, held to the same
    cut run in a plain loop in this process."""
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    with tempfile.TemporaryDirectory(prefix="layout_gloo_") as d:
        did, res = _gloo_card_ranks(f"file://{d}/rendezvous")
    out = {"phase": "layout_gloo_card", "world": 2, "devices": "cuda:0",
           "backend": "gloo", "policy": LAYOUT["gloo_policy"],
           "lm": _gloo_lm(), "batch": [LAYOUT["gloo_batch"],
                                       LAYOUT["gloo_seq"]],
           "what_each_collective_did": did}
    if res[0] is not None and "lm" in res[0]:
        ids, tgt = _gloo_data()
        with compute_dtype(torch.float32):
            ref, _ = _layout_plain(dev, ids, tgt, lm=_gloo_lm(),
                                   batch=LAYOUT["gloo_batch"])
        out["plain_losses"] = ref
        lm = res[0]["lm"]
        rel = abs(lm["losses"][-1] - ref[-1]) / abs(ref[-1])
        out.update(trained=True, run=lm, last_loss_rel_to_plain=rel,
                   rel=LAYOUT["rel"])
        emit(out)
        if not (rel <= LAYOUT["rel"] and res[1]["lm"]["losses"]
                == lm["losses"] and lm["flash_launches_per_step"][
                    "flash_attention_fwd"] == LAYOUT["gloo_layers"]):
            raise AssertionError(f"layout over gloo on one card: {out}")
    else:
        out["trained"] = False
        emit(out)
    return out


# ---------------------------------------------------------------------------
# 22: sequence parallelism on the card
# ---------------------------------------------------------------------------

def ring_fold(dev):
    """The ring's fold on one card at the LM's attention width (8, 12,
    1024, 64), float32, causal and not: P = RING["blocks"] blocks of 256
    as P ranks would hold them, the rotation by indexing
    (``parallel.ring_attention.ring_fold`` / ``ring_fold_bwd``: each
    visiting block through the flash kernels, merged by its lse).  The
    outputs and dQ / dK / dV against one flash call over the whole
    sequence and against the plain versions at RING["atol"]; the flash
    launches of the fold (causal: P (P + 1) / 2 forward calls and as many
    backward pairs); the fold's time beside the one call's."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref)
    from bigdl_tpu_torch.parallel.ring_attention import (ring_fold as fold,
                                                         ring_fold_bwd)

    h, d = LM["num_heads"], LM["hidden_size"] // LM["num_heads"]
    b, s, p = TRAIN["batch"], TRAIN["seq"], RING["blocks"]
    g = torch.Generator().manual_seed(SEED + 11)
    q, k, v, go = (torch.randn(b, h, s, d, generator=g).to(dev)
                   for _ in range(4))
    blocks = [t.chunk(p, dim=2) for t in (q, k, v, go)]
    atol = RING["atol"]
    out = {"phase": "ring_fold", "nvidia_smi": nvidia_smi(),
           "shape": [b, h, s, d], "blocks": p, "atol": atol, "rtol": atol,
           "runs": {}}
    launches = Counter()

    def timed(fn):
        fn()
        ts = []
        for _ in range(RING["reps"]):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return float(np.median(ts))

    for causal in (True, False):
        one_out, one_lse = flash_attention_fwd(q, k, v, causal=causal)
        one = flash_attention_bwd(q, k, v, one_out, one_lse, go,
                                  causal=causal)
        ro, rl = flash_attention_fwd_ref(q, k, v, causal=causal,
                                         sm_scale=d ** -0.5)
        rgrads = flash_attention_bwd_ref(q, k, v, ro, rl, go, causal=causal,
                                         sm_scale=d ** -0.5)
        reset_launches()
        outs, lses = fold(*blocks[:3], causal=causal)
        fwd_launches = dict(LAUNCHES)
        reset_launches()
        grads = ring_fold_bwd(*blocks[:3], outs, lses, blocks[3],
                              causal=causal)
        bwd_launches = dict(LAUNCHES)
        torch.cuda.synchronize()
        got = [torch.cat(outs, 2), torch.cat(lses, 2)] + [
            torch.cat(gr, 2) for gr in grads]
        errs = {}
        for ref_name, refs in (("one_call", [one_out, one_lse, *one]),
                               ("plain", [ro, rl, *rgrads])):
            for name, a, w in zip(("out", "lse", "dq", "dk", "dv"), got,
                                  refs):
                errs[f"{name}_vs_{ref_name}"] = float(
                    (a - w).abs().max())
                if not torch.allclose(a, w, rtol=atol, atol=atol):
                    raise AssertionError(
                        f"ring fold {name} (causal={causal}) disagrees "
                        f"with the {ref_name}: {errs}")
        want = p * (p + 1) // 2 if causal else p * p
        run = {"max_abs_err": errs,
               "launches_fwd": fwd_launches, "launches_bwd": bwd_launches,
               "calls_expected": want,
               "fold_fwd_ms": timed(lambda: fold(*blocks[:3],
                                                 causal=causal)),
               "one_call_fwd_ms": timed(lambda: flash_attention_fwd(
                   q, k, v, causal=causal)),
               "fold_bwd_ms": timed(lambda: ring_fold_bwd(
                   *blocks[:3], outs, lses, blocks[3], causal=causal)),
               "one_call_bwd_ms": timed(lambda: flash_attention_bwd(
                   q, k, v, one_out, one_lse, go, causal=causal))}
        out["runs"]["causal" if causal else "full"] = run
        if (fwd_launches.get("flash_attention_fwd") != want
                or bwd_launches.get("flash_attention_bwd_dq") != want
                or bwd_launches.get("flash_attention_bwd_dkdv") != want):
            raise AssertionError(f"ring fold launches (causal={causal}): "
                                 f"{fwd_launches} {bwd_launches}, want "
                                 f"{want} of each")
        launches["flash_attention_fwd"] += want
        launches["flash_attention_bwd"] += want
    emit(out)
    del q, k, v, go, blocks
    _release()
    return dict(launches)


def _seq_model(strategy, seed=SEED):
    """seq_gloo_card's model: Embedding, PositionalEncoding, SEQ_GLOO
    ["layers"] causal TransformerLayers at the LM's widths, a Linear
    head; random weights from ``seed``."""
    from bigdl_tpu_torch import nn

    c = SEQ_GLOO
    g = torch.Generator().manual_seed(seed)
    return nn.Sequential(
        [nn.Embedding(c["vocab"], c["d"], generator=g),
         nn.PositionalEncoding()]
        + [nn.TransformerLayer(c["d"], c["heads"], c["ffn"], dropout=0.0,
                               causal=True, seq_parallel=strategy,
                               generator=g) for _ in range(c["layers"])]
        + [nn.Linear(c["d"], c["vocab"], generator=g)])


def _seq_data():
    rs = np.random.RandomState(SEED + 13)
    shape = (SEQ_GLOO["batch"] * SEQ_GLOO["steps"], SEQ_GLOO["seq"])
    ids = rs.randint(0, SEQ_GLOO["vocab"], shape).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _seq_fit(dev, strategy):
    """SEQ_GLOO["steps"] eager steps of the seq model through the driver
    in float32 products; the seq axis is the engine's when it has one."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    ids, tgt = _seq_data()
    with compute_dtype(torch.float32):
        opt = (Optimizer(_seq_model(strategy), DataSet.array(ids, tgt),
                         CrossEntropyCriterion(),
                         batch_size=SEQ_GLOO["batch"], device=dev)
               .set_optim_method(Adam(learning_rate=SEQ_GLOO["lr"]))
               .set_end_when(Trigger.max_iteration(SEQ_GLOO["steps"])))
        opt.seq_parallel = strategy is not None
        reset_launches()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = SEQ_GLOO["steps"]
    return {"losses": opt.losses, "wall_s": wall,
            "flash_launches_per_step": {
                n: v / steps for n, v in LAUNCHES.items()
                if n.startswith("flash")}}


def _seq_gloo_rank(rank, world, rdv, q):
    """One of two processes on the one card over gloo with
    ``MeshSpec(seq=2)``: first what gloo carries on CUDA tensors (each
    collective the seq strategies call, announced on ``q``), then the
    seq model trained with each strategy whose collectives ran right."""
    import datetime

    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", init_method=rdv, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=SEQ_GLOO["wait_s"]))
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        x = torch.arange(world * 8, dtype=torch.float32, device=dev)
        # every probe on a group of its own: a collective that fails and
        # closes its connections leaves the others' (and the training's)
        grps = {n: dist.new_group(list(range(world)))
                for n in ("all_reduce", "all_to_all_single", "send_recv")}

        def send_recv():
            got = torch.empty(world * 8, device=dev)
            grp = grps["send_recv"]
            ops = [dist.P2POp(dist.isend, x, (rank + 1) % world, grp),
                   dist.P2POp(dist.irecv, got, (rank - 1) % world, grp)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return got

        def a2a():
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x + 100 * rank,
                                   group=grps["all_to_all_single"])
            return got

        def reduce():
            out = x.clone()
            dist.all_reduce(out, group=grps["all_reduce"])
            return out

        want_a2a = torch.cat([x.view(world, -1)[rank] + 100 * r
                              for r in range(world)])
        tries = {"send_recv": (send_recv, x),
                 "all_to_all_single": (a2a, want_a2a),
                 "all_reduce": (reduce, world * x)}
        needs = {"ring": ("all_reduce", "send_recv"),
                 "ulysses": ("all_reduce", "all_to_all_single")}
        res = {}
        out = {"collectives": res, "runs": {}}
        from bigdl_tpu_torch.runtime import EngineConfig, init_engine
        from bigdl_tpu_torch.runtime.mesh import MeshSpec

        init_engine(EngineConfig(mesh=MeshSpec(seq=2)))   # the gloo group
        # each strategy's collectives probed just before it trains, so a
        # collective that hangs stops only what comes after it
        for strategy in SEQ_GLOO["strategies"]:
            for name in needs[strategy]:
                if name in res:
                    continue
                fn, want = tries[name]
                q.put(("start", rank, name))
                try:
                    got = fn()
                    torch.cuda.synchronize()
                    res[name] = ("ran, right" if got.device == dev and float(
                        (got - want).abs().max()) == 0.0 else "ran, WRONG")
                except Exception as e:   # what gloo says, reported
                    res[name] = f"{type(e).__name__}: {str(e)[:200]}"
                q.put(("did", rank, name, res[name]))
            if all(res[n] == "ran, right" for n in needs[strategy]):
                q.put(("train", rank))
                out["runs"][strategy] = _seq_fit(dev, strategy)
                q.put(("trained", rank))
        q.put(("done", rank, out))
    except BaseException:
        q.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def seq_gloo_card(dev):
    """Two gloo processes on the one card, ``MeshSpec(seq=2)``: what gloo
    carries on CUDA tensors, then for each strategy it can carry the seq
    model's losses on both ranks against the same model trained unsharded
    in this process (last loss within SEQ_GLOO["rel"]), both ranks'
    losses equal, the flash launches a step of each rank (the ring:
    layers x (rank + 1) forward calls, as many backward pairs; Ulysses:
    layers).  A strategy whose collective gloo cannot carry on a CUDA
    tensor is named, and the ring's card proof rests on ring_fold."""
    with tempfile.TemporaryDirectory(prefix="seq_gloo_") as d:
        did, res = _gloo_card_ranks(
            f"file://{d}/rendezvous", _seq_gloo_rank, SEQ_GLOO["wait_s"],
            SEQ_GLOO["probe_s"], "seq_gloo_card")
    ref = _seq_fit(dev, None)
    out = {"phase": "seq_gloo_card", "world": 2, "devices": "cuda:0",
           "backend": "gloo", "mesh": {"seq": 2}, "model": SEQ_GLOO,
           "nvidia_smi": nvidia_smi(), "what_each_collective_did": did,
           "each_rank": [r["collectives"] if r else None for r in res],
           "unsharded": ref, "rel": SEQ_GLOO["rel"], "runs": {},
           "not_carried": {}}
    bad = []
    layers = SEQ_GLOO["layers"]
    for strategy in SEQ_GLOO["strategies"]:
        ranks = [r["runs"].get(strategy) if r else None for r in res]
        if ranks[0] is None:
            out["not_carried"][strategy] = {
                n: v for n, v in did.items() if v != "ran, right"
                and n in ("all_reduce", {"ring": "send_recv",
                                         "ulysses": "all_to_all_single"}[
                                             strategy])}
            continue
        rel = abs(ranks[0]["losses"][-1] - ref["losses"][-1]) \
            / abs(ref["losses"][-1])
        want = [layers * (r + 1) if strategy == "ring" else layers
                for r in range(2)]
        got = [rk["flash_launches_per_step"].get("flash_attention_fwd")
               for rk in ranks]
        out["runs"][strategy] = {
            "losses": [rk["losses"] for rk in ranks],
            "wall_s": [rk["wall_s"] for rk in ranks],
            "last_loss_rel_to_unsharded": rel,
            "flash_launches_per_step": [rk["flash_launches_per_step"]
                                        for rk in ranks],
            "flash_fwd_launches_expected": want}
        if not (rel <= SEQ_GLOO["rel"] and ranks[0]["losses"]
                == ranks[1]["losses"] and got == want):
            bad.append(strategy)
    emit(out)
    if bad:
        raise AssertionError(f"seq_gloo_card {bad}: {out}")
    return out


def _sgd_keras():
    from bigdl_tpu_torch.optim import SGD

    return SGD(learning_rate=KERAS["lr"], momentum=KERAS["momentum"])


def keras_inception(dev, data):
    """Inception-v1 through the keras surface: compile, fit (one epoch,
    validation), predict, evaluate, get_weights -> set_weights ->
    predict to the bit; the fit's losses equal a hand-built Optimizer's
    on the same Model from the same weights."""
    from bigdl_tpu_torch import keras
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.models import inception_v1
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (Optimizer, Top1Accuracy,
                                       Top5Accuracy, Trigger)

    (x, y), (xv, yv) = data
    b = KERAS["batch"]

    def build():
        inp = keras.Input(IMAGE)
        net = inception_v1(1000, dropout=KERAS["dropout"],
                           generator=torch.Generator().manual_seed(SEED))
        return keras.Model(inp, net(inp))

    model = build()
    events = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    model.compile(_sgd_keras(), "nll", ["top1", "top5"])
    t0 = time.perf_counter()
    trained = model.fit(x, y, batch_size=b, nb_epoch=1,
                        validation_data=(xv, yv), device=dev,
                        end_trigger=Trigger.or_(_step_clock(events),
                                                Trigger.max_epoch(1)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_losses = list(trained.losses)
    steps = len(fit_losses)
    step_ms = _step_ms(events, 0, steps)
    med = float(np.median(step_ms[1:]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pred = model.predict(xv, batch_size=b)
    evaluation = {r.name: r.result for r in model.evaluate(xv, yv,
                                                           batch_size=b)}
    weights = model.get_weights()
    model.set_weights(weights, device=dev)
    again = model.predict(xv, batch_size=b)
    del model, trained
    _release()

    ref = build()
    opt = (Optimizer(ref, DataSet.array(x, y), ClassNLLCriterion(),
                     batch_size=b, device=dev)
           .set_optim_method(_sgd_keras())
           .set_end_when(Trigger.max_epoch(1))
           .set_validation(Trigger.every_epoch(), DataSet.array(xv, yv),
                           [Top1Accuracy(), Top5Accuracy()], batch_size=b))
    opt.optimize()
    want = opt.losses
    del ref, opt
    _release()
    out = {"phase": "keras_inception", "model": "inception_v1",
           "classes": 1000, "batch": b, "images": len(x),
           "compute_dtype": "bfloat16", "losses": fit_losses,
           "optimizer_losses": want, "step_ms": step_ms,
           "median_step_ms": med, "images_per_s": b / med * 1e3,
           "wall_s": wall, "peak_mem_gb": peak, "evaluate": evaluation,
           "predict_shape": list(pred.shape),
           "predict_finite": bool(np.isfinite(pred).all()),
           "set_weights_predict_bit_equal": bool(np.array_equal(pred, again)),
           "weights_nodes": len(weights["params"])}
    emit(out)
    if fit_losses != want:
        raise AssertionError("keras fit's losses differ from the "
                             f"Optimizer's: {fit_losses} vs {want}")
    if not (out["predict_finite"] and out["set_weights_predict_bit_equal"]
            and pred.shape == (len(xv), 1000)
            and all(np.isfinite(v) for v in evaluation.values())
            and len(evaluation) == 2):
        raise AssertionError(f"keras_inception: {out}")
    return out


def keras_resnet(dev, data):
    """ResNet-50 (resnet_model()) through keras fit for a few steps of
    train_resnet's recipe; the losses equal to the Optimizer's on the
    bare module to the bit."""
    from bigdl_tpu_torch import keras
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    (x, y), _ = data
    n = KERAS["resnet_steps"]
    inp = keras.Input(IMAGE)
    model = keras.Model(inp, resnet_model()(inp))
    model.compile(_resnet_recipe(), CrossEntropyCriterion())
    events = {}
    got = model.fit(x, y, batch_size=RESNET_TRAIN["batch"], device=dev,
                    end_trigger=Trigger.or_(_step_clock(events),
                                            Trigger.max_iteration(n))).losses
    torch.cuda.synchronize()
    step_ms = _step_ms(events, 0, n)
    del model
    _release()
    opt = (Optimizer(resnet_model(), DataSet.array(x, y),
                     CrossEntropyCriterion(),
                     batch_size=RESNET_TRAIN["batch"], device=dev)
           .set_optim_method(_resnet_recipe())
           .set_end_when(Trigger.max_iteration(n)))
    opt.optimize()
    want = opt.losses
    del opt
    _release()
    out = {"phase": "keras_resnet", "steps": n, "losses": got,
           "optimizer_losses": want, "bit_equal": got == want,
           "step_ms": step_ms, "compute_dtype": "bfloat16"}
    emit(out)
    if got != want or len(got) != n:
        raise AssertionError(f"keras_resnet: {out}")
    return out


def _translation_data():
    """The reverse task: ``(src, tgt_in), tgt`` of seeded tokens in
    [3, vocab), the target the source reversed, teacher-forced after
    BOS."""
    c = TRANSLATION
    rs = np.random.RandomState(SEED + 3)
    n = c["batch"] * c["steps"]
    src = rs.randint(3, c["vocab"], (n, c["src"])).astype(np.int32)
    tgt = src[:, ::-1][:, :c["tgt"]].copy()
    tgt_in = np.concatenate([np.full((n, 1), c["bos"], np.int32),
                             tgt[:, :-1]], axis=1)
    return src, tgt_in, tgt


def _translation_model():
    from bigdl_tpu_torch.nn import Transformer

    c = TRANSLATION
    return Transformer(c["vocab"], c["d"], c["heads"], ffn_size=c["ffn"],
                       num_layers=c["layers"], dropout=0.0,
                       mode="translation", seed=SEED)


def _first_gap(model, src_row, tokens_u, tokens_c, dev):
    """The first step where the cached tokens leave the uncached ones,
    and the uncached logits' top-two gap there, against the tolerance."""
    t = int(np.nonzero(tokens_u != tokens_c)[0][0])
    c = TRANSLATION
    prefix = np.full((1, c["max_len"] + 1), c["bos"], np.int32)
    prefix[0, :t] = tokens_u[:t]
    with torch.no_grad():
        logits = model(torch.from_numpy(src_row[None]).to(dev),
                       torch.from_numpy(prefix).to(dev))[0, t - 1]
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    tol = DECODE_GAP_RTOL * max(1.0, float(logits.abs().max()))
    return {"step": t, "top2_gap": gap, "tolerance": tol,
            "within": gap <= tol}


def train_translation(dev):
    """The translation Transformer at Transformer-base width through the
    Optimizer at K = 1 and K = 4 (losses equal to the bit, finite and
    falling; 18 flash forward and 18 + 18 backward launches a step,
    credited at replay), a float32 gradient check of flash against plain
    attention, and the decoders: greedy and beam search over the whole
    prefix, the cached greedy decode held to the uncached one."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.nn import (CrossEntropyCriterion,
                                    transformer_decode,
                                    transformer_decode_cached)
    from bigdl_tpu_torch.optim import Adam, Optimizer
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    c = TRANSLATION
    src, tgt_in, tgt = _translation_data()
    with compute_dtype(torch.float32):
        model = _translation_model()
        grad = grad_check(model, (src[:c["batch"]], tgt_in[:c["batch"]]),
                          tgt[:c["batch"]], dev, phase="translation_gradcheck")
        del model
        _release()

    def make(end):
        return (Optimizer(_translation_model(),
                          DataSet.array((src, tgt_in), tgt),
                          CrossEntropyCriterion(), batch_size=c["batch"],
                          device=dev)
                .set_optim_method(Adam(learning_rate=c["lr"]))
                .set_end_when(end))

    runs = [_bundle_run(make, k, c["steps"]) for k in (1, BUNDLE["k"])]
    runs.append({**_bundle_run(make, BUNDLE["k"], c["steps"],
                               busy=_BusyWindow(BUNDLE["timed_from"],
                                                c["steps"])),
                 "run": "profiled"})
    tokens = c["batch"] * c["tgt"]
    for r in runs:
        r["target_tokens_per_s"] = tokens / r["step_ms"] * 1e3
        r["tokens_per_s"] = c["batch"] * (c["src"] + c["tgt"]) \
            / r["step_ms"] * 1e3
    ref = runs[0]["losses"]
    want = {n: float(3 * c["layers"]) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}

    # the decoders on 8 held-out sources, float32 products
    rs = np.random.RandomState(SEED + 4)
    srcd = torch.from_numpy(rs.randint(3, c["vocab"], (
        c["decode_sources"], c["src"])).astype(np.int32)).to(dev)
    decode = {}
    with compute_dtype(torch.float32):
        model = _translation_model().to(dev)
        for name, fn in (
                ("greedy", lambda: transformer_decode(
                    model, srcd, c["bos"], c["eos"], max_len=c["max_len"])),
                ("beam", lambda: transformer_decode(
                    model, srcd, c["bos"], c["eos"], max_len=c["max_len"],
                    beam_size=c["beam"])),
                ("cached", lambda: transformer_decode_cached(
                    model, srcd, c["bos"], c["eos"],
                    max_len=c["max_len"]))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens_, scores = fn()
            torch.cuda.synchronize()
            decode[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                            "tokens": tokens_.cpu().numpy(),
                            "finite": bool(torch.isfinite(scores).all())}
        tu, tc = decode["greedy"]["tokens"], decode["cached"]["tokens"]
        rows_equal = [bool(np.array_equal(a, b)) for a, b in zip(tu, tc)]
        gaps = [_first_gap(model, srcd[i].cpu().numpy(), tu[i], tc[i], dev)
                for i, eq in enumerate(rows_equal) if not eq]
        del model
        _release()
    out = {"phase": "train_translation", "config": TRANSLATION,
           "compute_dtype": "bfloat16",
           "runs": [{k: v for k, v in r.items()} for r in runs],
           "losses_k1": ref, "gradcheck": grad,
           "flash_launches_per_step": {
               f"k{r['k']}": {n: r["launches_per_step"].get(n)
                              for n in want} for r in runs[:2]},
           "decode": {
               "max_len": c["max_len"], "sources": c["decode_sources"],
               "beam_size": c["beam"],
               **{n: {"ms": d["ms"], "finite": d["finite"]}
                  for n, d in decode.items()},
               "beam_shape": list(decode["beam"]["tokens"].shape),
               "cached_rows_equal_uncached": sum(rows_equal),
               "first_differences": gaps}}
    emit(out)
    for r in runs:
        got = {n: r["launches_per_step"].get(n) for n in want}
        if got != want:
            raise AssertionError(f"flash launches a step at K = {r['k']}: "
                                 f"{got}, want {want}")
        if r["losses"] != ref[:len(r["losses"])]:
            raise AssertionError(f"K = {r['k']} losses differ from K = 1: "
                                 f"{r['losses']} vs {ref}")
    if not (np.all(np.isfinite(ref)) and ref[-1] < ref[0]):
        raise AssertionError(f"translation losses: {ref}")
    if not all(d["finite"] for d in decode.values()) or not all(
            g["within"] for g in gaps):
        raise AssertionError(f"translation decode: {out['decode']}")
    return out


def train_ptb_lstm(dev):
    """The PTB medium LM (char_rnn(10000, 650, 650, layers=2), 35 steps,
    batch 20, SGD 1.0, L2 clipping 5) through the Optimizer at K = 1 and
    K = 4: the losses equal to the bit; tokens/s, step ms, peak
    memory."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.models import char_rnn
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer

    c = PTB
    rs = np.random.RandomState(SEED + 5)
    ids = rs.randint(0, c["vocab"], (c["batch"] * c["steps"],
                                     c["steps_t"] + 1)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]

    def make(end):
        model = char_rnn(c["vocab"], c["embed"], c["hidden"],
                         layers=c["layers"],
                         generator=torch.Generator().manual_seed(SEED))
        return (Optimizer(model, DataSet.array(x, y),
                          TimeDistributedCriterion(ClassNLLCriterion()),
                          batch_size=c["batch"], device=dev)
                .set_optim_method(SGD(learning_rate=c["lr"]))
                .set_gradient_clipping_by_l2_norm(c["clip"])
                .set_end_when(end))

    runs = [_bundle_run(make, k, c["steps"]) for k in (1, BUNDLE["k"])]
    tokens = c["batch"] * c["steps_t"]
    for r in runs:
        r["tokens_per_s"] = tokens / r["step_ms"] * 1e3
    ref = runs[0]["losses"]
    out = {"phase": "train_ptb_lstm", "config": PTB,
           "compute_dtype": "bfloat16", "runs": runs, "losses_k1": ref,
           "bit_equal": runs[1]["losses"] == ref}
    emit(out)
    if not out["bit_equal"] or not np.all(np.isfinite(ref)):
        raise AssertionError(f"train_ptb_lstm: {out}")
    return out


class StockBert(torch.nn.Module):
    """A stock torch BERT-base classifier (``ESTIMATOR_BERT``): token
    embeddings, a ``torch.nn.TransformerEncoder``, the first token through
    a tanh pooler, a two-label head."""

    def __init__(self, c=None):
        super().__init__()
        c = c or ESTIMATOR_BERT
        self.emb = torch.nn.Embedding(c["vocab"], c["d"])
        self.enc = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(
                c["d"], c["heads"], c["ffn"], dropout=c["dropout"],
                activation="gelu", batch_first=True),
            c["layers"], enable_nested_tensor=False)
        self.pool = torch.nn.Linear(c["d"], c["d"])
        self.act = torch.nn.Tanh()
        self.cls = torch.nn.Linear(c["d"], c["labels"])

    def forward(self, ids):
        h = self.enc(self.emb(ids))
        return self.cls(self.act(self.pool(h[:, 0])))


@contextlib.contextmanager
def _clocked(module, busy=None, steps=None):
    """Patch ``module.Optimizer`` (the Optimizer an entry point builds
    inside) so that its end trigger also records a CUDA event at every
    bundle edge (and runs ``busy``, a ``_BusyWindow``, and ends the run
    at iteration ``steps``).  Yields ``(events, made)``: iteration ->
    event, and the Optimizers built."""
    from bigdl_tpu_torch.optim import Trigger

    events, made = {}, []

    def tick(state):
        it = state["iteration"]
        if it not in events:
            events[it] = torch.cuda.Event(enable_timing=True)
            events[it].record()
        return False

    real = module.Optimizer

    class Clocked(real):
        def set_end_when(self, trigger):
            made.append(self)
            ends = [Trigger(tick, "clock")] + ([busy] if busy else [])
            if steps is not None:
                ends.append(Trigger.max_iteration(steps))
            return super().set_end_when(Trigger.or_(*ends, trigger))

    module.Optimizer = Clocked
    try:
        yield events, made
    finally:
        module.Optimizer = real


def _clocked_fit(module, fit, rows, busy=None):
    """``fit()`` under ``_clocked(module)``: step ms (CUDA events, from
    iteration BUNDLE["timed_from"] to the last edge), rows/s, peak
    memory, the run's wall time, kernel launches a step (replays
    credited), losses and the graphs captured.  With ``busy`` the run
    ends where the profiled window does."""
    from bigdl_tpu_torch.ops import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _clocked(module, busy, busy and busy.stop) as (events, made):
        fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    opt = made[-1]
    edges = sorted(events)
    last = edges[-1]
    a = min(e for e in edges if e >= BUNDLE["timed_from"])
    step_ms = events[a].elapsed_time(events[last]) / (last - a)
    out = {"steps": last, "edges": edges, "step_ms": step_ms,
           "rows_per_s": rows / step_ms * 1e3, "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": {n: v / last for n, v in LAUNCHES.items()},
           "losses": list(opt.losses)}
    if busy is not None:
        out["busy"] = busy.out
    return out


def _bert_data():
    c = ESTIMATOR_BERT
    rs = np.random.RandomState(SEED + 6)
    ids = rs.randint(0, c["vocab"], (c["rows"], c["length"]))
    labels = rs.randint(0, c["labels"], c["rows"]).astype(np.int32)
    return ids, labels


def estimator_bert(dev):
    """A stock torch BERT-base fine-tuned through ``Estimator.from_torch``
    (the converter re-emits it as the port's keras Model, its attention on
    the flash kernels): conversion seconds; one epoch at K = 1, then at
    K = 4 and a profiled K = 4 run (step ms, sequences/s, peak memory,
    busy share, flash launches a step credited at replay: 12 forward,
    12 + 12 backward); the fit's losses equal to a hand-built Optimizer's
    on the same converted model with the mapped AdamWeightDecay, and
    K = 4's to K = 1's, to the bit; evaluate with Top1Accuracy and
    predict; the exported state_dict loaded into a fresh stock module
    (strict) and converted again predicts the Estimator's float32 answers
    to the bit; the stock module's own float32 forward within
    BERT_STOCK_ATOL of them (C.18: the tanh GELU); a float32 gradient
    check of flash against plain attention on every MultiHeadAttention."""
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.estimator import Estimator
    from bigdl_tpu_torch.estimator import estimator as est_mod
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import (AdamWeightDecay, Optimizer,
                                       Top1Accuracy)
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    c = ESTIMATOR_BERT
    ids, labels = _bert_data()
    ids32 = ids.astype(np.int32)
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    stock = StockBert()
    build_s = time.perf_counter() - t0

    def make_est():
        return Estimator.from_torch(
            lambda cfg: stock,
            lambda m, cfg: torch.optim.AdamW(m.parameters(), lr=c["lr"]),
            lambda cfg: torch.nn.CrossEntropyLoss(),
            example_input=ids[:1], device=dev)

    t0 = time.perf_counter()
    est = make_est()
    convert_s = time.perf_counter() - t0
    steps = c["rows"] // c["batch"]
    want = {n: float(c["layers"]) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}

    def fit(k, busy=None):
        est.config["steps_per_call"] = k
        r = _clocked_fit(est_mod, lambda: est.fit((ids32, labels), epochs=1,
                                                 batch_size=c["batch"]),
                         c["batch"], busy)
        r["k"] = k
        r["graphs_captured"] = est._trained._step.graphs_captured
        r["sequences_per_s"] = r.pop("rows_per_s")
        return r

    runs = [fit(1)]
    ref = runs[0]["losses"]
    # the trained K = 1 model: evaluate, predict, the state-dict round trip
    top1 = est.evaluate((ids32[:256], labels[:256]), [Top1Accuracy()],
                        batch_size=c["batch"])
    pred = est.predict(ids32[:c["check_rows"]])
    n = c["check_rows"]
    with compute_dtype(torch.float32):
        pred32 = est.predict(ids32[:n])
        sd = est.state_dict()
        torch.manual_seed(SEED + 1)
        fresh = StockBert()
        fresh.load_state_dict(sd, strict=True)
        again = Estimator.from_torch(
            lambda cfg: fresh, lambda cfg: AdamWeightDecay(),
            lambda cfg: CrossEntropyCriterion(), example_input=ids[:1],
            device=dev)
        pred_again = again.predict(ids32[:n])
        del again
        _release()
        with torch.no_grad():
            stock_out = fresh.eval()(torch.from_numpy(ids[:n])).numpy()
    xs = np.linspace(-8, 8, 200001, dtype=np.float64)
    gelu_gap = float(np.max(np.abs(
        torch.nn.functional.gelu(torch.from_numpy(xs)).numpy()
        - torch.nn.functional.gelu(torch.from_numpy(xs),
                                   approximate="tanh").numpy())))
    stock_err = float(np.abs(stock_out - pred32).max())
    del fresh, sd
    _release()

    # the same converted model through a hand-built Optimizer
    def make(end):
        return (Optimizer(est.model, DataSet.array(ids32, labels),
                          CrossEntropyCriterion(), batch_size=c["batch"],
                          device=dev)
                .set_optim_method(AdamWeightDecay(learning_rate=c["lr"],
                                                  weight_decay=0.01))
                .set_initial_variables(est._initial_variables)
                .set_end_when(end))

    hand = _bundle_run(make, 1, steps)
    runs.append(fit(BUNDLE["k"]))
    runs.append({**fit(BUNDLE["k"], _BusyWindow(
        BUNDLE["timed_from"], BUNDLE["timed_from"] + BUNDLE["k"])),
        "run": "profiled"})
    # a float32 gradient check of the converted model (the same dropout
    # masks through both attentions)
    from bigdl_tpu_torch.utils import prng

    with compute_dtype(torch.float32):
        grad = grad_check(est.model, ids32[:n], labels[:n], dev,
                          phase="estimator_bert_gradcheck",
                          key=prng.PRNGKey(SEED + 7, device=dev))
    out = {"phase": "estimator_bert", "config": ESTIMATOR_BERT,
           "compute_dtype": "bfloat16",
           "cuts": ["no position or token-type embeddings",
                    "random ids and labels", f"{steps} steps"],
           "stock_build_s": build_s, "conversion_s": convert_s,
           "optim_method": type(est.optim_method).__name__,
           "criterion": type(est.criterion).__name__,
           "runs": runs, "losses_k1": ref,
           "hand_built_losses_equal": hand["losses"] == ref,
           "hand_built_step_ms": hand["step_ms"],
           "flash_launches_per_step": {
               f"k{r['k']}": {k: r["launches_per_step"].get(k)
                              for k in want} for r in runs[:2]},
           "top1_256_rows": top1, "predict_shape": list(pred.shape),
           "predict_finite": bool(np.isfinite(pred).all()),
           "state_dict_round_trip_bit_equal": bool(
               np.array_equal(pred_again, pred32)),
           "gelu_erf_tanh_max_gap": gelu_gap,
           "stock_forward_max_abs_err": stock_err,
           "stock_forward_atol": BERT_STOCK_ATOL, "gradcheck": grad}
    emit(out)
    for r in runs:
        got = {k: r["launches_per_step"].get(k) for k in want}
        if got != want:
            raise AssertionError(f"flash launches a step at K = {r['k']}: "
                                 f"{got}, want {want}")
        # the profiled run stops at the end of its window
        if r["losses"] != ref[:len(r["losses"])]:
            raise AssertionError(f"K = {r['k']} losses differ from K = 1")
    if not out["hand_built_losses_equal"]:
        raise AssertionError(f"Estimator losses {ref} differ from the "
                             f"hand-built Optimizer's {hand['losses']}")
    if not (np.all(np.isfinite(ref)) and out["predict_finite"]
            and out["predict_shape"] == [n, c["labels"]]):
        raise AssertionError(f"estimator_bert outputs: {out}")
    if not out["state_dict_round_trip_bit_equal"]:
        raise AssertionError("the state_dict round trip changed predict")
    if gelu_gap > GELU_GAP_MAX or stock_err > BERT_STOCK_ATOL:
        raise AssertionError(f"the stock forward is {stock_err} from "
                             f"predict (bound {BERT_STOCK_ATOL})")
    out["lora_flash_launches_per_step"] = lora_bert(dev, est, ids32, labels)
    del est
    _release()
    return out


def lora_bert(dev, est, ids32, labels):
    """Inside estimator_bert, on its fine-tuned converted BERT-base:
    ``apply_lora`` on every Linear node, LORA["rows"] / batch steps
    through an Estimator with ``lora_filter`` as the Optimizer's
    trainable mask (AdamWeightDecay); the base parameters bit-unchanged
    and the adapters moved, flash launches a step (12 forward, 12 + 12
    backward), and ``merge_lora``'s float32 forward within
    LORA["merge_atol"] of the unmerged one."""
    from bigdl_tpu_torch.estimator import Estimator
    from bigdl_tpu_torch.estimator import estimator as est_mod
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.lora import (LoRALinear, apply_lora,
                                         lora_filter, merge_lora)
    from bigdl_tpu_torch.optim import AdamWeightDecay
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    c, bc = LORA, ESTIMATOR_BERT
    lm = apply_lora(est.model, rank=c["rank"], alpha=c["alpha"],
                    generator=torch.Generator().manual_seed(SEED + 8))
    lm = lm.to(dev)
    wrapped = sum(isinstance(n.layer, LoRALinear) for n in lm.order
                  if n.layer is not None)
    mask = lora_filter(lm)
    named = dict(lm.named_parameters())
    base = {k: p.detach().clone() for k, p in named.items()
            if k.split(".")[-1] not in ("lora_a", "lora_b")}
    adapters = {k: p.detach().clone() for k, p in named.items()
                if k.split(".")[-1] in ("lora_a", "lora_b")}
    trainable = sum(p.numel() for p in adapters.values())
    lest = Estimator.from_module(
        lambda cfg: lm,
        lambda cfg: AdamWeightDecay(learning_rate=c["lr"],
                                    weight_decay=0.01),
        lambda cfg: CrossEntropyCriterion(), device=dev)
    real = est_mod.Optimizer

    class Masked(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.trainable_mask = mask

    est_mod.Optimizer = Masked
    try:
        run = _clocked_fit(est_mod, lambda: lest.fit(
            (ids32[:c["rows"]], labels[:c["rows"]]), epochs=1,
            batch_size=bc["batch"]), bc["batch"])
    finally:
        est_mod.Optimizer = real
    named = dict(lm.named_parameters())
    base_equal = all(torch.equal(named[k], v) for k, v in base.items())
    moved = sum(not torch.equal(named[k], v) for k, v in adapters.items())
    n = bc["check_rows"]
    x = torch.as_tensor(ids32[:n]).to(dev)
    merged = merge_lora(lm)
    lm.eval()
    merged.eval()
    with compute_dtype(torch.float32), torch.no_grad():
        a = lm(x).float().cpu().numpy()
        b = merged(x).float().cpu().numpy()
    want = {k: float(bc["layers"]) for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")}
    flash = {k: run["launches_per_step"].get(k) for k in want}
    out = {"phase": "lora_bert", "config": c, "wrapped_linear_nodes":
           wrapped, "trainable_params": trainable,
           "base_params": int(sum(v.numel() for v in base.values())),
           "steps": run["steps"], "step_ms": run["step_ms"],
           "sequences_per_s": run["rows_per_s"], "losses": run["losses"],
           "peak_mem_gb": run["peak_mem_gb"],
           "flash_launches_per_step": flash,
           "base_bit_unchanged": base_equal,
           "adapters_moved": f"{moved}/{len(adapters)}",
           "merge_max_abs_diff": float(np.abs(a - b).max()),
           "merge_atol": c["merge_atol"]}
    emit(out)
    if flash != want:
        raise AssertionError(f"lora_bert: flash launches a step {flash}, "
                             f"want {want}")
    if not (base_equal and moved == len(adapters) and wrapped > 0
            and np.all(np.isfinite(run["losses"]))):
        raise AssertionError(f"lora_bert: {out}")
    if out["merge_max_abs_diff"] > c["merge_atol"]:
        raise AssertionError(f"lora_bert: merged forward "
                             f"{out['merge_max_abs_diff']} from the "
                             f"unmerged one")
    del lest, lm, merged
    _release()
    return flash


def forecast_data():
    """``FORECAST["windows"]`` windows of seeded synthetic hourly series
    of ``FORECAST["variables"]`` variables: a daily and a weekly period
    of random phase and amplitude per variable, plus noise."""
    c = FORECAST
    rs = np.random.RandomState(SEED + 8)
    n = c["windows"] + c["lookback"] + c["horizon"] - 1
    t = np.arange(n, dtype=np.float64)[:, None]
    v = c["variables"]
    series = (rs.uniform(0.5, 1.5, (1, v))
              * np.sin(2 * np.pi * t / 24 + rs.rand(1, v) * 6.28)
              + rs.uniform(0.2, 0.8, (1, v))
              * np.sin(2 * np.pi * t / 168 + rs.rand(1, v) * 6.28)
              + 0.1 * rs.randn(n, v)).astype(np.float32)
    idx = np.arange(c["windows"])[:, None]
    x = series[idx + np.arange(c["lookback"])]
    y = series[idx + c["lookback"] + np.arange(c["horizon"])]
    return x, y


def _forecast_phase(dev, name, make, data):
    """One forecaster on ``data``: a timed epoch, then a profiled one
    from the first's weights (busy share); ``evaluate``; save, load into
    a new forecaster, ``predict`` to the bit; the float32 forward on the
    card against the port's CPU forward of the same weights, with the
    delays each picked (the Autoformer's)."""
    import copy

    from bigdl_tpu_torch.forecast import autoformer
    from bigdl_tpu_torch.forecast import forecaster as fc_mod
    from bigdl_tpu_torch.tensor.policy import compute_dtype

    c = FORECAST
    x, y = data
    f = make()
    run = _clocked_fit(fc_mod, lambda: f.fit((x, y), epochs=1,
                                             batch_size=c["batch"]),
                       c["batch"])
    run["windows_per_s"] = run.pop("rows_per_s")
    losses = run["losses"]
    evaluation = f.evaluate((x[:256], y[:256]), ("mse", "mae"))
    n = c["check_windows"]
    pred = f.predict(x[:n])
    with tempfile.TemporaryDirectory(prefix=f"{name}_") as d:
        f.save(d)
        saved_bytes = _dir_bytes(d)
        g = make()
        g.load(d)
        loaded = g.predict(x[:n])
        del g
    picked = []
    real = autoformer.top_delays

    def record(mean_corr, top_k):
        vals, idx = real(mean_corr, top_k)
        picked.append(idx.cpu().numpy().tolist())
        return vals, idx

    autoformer.top_delays = record
    try:
        with compute_dtype(torch.float32), torch.no_grad():
            f.model.eval()
            on_card = f.model(torch.from_numpy(x[:n]).to(dev)).cpu()
            n_card = len(picked)
            on_cpu = copy.deepcopy(f.model).cpu()(torch.from_numpy(x[:n]))
    finally:
        autoformer.top_delays = real
    scale = max(1.0, float(on_cpu.abs().max()))
    err = float((on_card - on_cpu).abs().max())
    # a profiled run of 4 more steps for the busy share (the weights go
    # on training; the profiler costs each of the eager step's thousands
    # of launches)
    busy = _BusyWindow(BUNDLE["timed_from"], BUNDLE["timed_from"] + 4)
    prof = _clocked_fit(fc_mod, lambda: f.fit((x, y), epochs=1,
                                              batch_size=c["batch"]),
                        c["batch"], busy)
    prof["windows_per_s"] = prof.pop("rows_per_s")
    out = {"phase": name, "data": FORECAST, "compute_dtype": "bfloat16",
           "config": {k: str(v) if k == "device" else v
                      for k, v in f._init_args.items()
                      if k not in ("optimizer", "loss")},
           "params": sum(p.numel() for p in f.model.parameters()),
           "runs": [run, {**prof, "run": "profiled"}],
           "evaluate_256": evaluation, "predict_shape": list(pred.shape),
           "save_load_bit_equal": bool(np.array_equal(pred, loaded)),
           "saved_bytes": saved_bytes,
           "float32_card_vs_cpu_max_abs_err": err,
           "float32_tolerance": FORECAST_ATOL * scale,
           "delays_card": picked[:n_card] or None,
           "delays_cpu": picked[n_card:] or None}
    emit(out)
    k = max(1, len(losses) // 4)
    if not (np.all(np.isfinite(losses))
            and np.mean(losses[-k:]) < np.mean(losses[:k])):
        raise AssertionError(f"{name} losses not finite and falling: "
                             f"{losses}")
    if not out["save_load_bit_equal"]:
        raise AssertionError(f"{name}: load changed predict")
    if picked[:n_card] != picked[n_card:] or err > FORECAST_ATOL * scale:
        raise AssertionError(f"{name}: the card's float32 forward is {err} "
                             f"from the CPU's (delays {out['delays_card']}"
                             f" vs {out['delays_cpu']})")
    del f
    _release()
    return out


def forecast_autoformer(dev, data):
    from bigdl_tpu_torch.forecast import AutoformerForecaster

    c = FORECAST
    kw = dict(AUTOFORMER)
    lr = kw.pop("lr")
    return _forecast_phase(dev, "forecast_autoformer", lambda:
                           AutoformerForecaster(
                               c["lookback"], c["horizon"], c["variables"],
                               c["variables"], lr=lr, seed=SEED,
                               device=dev, **kw), data)


def forecast_tcn(dev, data):
    from bigdl_tpu_torch.forecast import TCNForecaster

    c = FORECAST
    kw = dict(TCN_CFG)
    lr = kw.pop("lr")
    return _forecast_phase(dev, "forecast_tcn", lambda: TCNForecaster(
        c["lookback"], c["horizon"], c["variables"], c["variables"], lr=lr,
        seed=SEED, device=dev, **kw), data)


def run_alone(phase, dev):
    """One of the sequence and keras phases by itself
    (``python3 chip_smoke.py --phase NAME [NAME ...]``)."""
    if phase in ("keras_inception", "keras_resnet"):
        torch.backends.cudnn.deterministic = True
        try:
            globals()[phase](dev, resnet_train_data())
        finally:
            torch.backends.cudnn.deterministic = False
    elif phase in ("train_translation", "train_ptb_lstm", "estimator_bert"):
        globals()[phase](dev)
    elif phase in ("forecast_autoformer", "forecast_tcn"):
        globals()[phase](dev, forecast_data())
    elif phase == "train_zero1_collectives":
        _zero1_collectives(dev)
    elif phase == "layout_lm":
        layout_lm(dev)
    elif phase in ("layout_decode", "layout_int8_predict"):
        from bigdl_tpu_torch.tensor.policy import compute_dtype

        with compute_dtype(torch.float32), _nccl_world1():
            globals()[phase](dev)
    elif phase == "qat_lenet":
        qat_lenet(dev, train_lenet(dev)[1])
    elif phase == "layout_gloo_card":
        layout_gloo_card(dev)
    elif phase == "serve_keras_int8":
        from bigdl_tpu_torch.tensor.policy import compute_dtype

        with compute_dtype(torch.float32):
            serve_keras_int8(dev)
    elif phase in ("serve_prefix", "serve_handoff", "serve_spec_window",
                   "serve_seq2seq", "serve_pool"):
        globals()[phase](dev)
    elif phase == "serve_http":
        from bigdl_tpu_torch.tensor.policy import compute_dtype

        with compute_dtype(torch.float32):
            serve_http(dev)
    elif phase in ("train", "train_lm_bundles", "ring_fold",
                   "seq_gloo_card"):
        globals()[phase](dev)
    elif phase == "train_zero1_overlap":
        _zero1_overlap(_bundle_run(_lm_bundle_maker(dev), BUNDLE["k"],
                                   BUNDLE["steps"])["losses"])
    else:
        raise SystemExit(f"--phase {phase}: keras_inception, keras_resnet, "
                         "train_translation, train_ptb_lstm, estimator_bert, "
                         "forecast_autoformer, forecast_tcn, "
                         "train_zero1_collectives, layout_lm, "
                         "layout_decode, layout_int8_predict, qat_lenet, "
                         "layout_gloo_card, serve_keras_int8, serve_prefix, "
                         "serve_handoff, serve_spec_window, serve_seq2seq, "
                         "serve_http, serve_pool, train, train_lm_bundles, "
                         "train_zero1_overlap, ring_fold or seq_gloo_card")
    _release()


def main() -> int:
    # the port first: in a directory without it this fails before any
    # result is printed
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.common import resolve_device
    from bigdl_tpu_torch.tensor.policy import (apply_precision_policy,
                                               compute_dtype,
                                               get_compute_dtype)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device()
    apply_precision_policy()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "compute_dtype": str(get_compute_dtype(dev))})
    if sys.argv[1:] == ["--feed-ab"]:
        torch.backends.cudnn.deterministic = True
        feed_ab(dev)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--zero1"]:
        _build.build_all()
        train_zero1(dev)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:2] == ["--phase"]:
        _build.build_all()
        for phase in sys.argv[2:]:
            run_alone(phase, dev)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:] == ["--serve-spec"]:
        _build.build_all()
        _, prompts, results, tps = serve(dev)
        torch.cuda.empty_cache()
        _, pair = serve_spec(dev, prompts, results, tps)
        for im in pair.values():
            im.stop()
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
    sparse_bf16_row = check_block_sparse_bf16(dev, flush)
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
    spec_launches, spec_pair = serve_spec(dev, prompts, results, tps)
    verify_row["launches"] = spec_launches["graphs"].get(
        verify_row["name"], 0)
    sparse_bf16_row["launches"] = spec_launches["graphs"].get(
        sparse_bf16_row["name"], 0)
    # in bfloat16 products the float32 instance runs the draft of the
    # float32 engine (and every dx of a bfloat16 product's backward)
    sparse_row["launches"] = spec_launches["graphs_f32"].get(
        sparse_row["name"], 0)
    sparse_row["launches_path"] = "serve_spec graphs_f32"
    try:
        serve_sweep(dev, spec_pair)
        launches = serve_spec_window(dev, spec_pair["graphs"])
        for row in (verify_row, sparse_bf16_row):
            row["launches_serve_spec_window"] = launches.get(row["name"], 0)
    finally:
        for im in spec_pair.values():
            im.stop()
    del spec_pair
    _release()
    launches = serve_int8(dev, prompts, results)
    int8_row["launches"] = launches["plain"].get(int8_row["name"], 0)
    int8_row["launches_spec"] = launches["spec"].get(int8_row["name"], 0)
    _release()
    for phase in (serve_prefix, serve_handoff, serve_seq2seq):
        launches = phase(dev)
        for row in (decode_row, int8_row):
            row[f"launches_{phase.__name__}"] = launches.get(row["name"], 0)
        _release()
    launches = serve_resnet(dev, resnet)
    int8mm_row["launches"] = launches.get(int8mm_row["name"], 0)
    with compute_dtype(torch.float32):   # the fold's check is float32
        resnet_fused(dev, resnet)
    del resnet
    torch.cuda.empty_cache()
    # its answers held to the unfused plain model in float32 products;
    # the bfloat16 throughput beside the float32 one inside
    with compute_dtype(torch.float32):
        launches = serve_bert_fused(dev, bert_model())
    ln_row["launches"] = launches.get(ln_row["name"], 0)
    fwd_nc_row["launches"] = launches.get(fwd_nc_row["name"], 0)
    _release()
    with compute_dtype(torch.float32):   # int8 against the float model
        launches = serve_keras_int8(dev)
    for row in (int8mm_row, ln_row, fwd_nc_row):
        row["launches_serve_keras_int8"] = launches.get(row["name"], 0)
    _release()
    with compute_dtype(torch.float32):   # open for the server's lifetime
        launches = serve_http(dev)
    for row in (decode_row, int8mm_row, fwd_nc_row, ln_row):
        row["launches_serve_http"] = launches.get(row["name"], 0)
    _release()
    serve_pool(dev)
    _release()
    launches, trained = train(dev)
    fwd_row["launches"] = launches.get("flash_attention_fwd", 0)
    bwd_entries = {k: launches.get(k, 0) for k in (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")}
    # one backward call launches both entry points
    bwd_row["launches"] = min(bwd_entries.values())
    bwd_row["launches_by_entry"] = bwd_entries
    with compute_dtype(torch.float32):   # flash against plain attention
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
    ring = ring_fold(dev)
    fwd_row["launches_ring_fold"] = ring["flash_attention_fwd"]
    bwd_row["launches_ring_fold"] = ring["flash_attention_bwd"]
    _, lenet = train_lenet(dev)
    int8mm_row["launches_qat_lenet"] = qat_lenet(dev, lenet)
    del lenet
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
        keras_inception(dev, data)
        keras_resnet(dev, data)
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
    translation = train_translation(dev)
    for row, kernel in ((fwd_row, "flash_attention_fwd"),
                        (bwd_row, "flash_attention_bwd_dq")):
        row["launches_train_translation_per_step"] = translation[
            "flash_launches_per_step"][f"k{BUNDLE['k']}"][kernel]
    _release()
    train_ptb_lstm(dev)
    _release()
    bert = estimator_bert(dev)
    # the encoder's attention is the non-causal instance
    for row, kernel in ((fwd_nc_row, "flash_attention_fwd"),
                        (bwd_row, "flash_attention_bwd_dq")):
        row["launches_estimator_bert_per_step"] = bert[
            "flash_launches_per_step"][f"k{BUNDLE['k']}"][kernel]
        row["launches_lora_bert_per_step"] = bert[
            "lora_flash_launches_per_step"][kernel]
    _release()
    data = forecast_data()
    forecast_autoformer(dev, data)
    forecast_tcn(dev, data)
    del data
    _release()
    train_zero1(dev, lm_bundles["losses_k1"])
    layout = layout_lm(dev)
    for row, kernel in ((fwd_row, "flash_attention_fwd"),
                        (bwd_row, "flash_attention_bwd_dq")):
        row["launches_layout_lm_per_step"] = layout["runs"]["dp"][
            "flash_launches_per_step"][kernel]
    got = layout["decode_launches"]
    decode_row["launches_layout_decode"] = got["paged_decode_attention"]
    decode_row["launches_layout_decode_int8_weights"] = got[
        "paged_decode_attention_int8_weights"]
    verify_row["launches_layout_decode_spec"] = got["paged_verify_attention"]
    sparse_row["launches_layout_decode_spec"] = got["block_sparse_matmul"]
    int8mm_row["launches_layout_int8_predict"] = layout[
        "int8_predict_launches"]
    layout_gloo_card(dev)
    _release()
    seq = seq_gloo_card(dev)
    for strategy, run in seq["runs"].items():
        fwd_row[f"launches_seq_gloo_card_{strategy}_per_step"] = [
            r.get("flash_attention_fwd")
            for r in run["flash_launches_per_step"]]
        bwd_row[f"launches_seq_gloo_card_{strategy}_per_step"] = [
            r.get("flash_attention_bwd_dq")
            for r in run["flash_launches_per_step"]]
    _release()
    emit({"kernels": [decode_row, int8_row, fwd_row, fwd_nc_row, bwd_row,
                      verify_row, int8mm_row, sparse_row, sparse_bf16_row,
                      ln_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
