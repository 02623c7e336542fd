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
   dx too), and timed beside its bound, the plain version and one
   PyTorch library call;
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
8. gradcheck — one batch's gradients of every parameter of the same LM
   with the flash kernels against plain attention (``use_flash=False``);
9. train  — the LM trained 10 steps (batch 8 x 1024 tokens, Adam 1e-4)
   through ``Optimizer.optimize()``: falling finite losses, step time,
   tokens/s, peak memory, and launch counts showing every attention
   layer's forward and backward went through the flash kernels;
10. train_profile — two more steps under torch.profiler;
11. train_plain_attention — four more steps with ``BIGDL_TPU_FLASH=0``,
   the switch that sends the auto path to plain attention: the A/B of
   the flash kernels end to end, and proof that the switch holds.

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
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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
    ref = paged_decode_attention_ref(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
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
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "bigdl_tpu_torch/ops/csrc/paged_decode_attention.cu",
           "replaces": "bigdl_tpu/ops/flash_attention.py:365",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, **_bound(kv_bytes + io_bytes, flops),
           "library_ms": library_ms}
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
    ref = paged_decode_attention_ref(q, kp, vp, pt, ln, **sc)
    torch.cuda.synchronize()
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
    row = {"name": "paged_decode_attention_int8", "route": "cuda",
           "source": "bigdl_tpu_torch/ops/csrc/paged_decode_attention.cu",
           "replaces": "bigdl_tpu/ops/flash_attention.py:213",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, **_bound(kv_bytes + io_bytes, flops),
           "library_ms": library_ms}
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
        ref = paged_verify_attention_ref(q, kp, vp, pt, pos, **sc)
        torch.cuda.synchronize()
        tag = "int8" if int8 else "f32"
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
        rows[tag] = {"name": "paged_verify_attention", "route": "cuda",
                     "source": "bigdl_tpu_torch/ops/csrc/"
                               "paged_verify_attention.cu",
                     "replaces": "bigdl_tpu/ops/flash_attention.py:514",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms,
                     **_bound(kv_bytes + io_bytes, flops),
                     "library_ms": library_ms}
        emit({"phase": "kernel", "shape": {"slots": S, "heads": h,
                                           "chunk": C, "head_dim": d,
                                           "page": page, "n_blocks": nb,
                                           "pages_dtype": tag},
              "keys": keys, "bytes": kv_bytes + io_bytes, "flops": flops,
              "rtol": RTOL, "atol": ATOL, **rows[tag]})
    row = dict(rows["f32"])
    row["int8_pages"] = {k: rows["int8"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    return row


def check_block_sparse(dev, flush):
    """Kernel 5: the block-sparse product at the draft FFN's shapes —
    M = 16 (a decode step of 16 slots) and 256 (a prefill call of 4 x 64
    tokens), K/N = 768/3072 (l1) and 3072/768 (l2), blocks (8, 8) and
    (64, 64), half of the blocks kept — and its dx at M = 256, against
    the plain version; the yardstick is ``torch.matmul`` of the masked
    weight.  The row reports the draft step's l1 at (8, 8)."""
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
                ref = block_sparse_matmul_ref(x, w, plan)
                torch.cuda.synchronize()
                shape = {"m": m, "k": k, "n": n, "block": list(blk),
                         "density": float(mask.mean())}
                err = _assert_close(f"block_sparse_matmul {shape}", out,
                                    ref, RTOL, BS_ATOL)
                worst = max(worst, err)
                r = {"shape": shape, "max_abs_err": err,
                     "ms": time_cold(lambda: _bs_raw(x, w, plan), flush),
                     "plain_ms": time_cold(
                         lambda: block_sparse_matmul_ref(x, w, plan), flush),
                     "library_ms": time_cold(lambda: torch.matmul(x, wm),
                                             flush),
                     **_bound(4 * (m * k + kept + m * n), 2 * m * kept)}
                if m == 256:
                    # dx = g @ (w masked)^T: the kernel on the transposed
                    # plan
                    go = torch.randn(m, n, generator=g).to(dev)
                    wt, tplan = w.t().contiguous(), plan.transposed()
                    dx = _bs_raw(go, wt, tplan)
                    dref = block_sparse_matmul_ref(go, wt, tplan)
                    torch.cuda.synchronize()
                    derr = _assert_close(f"block_sparse_matmul dx {shape}",
                                         dx, dref, RTOL, BS_ATOL)
                    worst = max(worst, derr)
                    wmt = wm.t()
                    r["dx"] = {
                        "max_abs_err": derr,
                        "ms": time_cold(lambda: _bs_raw(go, wt, tplan),
                                        flush),
                        "plain_ms": time_cold(lambda: block_sparse_matmul_ref(
                            go, wt, tplan), flush),
                        "library_ms": time_cold(
                            lambda: torch.matmul(go, wmt), flush),
                        **_bound(4 * (m * n + kept + m * k), 2 * m * kept)}
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
            "shape": main["shape"],
            "m256": {k: rows[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "dx")}}


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
    head_dim 64, causal) and at ragged shapes with sq != skv, then timed
    at the training shape."""
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
        ro, rl = flash_attention_fwd_ref(q, k, v, causal=causal,
                                         sm_scale=d ** -0.5)
        rgrads = flash_attention_bwd_ref(q, k, v, ro, rl, go, causal=causal,
                                         sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        tag = f"({b}, {h}, {sq}, {skv}, causal={causal})"
        errs["fwd"] = max(errs["fwd"],
                          _assert_close(f"flash fwd out {tag}", out, ro,
                                        RTOL, ATOL),
                          _assert_close(f"flash fwd lse {tag}", lse, rl,
                                        RTOL, ATOL))
        for name, a, w in zip(("dq", "dk", "dv"), grads, rgrads):
            errs["bwd"] = max(errs["bwd"], _assert_close(
                f"flash bwd {name} {tag}", a, w, RTOL, BWD_ATOL))
        del q, k, v, go, out, lse, grads, ro, rl, rgrads

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
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "bigdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
         "replaces": "bigdl_tpu/ops/flash_attention.py:109",
         "launches": None, "max_abs_err": errs["fwd"], "ms": fwd_ms,
         "plain_ms": fwd_plain, **_bound(fwd_bytes, fwd_flops),
         "library_ms": fwd_lib},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "bigdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/ops/flash_attention.py:141",
         "launches": None, "max_abs_err": errs["bwd"], "ms": bwd_ms,
         "plain_ms": bwd_plain, **_bound(bwd_bytes, bwd_flops),
         "library_ms": fb_lib - fwd_lib}]
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


def _profile(fn) -> dict:
    """``fn()`` under torch.profiler: the device's busy share of the wall
    time and its time by kernel."""
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
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_kernels": len(kernels),
            "top": [{"kernel": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}


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

    def step_clock(state):
        # a CUDA event at each iteration edge the training loop reaches: step i
        # is the device time between edges i-1 and i (no host sync)
        it = state["iteration"]
        if it not in events:
            events[it] = torch.cuda.Event(enable_timing=True)
            events[it].record()
        return False

    steps = TRAIN["steps"]
    opt = (Optimizer(model, DataSet.array(ids, tgt), CrossEntropyCriterion(),
                     batch_size=TRAIN["batch"], device=dev)
           .set_optim_method(Adam(learning_rate=TRAIN["lr"]))
           .set_end_when(Trigger.or_(Trigger(step_clock, "step clock"),
                                     Trigger.max_iteration(steps))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    losses = opt.losses
    step_ms = [events[i - 1].elapsed_time(events[i])
               for i in range(1, steps + 1)]
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
        run(4, Trigger.or_(Trigger(step_clock, "step clock"),
                           Trigger.max_iteration(4)))
        torch.cuda.synchronize()
        plain_launches = dict(LAUNCHES)
    finally:
        del os.environ["BIGDL_TPU_FLASH"]
    plain_ms = [events[i - 1].elapsed_time(events[i]) for i in range(1, 5)]
    emit({"phase": "train_plain_attention", "flash_env": "0",
          "step_ms": plain_ms,
          "median_step_ms": float(np.median(plain_ms[1:])),
          "flash_median_step_ms": med, "launches": plain_launches})
    if any(plain_launches.values()):
        raise AssertionError(f"BIGDL_TPU_FLASH=0 still launched "
                             f"{plain_launches}")
    return launches


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
    decode_row = check_paged_decode(dev, flush)
    int8_row = check_paged_decode_int8(dev, flush)
    verify_row = check_paged_verify(dev, flush)
    sparse_row = check_block_sparse(dev, flush)
    fwd_row, bwd_row = check_flash(dev, flush)
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
    launches = train(dev)
    fwd_row["launches"] = launches.get("flash_attention_fwd", 0)
    bwd_entries = {k: launches.get(k, 0) for k in (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")}
    # one backward call launches both entry points
    bwd_row["launches"] = min(bwd_entries.values())
    bwd_row["launches_by_entry"] = bwd_entries
    emit({"kernels": [decode_row, int8_row, fwd_row, bwd_row, verify_row,
                      sparse_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
