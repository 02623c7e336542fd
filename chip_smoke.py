#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``bigdl_tpu``.  Phases, each printing
one JSON line:

1. device — the card, with its name and power limit from nvidia-smi;
2. build  — every kernel under ``bigdl_tpu_torch/ops/csrc/`` built
   from source with nvcc (into ``build/``);
3. kernel — each kernel held against its plain PyTorch version at the
   shapes the serving path gives it, and timed beside its bound, the
   plain version and one PyTorch library call;
4. serve  — the GPT-2-small-class LM (12 layers, d=768, 12 heads, FFN
   3072, vocab 32768; random weights from seed 0) answers 16 greedy
   requests through ``InferenceModel.generate``; the launch counts show
   the decode steps went through the kernels, and every generated token
   is checked against a full (uncached) forward of the same model;
5. profile — the same requests again under torch.profiler: the device's
   busy share of the wall time and its time by kernel.

Then the kernel table, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero; without a CUDA card it exits non-zero and prints
no result."""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# serving geometry of the main path
LM = dict(vocab_size=32768, hidden_size=768, num_heads=12, ffn_size=3072,
          num_layers=12)
DECODE = dict(slots=16, page_size=16, pages_per_slot=64, prompt_chunk=64,
              prefill_batch=4, max_new_tokens=32)
N_REQUESTS = 16
PROMPT_LENS = (16, 512)
SEED = 0

# kernel check tolerance: f32 sums taken in another order over up to
# 1024 keys
RTOL, ATOL = 1e-4, 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cold(fn, flush, reps=50) -> float:
    """Median device time of one call (ms), the L2 cache flushed before
    each call, as a decode step finds it after the other layers ran."""
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


def check_paged_decode(dev, flush):
    """The paged decode kernel against its plain version at the serving
    shapes: 16 slots, 12 heads, head_dim 64, pages of 16, a 64-page
    table over a 1024-page pool."""
    from bigdl_tpu_torch.ops.flash_attention import (
        paged_decode_attention, paged_decode_attention_ref)

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
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "bigdl_tpu_torch/ops/csrc/paged_decode_attention.cu",
           "replaces": "bigdl_tpu/ops/flash_attention.py:365",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    emit({"phase": "kernel", "shape": {"slots": S, "heads": h,
                                       "head_dim": d, "page": page,
                                       "n_blocks": nb, "pages": P},
          "keys": keys, "bytes": kv_bytes + io_bytes, "flops": flops,
          "rtol": RTOL, "atol": ATOL, **row})
    return row


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
        worst_gap = worst_logp = 0.0
        with torch.no_grad():
            for p, r in zip(prompts, results):
                ids = np.concatenate([p, r.tokens[:-1]])
                logits = im.model(torch.from_numpy(ids)[None].to(dev))[0]
                if not torch.isfinite(logits).all():
                    raise AssertionError("NaN or inf logit")
                rows = logits[len(p) - 1:]
                tok = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
                picked = rows.gather(1, tok[:, None])[:, 0]
                gap = (rows.max(dim=1).values - picked).max().item()
                lp = torch.log_softmax(rows, dim=1).gather(
                    1, tok[:, None]).sum().item()
                worst_gap = max(worst_gap, gap)
                worst_logp = max(worst_logp, abs(lp - r.logp))
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
              "wall_s": wall, "tokens_per_s": n_tok / wall,
              "setup_s": setup_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30})
        emit({"phase": "profile", **profile_serving(im, prompts)})
        return launches
    finally:
        im.stop()


def profile_serving(im, prompts) -> dict:
    """The same requests once more under torch.profiler: device busy
    share of the wall time and the device time by kernel.  The counts of
    the main run were read before this."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.generate(prompts)
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
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "sources": [s.name for s in _build.sources()],
          "ptxas": ptxas})

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = [check_paged_decode(dev, flush)]
    del flush

    launches = serve(dev)
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
