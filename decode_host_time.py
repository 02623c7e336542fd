"""Host time of one call of the port's paged decode wrapper, float32 and
int8 pages, at the LM serving shape chip_smoke.py uses (16 slots, 12
heads, head_dim 64, pages of 16, a 64-page table over 1024 pages).

The card is first given a long spin (``torch.cuda._sleep``), so the
enqueues never wait on it: the wall time of a batch of enqueues without a
synchronize, over the batch, is the wrapper's own host time (checks,
allocations, the C call and its launches).  Thirty batches of 100 calls
for each page type (3,000 enqueues each), the two types taking turns so
that both see the same load on the host's cores; the median batch is
reported.  The device time of a call, back to back with the L2 warm, is
given beside it.

``--serve N`` then serves chip_smoke.py's 16 LM requests (its model,
seed, prompts and DecodeConfig) N times with float32 pages and N times
with int8 pages and weights, speculation off, the two engines taking
turns in one process, and prints each run's tokens/s beside the host
time spent inside the decode wrapper.

    python3 decode_host_time.py [--root DIR] [--serve N]

``--root`` imports ``bigdl_tpu_torch`` and ``chip_smoke`` from another
checkout (say a ``git archive`` of an earlier commit), so two versions
of the wrapper are timed by the same script.  Prints one JSON line per
page type, and one per served run.  Needs a CUDA card.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

SLOTS, HEADS, HEAD_DIM, PAGE, N_BLOCKS, POOL = 16, 12, 64, 16, 64, 1024
BATCHES, CALLS = 30, 100
SPIN_CYCLES = 200_000_000   # about 0.1 s at 1.98 GHz: longer than a batch


def inputs(dev, int8: bool):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=g)
    shape = (POOL, HEADS, PAGE, HEAD_DIM)
    if int8:
        kp = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        sc = {"k_scales": (torch.rand(POOL, generator=g) * 0.02).to(dev),
              "v_scales": (torch.rand(POOL, generator=g) * 0.02).to(dev)}
    else:
        kp = torch.randn(shape, generator=g)
        vp = torch.randn(shape, generator=g)
        sc = {}
    pt = torch.randperm(POOL, generator=g)[:SLOTS * N_BLOCKS]
    pt = pt.reshape(SLOTS, N_BLOCKS).to(torch.int32)
    ln = torch.randint(0, N_BLOCKS * PAGE, (SLOTS,), generator=g,
                       dtype=torch.int32)
    return [t.to(dev) for t in (q, kp, vp, pt, ln)], sc


def host_us(fn) -> float:
    """Per-call host time (µs) of a batch of enqueues."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    dt = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return dt


def device_ms(fn, reps=200) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def serve_runs(dev, n: int) -> None:
    """chip_smoke.py's serving requests, float32 and int8 engines in
    turn, n runs each."""
    import chip_smoke as cs
    import bigdl_tpu_torch.serving.decode_engine as engine
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import DecodeConfig, InferenceModel

    inside = [0.0, 0]   # host seconds in the decode wrapper, calls
    wrapper = engine.paged_decode_attention

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return wrapper(*args, **kwargs)
        finally:
            inside[0] += time.perf_counter() - t0
            inside[1] += 1

    engine.paged_decode_attention = timed
    rs = np.random.RandomState(cs.SEED)
    prompts = [rs.randint(2, cs.LM["vocab_size"], k).astype(np.int32)
               for k in rs.randint(cs.PROMPT_LENS[0], cs.PROMPT_LENS[1] + 1,
                                   cs.N_REQUESTS)]
    engines = {
        "float32": InferenceModel(
            Transformer(**cs.LM, dropout=0.0, seed=cs.SEED),
            decode=DecodeConfig(**cs.DECODE), device=dev),
        "int8": InferenceModel(
            Transformer(**cs.LM, dropout=0.0, seed=cs.SEED),
            decode=DecodeConfig(**cs.DECODE, kv_dtype="int8"), device=dev,
            weight_quant="int8")}
    try:
        for im in engines.values():
            im.warmup()
        for i in range(n):
            for pages, im in engines.items():
                inside[:] = [0.0, 0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results = im.generate(prompts, return_results=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tokens = int(sum(len(r.tokens) for r in results))
                print(json.dumps({
                    "serve": pages, "run": i, "tokens": tokens,
                    "wall_s": wall, "tokens_per_s": tokens / wall,
                    "decode_calls": inside[1],
                    "decode_wrapper_host_s": inside[0]}), flush=True)
    finally:
        for im in engines.values():
            im.stop()
        engine.paged_decode_attention = wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout to import bigdl_tpu_torch "
                    "and chip_smoke from")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="also serve chip_smoke.py's requests N times a "
                    "page type")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, args.root)
    from bigdl_tpu_torch.ops.flash_attention import paged_decode_attention

    if not torch.cuda.is_available():
        print("decode_host_time: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    calls = {}
    for int8 in (False, True):
        (q, kp, vp, pt, ln), sc = inputs(dev, int8)
        name = "paged_decode_attention" + ("_int8" if int8 else "")
        calls[name] = (lambda q=q, kp=kp, vp=vp, pt=pt, ln=ln, sc=sc:
                       paged_decode_attention(q, kp, vp, pt, ln, **sc))
        calls[name]()   # builds and loads the kernel
    batches = {name: [] for name in calls}
    for _ in range(BATCHES):
        for name, call in calls.items():
            batches[name].append(host_us(call))
    for name, call in calls.items():
        print(json.dumps({
            "wrapper": name, "root": args.root or ".",
            "host_us_median": float(np.median(batches[name])),
            "host_us_batches": batches[name],
            "device_ms_back_to_back": device_ms(call),
            "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.serve:
        serve_runs(dev, args.serve)
    return 0


if __name__ == "__main__":
    sys.exit(main())
