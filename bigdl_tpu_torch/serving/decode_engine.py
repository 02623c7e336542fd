"""Token-level continuous batching — the paged KV-cache decode engine,
ported from ``bigdl_tpu.serving.decode_engine``.

Generation runs ONE MODEL STEP at a time over a fixed pool of sequence
slots:

- **Paged KV cache** — each layer's K/V live in a pool of fixed-size
  pages (``page_size`` tokens each) on the device; a slot owns an
  ordered page list, so a finished sequence returns its pages mid-flight
  and a queued request reuses them on the next step.
- **In-flight insertion / eviction at step granularity** — admission is
  re-evaluated between steps from a (deadline, seq) heap; a finished or
  expired sequence frees its slot and pages immediately.
- **Prefill/decode separation** — prompts run through a prefill call
  ``prompt_chunk`` tokens at a time (up to ``prefill_batch`` slots per
  call), one call per engine iteration between decode steps, so a long
  prompt never stalls the decode batch.
- **Decode attention** — on CUDA each decode step attends through the
  hand-written paged kernel (``ops.flash_attention``) straight off the
  page pool, once per layer; elsewhere, or with
  ``use_flash_decode=False``, over a gathered contiguous copy of each
  slot's pages.  Prefill always attends over the gathered copy.

:meth:`DecodeEngine.static_generate` decodes each request alone over a
contiguous cache with no pages, slots or scheduling; it is the engine's
own reference.  Both paths share ``chunk_forward`` (the layer math) and
``_select_tokens``.

What this port covers: the LM adapter, float32 pages, greedy selection,
continuous and whole-batch-restart (``continuous=False``) scheduling.
Sampling (``temperature > 0``), int8 pages, speculative decoding and the
prefix cache are refused with a ``ValueError`` until they are ported.

PyTorch writes are in place: the page pool is updated where it lies,
and every write is masked to active rows and in-range positions first
(JAX dropped out-of-range scatter writes; PyTorch's index writes would
raise or corrupt)."""

import heapq
import itertools
import logging
import math
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import _attn_project, positional_encoding
from bigdl_tpu_torch.ops.flash_attention import paged_decode_attention
from bigdl_tpu_torch.tensor.policy import apply_precision_policy, cast_compute

log = logging.getLogger("bigdl_tpu_torch.serving.decode")

_NEG_INF = -1e30


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed while it was queued or decoding."""

    def __init__(self, rid: str, waited_s: float):
        super().__init__(f"request {rid} expired after {waited_s:.3f}s")
        self.rid = rid
        self.waited_s = waited_s


# ---------------------------------------------------------------------------
# config / request / result
# ---------------------------------------------------------------------------

@dataclass
class DecodeConfig:
    """Engine geometry.  ``slots * pages_per_slot`` pages exist by
    default; ``page_size * pages_per_slot`` is the per-sequence token
    cap (prompt + generated)."""

    slots: int = 8
    page_size: int = 16
    pages_per_slot: int = 8
    # total pages in the pool; None = slots * pages_per_slot.  A request
    # is only admitted when its WORST-CASE page need is reservable, so a
    # slot can never starve mid-flight.
    num_pages: Optional[int] = None
    # prefill chunk length, and slots co-batched per prefill call
    prompt_chunk: int = 16
    prefill_batch: int = 4
    max_new_tokens: int = 32          # default per-request cap
    eos_id: int = 1
    # False = whole-batch-restart baseline: admission only when EVERY
    # slot is free, and each wave decodes its longest member's horizon
    # before any seat frees
    continuous: bool = True
    queue_capacity: int = 4096
    # None = the paged kernel on CUDA, the gathered path elsewhere;
    # True on the CPU runs the paged wiring through the kernel's plain
    # version
    use_flash_decode: Optional[bool] = None
    # not ported yet; kept so a config asking for them is refused
    prefix_cache_pages: int = 0
    kv_dtype: str = "float32"
    speculative: Optional[Any] = None

    def __post_init__(self):
        if self.kv_dtype != "float32":
            raise ValueError(f"kv_dtype {self.kv_dtype!r}: only float32 KV "
                             "pages are ported yet (int8 pages are not)")
        if self.speculative is not None:
            raise ValueError("speculative decoding is not ported yet")
        if self.prefix_cache_pages > 0:
            raise ValueError("the prefix cache (prefix_cache_pages > 0) is "
                             "not ported yet")
        if self.slots < 2 or self.prefill_batch < 2:
            raise ValueError("DecodeConfig.slots and prefill_batch must be "
                             ">= 2 (the JAX engine's parity rule)")

    @property
    def cap(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def total_pages(self) -> int:
        return self.num_pages if self.num_pages is not None \
            else self.slots * self.pages_per_slot

    def len_buckets(self) -> Tuple[int, ...]:
        """Cache-length buckets in PAGES: doubling from 1 up to the slot
        cap."""
        out = []
        b = 1
        while b < self.pages_per_slot:
            out.append(b)
            b *= 2
        out.append(self.pages_per_slot)
        return tuple(out)

    def bucket_pages(self, tokens: int) -> int:
        """Smallest bucket (in pages) covering ``tokens`` cache slots,
        floored at 8 attended keys as in the JAX engine."""
        need = max(1, -(-max(tokens, 8) // self.page_size))
        for b in self.len_buckets():
            if b >= need:
                return b
        return self.pages_per_slot


@dataclass
class DecodeRequest:
    """One generation request; ``tokens`` is the prompt."""

    tokens: np.ndarray
    max_new_tokens: Optional[int] = None
    temperature: float = 0.0          # 0 = greedy (the only rule ported)
    rid: Optional[str] = None
    deadline_t: float = math.inf      # absolute; math.inf = never
    on_token: Optional[Callable[[str, int, int], None]] = None
    on_done: Optional[Callable[["DecodeRequest"], None]] = None
    # -- engine-internal ----------------------------------------------------
    admit_t: float = 0.0
    seq: int = 0
    result: Optional["DecodeResult"] = None
    error: Optional[Exception] = None
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False)

    def wait(self, timeout: Optional[float] = None) -> "DecodeResult":
        if not self._event.wait(timeout):
            raise TimeoutError(f"decode request {self.rid} not done")
        if self.error is not None:
            raise self.error
        return self.result


@dataclass
class DecodeResult:
    tokens: np.ndarray        # generated tokens, EOS included if hit
    logp: float               # summed log-prob of the generated tokens
    prompt_len: int
    ttft_s: float             # admission -> first token
    finish_reason: str        # "eos" | "length"


class _ActiveSeq:
    """Host-side state of one occupied slot."""

    __slots__ = ("req", "prompt", "pages", "reserved", "generated", "logp",
                 "prefill_pos", "first_token_t", "max_new", "done")

    def __init__(self, req: DecodeRequest, prompt: np.ndarray,
                 reserved: int, max_new: int):
        self.req = req
        self.prompt = prompt
        self.pages: List[int] = []    # pages this slot owns
        self.reserved = reserved      # owned pages reserved, not yet taken
        self.generated: List[int] = []
        self.logp = np.float32(0.0)
        self.prefill_pos = 0          # prompt tokens consumed by prefill
        self.first_token_t = 0.0
        self.max_new = max_new
        self.done = False

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.prompt)


# ---------------------------------------------------------------------------
# shared math: token selection and cache writes
# ---------------------------------------------------------------------------

def _select_tokens(logits):
    """Greedy next-token selection shared by the engine and the static
    reference: ``(argmax token, its log-prob)`` per row, the log-prob
    from the full log-softmax."""
    logits = logits.float()
    tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok, logp


def _write_chunk(buf, positions, new, cap):
    """Write ``new`` (B, h, C, hd) into ``buf`` (B, h, K, hd) in place
    at per-row positions ``positions + [0..C)``; positions past the cap
    or the buffer (padded chunk tails) are not written."""
    B, _, C, _ = new.shape
    cols = positions[:, None] + torch.arange(C, device=buf.device)[None, :]
    keep = cols < min(cap, buf.shape[2])
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, C)
    buf[rows[keep], :, cols[keep]] = \
        new.permute(0, 2, 1, 3)[keep].to(buf.dtype)


# ---------------------------------------------------------------------------
# model adapter: the layer math both decode paths share
# ---------------------------------------------------------------------------

class LMAdapter:
    """Causal LM (``Transformer(mode="lm")``): the prompt prefills the
    self-attention cache; generation continues from its last token.

    The step math over an explicit KV buffer: the engine feeds it a
    page-gathered view (or attends through the paged kernel), the static
    reference a contiguous cache."""

    def __init__(self, model, cap: int):
        if getattr(model, "mode", None) != "lm":
            raise ValueError("LMAdapter needs a Transformer(mode='lm')")
        self.model = model
        self.device = model.embedding.device
        layer = model.decoder[0].attn
        self.num_heads = layer.num_heads
        self.head_dim = layer.head_dim
        self.num_layers = len(model.decoder)
        self._pe = positional_encoding(cap + 1, model.hidden_size,
                                       device=self.device)
        self._scale = math.sqrt(model.hidden_size)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)

    def _attend(self, q, kb, vb, valid):
        """Masked attention: q (B,h,C,hd) over kb/vb (B,h,K,hd);
        ``valid`` (B,C,K) True = attend."""
        hd = q.shape[-1]
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kb) \
            / math.sqrt(hd)
        logits = logits.masked_fill(~valid[:, None], _NEG_INF)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", w, vb)

    def _merge(self, a, x, attn):
        B, _, C, _ = a.shape
        a = a.transpose(1, 2).reshape(B, C, self.num_heads * self.head_dim)
        return (torch.matmul(a.to(x.dtype), cast_compute(attn.wo)).float()
                + attn.bo).to(x.dtype)

    def _logits(self, x):
        h = self.model.ln_out(x)
        emb = cast_compute(self.model.embedding)
        return torch.matmul(cast_compute(h), emb.T).float()

    def prepare(self, tokens) -> np.ndarray:
        """LM: the prompt IS the decoder prompt."""
        return np.asarray(tokens, np.int32).reshape(-1)

    def chunk_forward(self, tokens, positions, kbuf, vbuf,
                      self_attend=None):
        """One step of C tokens per row: embed at absolute positions,
        write each layer's K/V into the buffer, attend causally over the
        cache, return last-layer logits.  ``tokens`` (B, C) and
        ``positions`` (B,) are int64; ``kbuf/vbuf`` (B, L, h, K, hd)
        float32 are written in place.  ``self_attend(i, q, k_new,
        v_new)`` replaces the buffer attention (the engine's paged path,
        which owns its own cache writes); ``kbuf/vbuf`` may then be
        None."""
        B, C = tokens.shape
        cap = self._pe.shape[0] - 1
        q_pos = positions[:, None] + torch.arange(C, device=self.device)
        # a padded final chunk can run past the cap: its tail rows read
        # the last position (their K/V is never written or attended)
        x = (self.model.embedding[tokens] * self._scale
             + self._pe[q_pos.clamp(max=cap)])
        if self_attend is None:
            K = kbuf.shape[3]
            valid = (torch.arange(K, device=self.device)[None, None, :]
                     <= q_pos[:, :, None])
        k_news, v_news = [], []
        for i, layer in enumerate(self.model.decoder):
            h1 = layer.ln1(x)
            sp = layer.attn
            q = self._split(_attn_project(sp, h1, "wq", "bq"))
            k_new = self._split(_attn_project(sp, h1, "wk", "bk"))
            v_new = self._split(_attn_project(sp, h1, "wv", "bv"))
            if self_attend is not None:
                a = self_attend(i, q, k_new, v_new)
            else:
                _write_chunk(kbuf[:, i], positions, k_new, cap)
                _write_chunk(vbuf[:, i], positions, v_new, cap)
                a = self._attend(q, kbuf[:, i], vbuf[:, i], valid)
            x = x + self._merge(a, x, sp)
            x = x + layer.ffn(layer.ln2(x))
            k_news.append(k_new)
            v_news.append(v_new)
        return (self._logits(x), kbuf, vbuf,
                torch.stack(k_news, 1), torch.stack(v_news, 1))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DecodeEngine:
    """Fixed slot pool + paged KV cache + step-granular scheduling.

    Thread model: clients call :meth:`submit` (any thread); one engine
    thread owns the slots, pages and device cache.  Results are
    delivered through ``DecodeRequest.wait()`` / ``on_done``; per-token
    streaming through ``on_token`` (called on the engine thread)."""

    def __init__(self, adapter: LMAdapter,
                 config: Optional[DecodeConfig] = None,
                 name: str = "decode"):
        apply_precision_policy()
        self.adapter = adapter
        self.cfg = cfg = config or DecodeConfig()
        self.name = name
        self.device = adapter.device
        L, h, hd = adapter.num_layers, adapter.num_heads, adapter.head_dim
        self._kv_k = torch.zeros((L, cfg.total_pages, h, cfg.page_size, hd),
                                 dtype=torch.float32, device=self.device)
        self._kv_v = torch.zeros_like(self._kv_k)
        # host-side slot boards (numpy; copied to the device per call)
        S = cfg.slots
        self._page_table = np.zeros((S, cfg.pages_per_slot), np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._last_tokens = np.zeros((S,), np.int32)
        self._active_mask = np.zeros((S,), bool)
        self._slots: List[Optional[_ActiveSeq]] = [None] * S
        self._free_pages: List[int] = list(range(cfg.total_pages))
        self._reserved_pages = 0
        # work queue: (deadline_t, seq, req)
        self._heap: List[Tuple[float, int, DecodeRequest]] = []
        self._seq = itertools.count(1)
        self._wave_steps = 0     # continuous=False: steps into the wave
        self._wave_horizon = cfg.max_new_tokens
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "completed": 0, "expired": 0,
                      "tokens": 0, "steps": 0, "prefill_chunks": 0,
                      "rejected": 0}

    # -- client side --------------------------------------------------------
    def submit(self, req: DecodeRequest) -> DecodeRequest:
        if self._stop.is_set():
            raise RuntimeError("decode engine stopped")
        if req.temperature > 0.0:
            raise ValueError("temperature > 0 (seeded sampling) is not "
                             "ported yet: it needs threefry2x32 in torch "
                             "to keep seeded parity with JAX; send greedy "
                             "requests (temperature=0)")
        prompt = np.asarray(req.tokens, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt: a generate request needs at "
                             "least one input token")
        if len(prompt) >= self.cfg.cap:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the cache cap "
                f"{self.cfg.cap} (page_size * pages_per_slot)")
        req.admit_t = time.time()
        req.rid = req.rid or f"{self.name}-{next(self._seq)}"
        with self._cv:
            if len(self._heap) >= self.cfg.queue_capacity:
                self.stats["rejected"] += 1
                raise RuntimeError("decode queue full")
            req.seq = next(self._seq)
            heapq.heappush(self._heap, (req.deadline_t, req.seq, req))
            self._cv.notify_all()
        self._ensure_thread()
        return req

    def generate(self, prompts, **kw) -> List[DecodeResult]:
        """Synchronous helper: submit every prompt, wait for all."""
        reqs = [self.submit(DecodeRequest(tokens=np.asarray(p), **kw))
                for p in prompts]
        return [r.wait(timeout=300.0) for r in reqs]

    # -- lifecycle ----------------------------------------------------------
    def _ensure_thread(self) -> None:
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"decode-{self.name}")
                self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
        # fail whatever is still queued or in flight — explicit verdicts
        with self._cv:
            queued = [r for _, _, r in self._heap]
            self._heap.clear()
        for req in queued:
            self._finish_error(req, RuntimeError(
                f"decode request {req.rid} dropped: engine stopped"))
        if self._thread is not None and self._thread.is_alive():
            # a wedged engine thread still owns the slots: releasing them
            # from here could double-free pages
            log.error("decode engine thread did not exit within 10s; "
                      "leaving in-flight slots to it")
            return
        for s, seq in enumerate(self._slots):
            if seq is not None:
                if not seq.done:
                    self._finish_error(seq.req, RuntimeError(
                        f"decode request {seq.req.rid} dropped: engine "
                        "stopped"))
                self._release_slot(s)

    def warmup(self) -> "DecodeEngine":
        """Run one decode step and one prefill call per cache-length
        bucket on all-inactive rows before traffic: on CUDA this builds
        and loads the kernel and initializes the math libraries.  No
        row is active, so nothing is written to the page pool."""
        cfg = self.cfg
        S, B = cfg.slots, cfg.prefill_batch
        for nb in cfg.len_buckets():
            self._step(nb, self._page_table, np.zeros((S,), np.int32),
                       np.zeros((S,), np.int32), np.zeros((S,), bool))
            self._prefill(nb, np.zeros((B, cfg.pages_per_slot), np.int32),
                          np.zeros((B, cfg.prompt_chunk), np.int32),
                          np.zeros((B,), np.int32), np.zeros((B,), np.int32),
                          np.zeros((B,), bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- device calls -------------------------------------------------------
    def _t(self, a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _gather(self, kv, pt):
        """(L, P, h, page, hd)[pages pt (B, nb)] -> (B, L, h, nb*page,
        hd) contiguous per-slot cache view."""
        g = kv[:, pt]                       # (L, B, nb, h, page, hd)
        L, B, nb, h, page, hd = g.shape
        return g.permute(1, 0, 3, 2, 4, 5).reshape(B, L, h, nb * page, hd)

    def _use_flash(self) -> bool:
        if self.cfg.use_flash_decode is not None:
            return bool(self.cfg.use_flash_decode)
        return self.device.type == "cuda"

    @torch.no_grad()
    def _step(self, n_blocks, page_table, lengths, last_tokens, active):
        """One decode step for every slot: write each active slot's new
        K/V at position ``lengths`` and select its next token.  Returns
        (tokens, logps) as numpy arrays over all slots."""
        page = self.cfg.page_size
        adapter = self.adapter
        pt_full = self._t(page_table, torch.int32)
        pt = pt_full[:, :n_blocks]          # row-strided view
        len32 = self._t(lengths, torch.int32)
        pos = len32.long()
        rows = self._t(np.flatnonzero(active), torch.long)
        # write target of this step's K/V: the page holding position
        # ``lengths`` — active slots only
        wid = pt_full.long()[rows, pos[rows] // page]
        off = pos[rows] % page
        tokens = self._t(last_tokens, torch.long)[:, None]
        if self._use_flash():
            def self_attend(i, q, k_new, v_new):
                # write this layer's K/V into the pages FIRST, then run
                # the single-query kernel straight off the page pool
                kp, vp = self._kv_k[i], self._kv_v[i]
                kp[wid, :, off] = k_new[rows, :, 0]
                vp[wid, :, off] = v_new[rows, :, 0]
                out = paged_decode_attention(q[:, :, 0].contiguous(), kp, vp,
                                             pt, len32)
                return out.float()[:, :, None]

            logits = adapter.chunk_forward(tokens, pos, None, None,
                                           self_attend=self_attend)[0]
        else:
            pt64 = pt.long()
            kbuf = self._gather(self._kv_k, pt64)
            vbuf = self._gather(self._kv_v, pt64)
            logits, _, _, k_new, v_new = adapter.chunk_forward(
                tokens, pos, kbuf, vbuf)
            self._kv_k[:, wid, :, off] = k_new[rows, :, :, 0]
            self._kv_v[:, wid, :, off] = v_new[rows, :, :, 0]
        tok, logp = _select_tokens(logits[:, 0])
        return tok.cpu().numpy(), logp.cpu().numpy()

    @torch.no_grad()
    def _prefill(self, n_blocks, pt_rows, tokens, position, last_index,
                 active):
        """Prefill one chunk for up to ``prefill_batch`` rows in one
        call: attend over the pages written so far, write every active
        row's chunk K/V into its pages, and select the FIRST generated
        token at ``last_index`` (meaningful for rows on their final
        chunk).  Returns (tokens, logps) as numpy arrays."""
        cfg = self.cfg
        page, C = cfg.page_size, cfg.prompt_chunk
        pt_rows = self._t(pt_rows, torch.long)
        pt = pt_rows[:, :n_blocks]
        position = self._t(position, torch.long)
        kbuf = self._gather(self._kv_k, pt)
        vbuf = self._gather(self._kv_v, pt)
        logits, _, _, k_new, v_new = self.adapter.chunk_forward(
            self._t(tokens, torch.long), position, kbuf, vbuf)
        B = logits.shape[0]
        last = logits[torch.arange(B, device=self.device),
                      self._t(last_index, torch.long)]          # (B, V)
        tok, logp = _select_tokens(last)
        # write each active row's chunk into its pages; padding rows and
        # positions past the slot cap (padded final-chunk tails) are not
        # written
        pos_c = position[:, None] + torch.arange(C, device=self.device)
        pid = pt_rows.gather(1, (pos_c // page).clamp(0,
                                                      cfg.pages_per_slot - 1))
        ok = self._t(active, torch.bool)[:, None] & (pos_c < cfg.cap)
        off = pos_c % page
        # (B, L, h, C, hd) -> (B, C, L, h, hd) value layout
        self._kv_k[:, pid[ok], :, off[ok]] = k_new.permute(0, 3, 1, 2, 4)[ok]
        self._kv_v[:, pid[ok], :, off[ok]] = v_new.permute(0, 3, 1, 2, 4)[ok]
        return tok.cpu().numpy(), logp.cpu().numpy()

    # -- engine loop --------------------------------------------------------
    def _run(self) -> None:
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else nullcontext():
            while not self._stop.is_set():
                occupied = any(s is not None for s in self._slots)
                with self._cv:
                    if not self._heap and not occupied:
                        self._cv.wait(0.2)
                        continue
                try:
                    now = time.time()
                    self._expire(now)
                    self._admit()
                    did = self._decode_step()
                    did = self._prefill_one() or did
                    if not did:
                        # queued work blocked on slots/pages: wait for a
                        # release/submit notify instead of spinning
                        with self._cv:
                            self._cv.wait(0.05)
                except Exception as e:  # noqa: BLE001 — the engine must
                    # outlive one bad batch: fail the in-flight requests
                    # with the error and keep serving
                    log.error("decode engine iteration failed: %s", e,
                              exc_info=True)
                    for s, seq in enumerate(self._slots):
                        if seq is not None:
                            self._finish_error(seq.req, e)
                            self._release_slot(s)

    def _expire(self, now: float) -> None:
        """Queued requests past their deadline are dropped at pickup;
        active slots are re-checked per token and freed at once."""
        expired_q = []
        with self._cv:
            while self._heap and self._heap[0][0] <= now:
                expired_q.append(heapq.heappop(self._heap)[2])
        for req in expired_q:
            self._finish_expired(req, now)
        for s, seq in enumerate(self._slots):
            if seq is not None and not seq.done \
                    and seq.req.deadline_t <= now:
                self._finish_expired(seq.req, now, seq=seq)
                self._release_slot(s)

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page rows the slot's page table will reference:
        the padded final prefill chunk or the full generation, capped."""
        cfg = self.cfg
        C = cfg.prompt_chunk
        padded_prompt = min(-(-prompt_len // C) * C, cfg.cap)
        worst = min(max(padded_prompt, prompt_len + max_new), cfg.cap)
        return -(-worst // cfg.page_size)

    def _admit(self) -> None:
        cfg = self.cfg
        if not cfg.continuous and any(s is not None for s in self._slots):
            return   # whole-batch-restart baseline: wait for the gang
        while True:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            with self._cv:
                if not self._heap:
                    return
                d, _, req = heapq.heappop(self._heap)
                self._cv.notify_all()
            prompt = self.adapter.prepare(req.tokens)
            max_new = min(req.max_new_tokens or cfg.max_new_tokens,
                          cfg.cap - len(prompt))
            need = self._pages_needed(len(prompt), max_new)
            if len(self._free_pages) - self._reserved_pages < need:
                # not enough reservable pages: push back and wait for a
                # mid-flight release (ordering preserved — same key)
                with self._cv:
                    heapq.heappush(self._heap, (d, req.seq, req))
                return
            s = free[0]
            self._reserved_pages += need
            self._slots[s] = _ActiveSeq(req, prompt, reserved=need,
                                        max_new=max_new)
            self._lengths[s] = 0
            self._last_tokens[s] = 0
            self._active_mask[s] = False          # active once prefilled
            self.stats["requests"] += 1

    def _ensure_pages(self, s: int, upto_tokens: int) -> None:
        """Allocate pages for slot ``s`` covering cache positions
        ``[0, upto_tokens)`` — lazily, inside the admission-time
        reservation, so allocation can never fail mid-flight."""
        seq = self._slots[s]
        need = -(-min(upto_tokens, self.cfg.cap) // self.cfg.page_size)
        while len(seq.pages) < need:
            pid = self._free_pages.pop()
            self._reserved_pages -= 1
            self._page_table[s, len(seq.pages)] = pid
            seq.pages.append(pid)

    def _release_slot(self, s: int) -> None:
        seq = self._slots[s]
        if seq is None:
            return
        self._free_pages.extend(seq.pages)
        self._reserved_pages -= max(seq.reserved - len(seq.pages), 0)
        self._slots[s] = None
        self._active_mask[s] = False
        self._lengths[s] = 0
        with self._cv:
            self._cv.notify_all()

    # -- prefill ------------------------------------------------------------
    def _prefill_one(self) -> bool:
        """Run at most ONE prefill call per engine iteration — up to
        ``prefill_batch`` slots advance one chunk each."""
        cfg = self.cfg
        cand = sorted(
            (self._slots[s].req.seq, s) for s in range(cfg.slots)
            if self._slots[s] is not None and self._slots[s].prefilling)
        if not cand:
            return False
        picked = [s for _, s in cand[:cfg.prefill_batch]]
        B, C = cfg.prefill_batch, cfg.prompt_chunk
        tokens = np.zeros((B, C), np.int32)
        position = np.zeros((B,), np.int32)
        last_index = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        pt_rows = np.zeros((B, cfg.pages_per_slot), np.int32)
        rows = []              # (b, s, real, final)
        max_need = 1
        for b, s in enumerate(picked):
            seq = self._slots[s]
            p0 = seq.prefill_pos
            chunk = seq.prompt[p0:p0 + C]
            real = len(chunk)
            tokens[b, :real] = chunk
            position[b] = p0
            last_index[b] = real - 1
            active[b] = True
            self._ensure_pages(s, min(p0 + C, cfg.cap))
            pt_rows[b] = self._page_table[s]
            rows.append((b, s, real, (p0 + real) >= len(seq.prompt)))
            max_need = max(max_need, min(p0 + C, cfg.cap))
        toks, logps = self._prefill(cfg.bucket_pages(max_need), pt_rows,
                                    tokens, position, last_index, active)
        now = time.time()
        self.stats["prefill_chunks"] += len(rows)
        for b, s, real, final in rows:
            seq = self._slots[s]
            seq.prefill_pos += real
            if final:
                self._lengths[s] = len(seq.prompt)
                self._emit_token(s, seq, int(toks[b]), logps[b], now)
        return True

    # -- decode -------------------------------------------------------------
    def _decode_step(self) -> bool:
        cfg = self.cfg
        if not cfg.continuous and any(
                s is not None and s.prefilling for s in self._slots):
            # whole-batch-restart mode: no decode step until the whole
            # wave finished prefill
            return False
        active = [s for s in range(cfg.slots) if self._active_mask[s]]
        occupied = [s for s in range(cfg.slots)
                    if self._slots[s] is not None]
        # whole-batch-restart mode: the wave steps the full horizon even
        # after every row finished — finished rows ride along inactive
        static_wave = not cfg.continuous and occupied
        if not active and not static_wave:
            return False
        for s in active:
            self._ensure_pages(s, int(self._lengths[s]) + 1)
        ref = active if active else occupied
        nb = cfg.bucket_pages(int(self._lengths[ref].max()) + 1)
        toks, logps = self._step(nb, self._page_table, self._lengths,
                                 self._last_tokens, self._active_mask)
        now = time.time()
        self.stats["steps"] += 1
        for s in active:
            seq = self._slots[s]
            self._lengths[s] += 1          # last_token's K/V just landed
            self._emit_token(s, seq, int(toks[s]), logps[s], now)
        self.stats["tokens"] += len(active)
        if not cfg.continuous:
            if self._wave_steps == 0:
                # the wave's horizon: its longest member's request
                self._wave_horizon = max(
                    (s.max_new for s in self._slots if s is not None),
                    default=cfg.max_new_tokens)
            self._wave_steps += 1
            if self._wave_steps >= self._wave_horizon:
                for s in range(cfg.slots):
                    seq = self._slots[s]
                    if seq is not None and not seq.done:
                        self._finish_ok(s, seq, "length")  # defensive
                    if self._slots[s] is not None:
                        self._release_slot(s)
                self._wave_steps = 0
        return True

    def _emit_token(self, s: int, seq: _ActiveSeq, tok: int,
                    logp: np.float32, now: float) -> None:
        req = seq.req
        if not seq.generated:
            seq.first_token_t = now
        seq.generated.append(tok)
        seq.logp = np.float32(seq.logp + logp)
        if req.on_token is not None:
            try:
                req.on_token(req.rid, tok, len(seq.generated) - 1)
            except Exception:  # noqa: BLE001 — a slow/broken stream
                pass           # consumer must not kill the engine
        if tok == self.cfg.eos_id:
            self._finish_ok(s, seq, "eos")
        elif len(seq.generated) >= seq.max_new:
            self._finish_ok(s, seq, "length")
        else:
            self._last_tokens[s] = tok
            self._active_mask[s] = True

    def _finish_ok(self, s: int, seq: _ActiveSeq, reason: str) -> None:
        req = seq.req
        req.result = DecodeResult(
            tokens=np.asarray(seq.generated, np.int32),
            logp=float(seq.logp), prompt_len=len(seq.prompt),
            ttft_s=seq.first_token_t - req.admit_t, finish_reason=reason)
        self.stats["completed"] += 1
        if self.cfg.continuous:
            self._release_slot(s)
        else:
            # whole-batch-restart mode: the answer is out, but the SEAT
            # is held to the wave's horizon — that is the baseline's cost
            seq.done = True
            self._active_mask[s] = False
        req._event.set()
        if req.on_done is not None:
            try:
                req.on_done(req)
            except Exception:  # noqa: BLE001
                pass

    def _finish_error(self, req: DecodeRequest, err: Exception) -> None:
        req.error = err
        req._event.set()
        if req.on_done is not None:
            try:
                req.on_done(req)
            except Exception:  # noqa: BLE001
                pass

    def _finish_expired(self, req: DecodeRequest, now: float,
                        seq: Optional[_ActiveSeq] = None) -> None:
        self.stats["expired"] += 1
        err = DeadlineExceededError(req.rid, now - req.admit_t)
        if seq is not None and seq.generated:
            # a streaming request that already produced tokens: the
            # partial result rides on the error
            err.partial_tokens = np.asarray(seq.generated, np.int32)
        self._finish_error(req, err)

    # -- the whole-sequence reference ---------------------------------------
    def static_generate(self, requests: Sequence[DecodeRequest]
                        ) -> List[DecodeResult]:
        """The reference: each request decoded alone by the same chunked
        prefill followed by one-token steps over a contiguous
        whole-sequence KV cache (no pages, no slots, no scheduling).
        Each request runs at batch 2 (the row duplicated), as in the
        JAX engine."""
        out = []
        for req in requests:
            if req.temperature > 0.0:
                raise ValueError("temperature > 0 (seeded sampling) is not "
                                 "ported yet")
            prompt = self.adapter.prepare(req.tokens)
            max_new = min(req.max_new_tokens or self.cfg.max_new_tokens,
                          self.cfg.cap - len(prompt))
            out.append(self._static_one(prompt, max_new))
        return out

    @torch.no_grad()
    def _static_one(self, prompt: np.ndarray, max_new: int) -> DecodeResult:
        cfg = self.cfg
        a = self.adapter
        B = 2                                  # duplicated row
        kbuf = torch.zeros((B, a.num_layers, a.num_heads, cfg.cap,
                            a.head_dim), device=self.device)
        vbuf = torch.zeros_like(kbuf)
        C = cfg.prompt_chunk
        t0 = time.time()
        tok = logp = None
        for p0 in range(0, len(prompt), C):
            chunk = np.zeros((C,), np.int32)
            real = len(prompt[p0:p0 + C])
            chunk[:real] = prompt[p0:p0 + C]
            logits, kbuf, vbuf, _, _ = a.chunk_forward(
                self._t(np.stack([chunk, chunk]), torch.long),
                self._t([p0, p0], torch.long), kbuf, vbuf)
            tok, logp = _select_tokens(logits[:, real - 1])
        gen = [int(tok[0])]
        total = np.float32(logp[0].item())
        reason = "eos" if gen[0] == cfg.eos_id else "length"
        pos = len(prompt)
        while reason != "eos" and len(gen) < max_new:
            logits, kbuf, vbuf, _, _ = a.chunk_forward(
                tok[:, None], self._t([pos, pos], torch.long), kbuf, vbuf)
            tok, logp = _select_tokens(logits[:, 0])
            gen.append(int(tok[0]))
            total = np.float32(total + logp[0].item())
            if gen[-1] == cfg.eos_id:
                reason = "eos"
            pos += 1
        return DecodeResult(tokens=np.asarray(gen, np.int32),
                            logp=float(total), prompt_len=len(prompt),
                            ttft_s=time.time() - t0, finish_reason=reason)
