"""Token-level continuous batching — the paged KV-cache decode engine,
ported from ``bigdl_tpu.serving.decode_engine``.

Generation runs ONE MODEL STEP at a time over a fixed pool of sequence
slots:

- **Paged KV cache** — each layer's K/V live in a pool of fixed-size
  pages (``page_size`` tokens each) on the device; a slot owns an
  ordered page list, so a finished sequence returns its pages mid-flight
  and a queued request reuses them on the next step.  Pages are float32
  or, with ``kv_dtype="int8"``, int8 with one float32 abs-max scale per
  (layer, page).
- **In-flight insertion / eviction at step granularity** — admission is
  re-evaluated between steps from a (deadline, seq) heap; a finished,
  expired or cancelled sequence frees its slot and pages immediately.
- **Prefill/decode separation** — prompts run through a prefill call
  ``prompt_chunk`` tokens at a time (up to ``prefill_batch`` slots per
  call), one call per engine iteration between decode steps, so a long
  prompt never stalls the decode batch.
- **Decode attention** — on CUDA each decode step attends through the
  hand-written paged kernel (``ops.flash_attention``) straight off the
  page pool, once per layer (the int8 instance for int8 pages);
  elsewhere, or with ``use_flash_decode=False``, over a gathered
  contiguous copy of each slot's pages.  Prefill always attends over the
  gathered copy.
- **Token selection** — greedy, or sampled with temperature, top-k and
  top-p from a counter-based draw: the key of a request is
  ``fold_in(PRNGKey(base_seed), seed)`` and the token at position ``p``
  draws from ``fold_in(key, p)`` (``utils.prng``, threefry2x32 bit for
  bit as the JAX engine), so the stream does not depend on the batch or
  the step it rode in.
- **Speculative decoding** — with ``speculative=SpecConfig(...)`` every
  decode iteration drafts ``k`` tokens with a block-sparse twin of the
  served model (the same parameters, FFNs through the block-sparse
  kernel) over its own float32 draft pool, then ONE target call
  verifies the ``k+1`` chunk (``paged_verify_attention``, or ``k+1``
  decode-step bodies) and the host accepts the longest agreeing
  prefix.  Emitted tokens are always the target's selections.

**The closed program set.**  Every engine call is one of three programs
— the decode step; the prefill call (with the draft's prefill under
speculation); the speculative iteration (the draft's k+1 steps and the
verify, the drafted tokens staying on the device) — at shapes fixed by
its cache bucket ``n_blocks`` and the config alone.  A call's inputs
(page table, lengths, tokens, active mask, the four sampling boards, the
pages whose int8 scales reset) are written into one page-locked host
buffer and reach the card in one copy; its tokens and log-probs come
back in one copy, read after an event.  Whether any row samples is
known on the host and picks the program's greedy or sampled form.  On
CUDA (``DecodeConfig.cuda_graphs``) :meth:`DecodeEngine.warmup`
captures each (program, bucket, greedy or sampled) as a CUDA graph, all
in one memory pool, and every call replays its graph; with
``cuda_graphs=False``, and on the CPU, the same functions run eagerly:
the plain version the graphs are held to.  A program that cannot be
captured raises, naming itself; it never runs eagerly in its place.

**Writes as the JAX engine drops them.**  Every pool (the target K/V
pages, their int8 scales, the draft's pages) has one extra SINK page, id
``total_pages``, that no page table names.  Inactive rows, rows at the
cap and padded chunk positions write there, so every write has a fixed
shape and no mask is computed on the host; nothing reads the sink, and
rows that collide there do no harm.  A gathered cache (the buffers of
:meth:`LMAdapter.chunk_forward`) has a sink row the same way.

:meth:`DecodeEngine.static_generate` decodes each request alone over a
contiguous cache with no pages, slots or scheduling; it is the engine's
own reference.  Both paths share ``chunk_forward`` (the layer math) and
``_select_tokens``.

**The fleet half.**  ``DecodeConfig.prefix_cache_pages`` keeps the
page-aligned prompt prefixes of finished cold requests in a
:class:`~bigdl_tpu_torch.serving.fleet.PrefixCache`; a later request
sharing one maps the cached pages read-only into the leading rows of its
page table and prefills from the attach boundary on.  A prefill-only
request (``DecodeRequest(export_kv=True)``) leaves its prompt's pages on
``kv_export`` (``fleet.handoff.pack_handoff`` serialises them);
:meth:`DecodeEngine.submit_prefilled` imports such a handoff into fresh
pages and continues from its first token; :meth:`DecodeEngine.
migrate_live_slots` exports every live slot the same way.  An attach,
an import and an export are page-table rows and copies on the engine
thread between calls: none adds a program or a capture.

**Translation.**  A :class:`Seq2SeqAdapter`'s "prefill" is the encoder,
run at admission; its cross-attention K/V and source length go into
per-slot context buffers (``ctx_specs``) that the captured step and
prefill programs read.  :class:`~bigdl_tpu_torch.serving.seq2seq.
Seq2SeqService` serves ``translate`` over it.

What this port covers: the LM and seq2seq adapters, float32 and int8
pages, int8 serving weights, greedy and seeded sampled selection,
speculative decoding (with the draft's attention window), the prefix
cache, KV export / import / live migration, continuous and
whole-batch-restart (``continuous=False``) scheduling, cancellation, and
the engine's metrics, events and gauges."""

import heapq
import itertools
import logging
import math
import threading
import time
from collections import Counter, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import (Transformer, _attn_project,
                                          positional_encoding)
from bigdl_tpu_torch.nn.quantized import Int8Weights
from bigdl_tpu_torch.obs import flight, trace
from bigdl_tpu_torch.ops.block_sparse import derive_draft_masks
from bigdl_tpu_torch.ops.common import (DEVICE_GATE, captured_launches,
                                        cdiv, credit_launches, is_dtensor)
from bigdl_tpu_torch.ops.flash_attention import (_gather_pages,
                                                 paged_decode_attention,
                                                 paged_verify_attention)
from bigdl_tpu_torch.ops.quantized import quantize_pages
from bigdl_tpu_torch.parallel import local_ops
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.tensor.policy import (apply_precision_policy,
                                           get_compute_dtype, matmul_f32,
                                           matmul_promote)
from bigdl_tpu_torch.utils import prng

log = logging.getLogger("bigdl_tpu_torch.serving.decode")

_NEG_INF = -1e30


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed while it was queued or decoding
    (``serving.server`` raises the same class, with the JAX server's
    message)."""

    def __init__(self, rid: str, waited_s: float):
        super().__init__(
            f"request {rid} expired after {waited_s:.3f}s in queue "
            "(deadline passed before predict)")
        self.rid = rid
        self.waited_s = waited_s


class RequestCancelledError(RuntimeError):
    """A request was cancelled before it completed: its client went away
    (``reason="client_disconnect"``) or a caller cancelled it
    (:meth:`DecodeEngine.cancel`).  Carries the request id and the
    reason; a stream cancelled after its first token also carries the
    tokens it produced as ``partial_tokens``."""

    def __init__(self, rid: str, reason: str):
        super().__init__(f"request {rid} cancelled: {reason}")
        self.rid = rid
        self.reason = reason


# ---------------------------------------------------------------------------
# config / request / result
# ---------------------------------------------------------------------------

@dataclass
class SpecConfig:
    """Speculative-decoding knobs.  The draft is the served checkpoint
    itself with block-sparse FFNs (the same parameters, masks pruned
    from the served weights); ``sparsity`` trades draft speed against
    acceptance (0.0 = a dense twin: acceptance 1.0)."""

    k: int = 4                 # tokens drafted per engine iteration
    sparsity: float = 0.5      # FFN block sparsity of the draft twin
    sparse_block: Tuple[int, int] = (8, 8)
    # the draft FFNs go through block_sparse_matmul (its kernel on CUDA,
    # its plain version on the CPU); "auto" is the only form
    draft_impl: str = "auto"
    # how the target scores the chunk: "scan" = k+1 decode-step bodies
    # (the tokens and log-probs of spec-off decoding); "chunk" = one
    # multi-query pass through paged_verify_attention (tokens of
    # spec-off decoding, log-probs within float32 rounding; float32
    # pages only); "auto" = chunk where the paged kernel runs, scan
    # elsewhere.  An iteration with a sampled slot always scans: top-k
    # and top-p thresholds are discontinuous in the last-ulp logit
    # drift of the chunk pass.
    verify_impl: str = "auto"
    # None = the draft attends its whole context; an int W = at every
    # cache bucket wider than W the draft's k+1 steps attend a ring of
    # its last W positions' K/V (slot q % W holds position q) instead of
    # the whole gathered cache.  The verify still reads the whole cache,
    # so the tokens are unchanged; only the acceptance moves
    draft_window: Optional[int] = None


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
    # root of every request's sampling key: PRNGKey(base_seed)
    base_seed: int = 0
    # False = whole-batch-restart baseline: admission only when EVERY
    # slot is free, and each wave decodes its longest member's horizon
    # before any seat frees
    continuous: bool = True
    queue_capacity: int = 4096
    # None = the paged kernel on CUDA, the gathered path elsewhere;
    # True on the CPU runs the paged wiring through the kernel's plain
    # version
    use_flash_decode: Optional[bool] = None
    # prefix/KV reuse: finished cold requests donate the page-aligned
    # prefix of their prompt to a per-engine cache of up to this many
    # pages (0 = off; continuous mode only), and later requests sharing
    # the prefix attach to the cached pages instead of prefilling them.
    # Idle entries are evicted (LRU) when admission runs short of pages
    prefix_cache_pages: int = 0
    # KV page storage: "float32", or "int8" pages with one float32
    # abs-max scale per (layer, page) — 4x fewer page bytes, token
    # parity with float32 within the quantization budget
    kv_dtype: str = "float32"
    # a SpecConfig turns every decode iteration into draft(k) + verify
    # (continuous LM engines only)
    speculative: Optional[SpecConfig] = None
    # every engine call a replay of a CUDA graph that warmup() captured:
    # None = graphs on CUDA, eager on the CPU; False = eager (the plain
    # version the graphs are held to); True on the CPU raises
    cuda_graphs: Optional[bool] = None

    def __post_init__(self):
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError(f"DecodeConfig.kv_dtype must be 'float32' or "
                             f"'int8', got {self.kv_dtype!r}")
        if self.speculative is not None and not isinstance(
                self.speculative, SpecConfig):
            raise ValueError(f"DecodeConfig.speculative must be a "
                             f"SpecConfig or None, got "
                             f"{type(self.speculative).__name__}")
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
    """One generation request; ``tokens`` is the prompt (for a seq2seq
    adapter, the SOURCE sequence).  ``temperature > 0`` samples with
    ``top_k`` (0 = off), ``top_p`` (1.0 = off) and the request's ``seed``.

    ``export_kv=True`` runs a prefill-only request (pair it with
    ``max_new_tokens=1``): when it finishes, its prompt's pages are
    copied to the host onto ``kv_export`` (``fleet.handoff``'s dict).
    ``handoff``: an unpacked handoff whose prefill ran on another engine
    (:meth:`DecodeEngine.submit_prefilled`)."""

    tokens: np.ndarray
    max_new_tokens: Optional[int] = None
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    rid: Optional[str] = None
    deadline_t: float = math.inf      # absolute; math.inf = never
    tenant: str = "default"           # the serving tenant (trace events)
    on_token: Optional[Callable[[str, int, int], None]] = None
    on_done: Optional[Callable[["DecodeRequest"], None]] = None
    export_kv: bool = False
    handoff: Optional[dict] = None
    # -- engine-internal ----------------------------------------------------
    kv_export: Optional[dict] = None   # filled by the export_kv path
    prepared: Optional[tuple] = None   # the adapter's prepare(), cached
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

    __slots__ = ("req", "prompt", "ctx", "pages", "reserved", "generated",
                 "logp", "first_logp", "last_logp", "prefill_pos", "shared",
                 "shared_entry", "first_token_t", "max_new", "done",
                 "frozen")

    def __init__(self, req: DecodeRequest, prompt: np.ndarray, ctx,
                 reserved: int, max_new: int):
        self.req = req
        self.prompt = prompt
        self.ctx = ctx                # the adapter's per-slot context
        self.pages: List[int] = []    # pages this slot owns (the rows
        #                               after any shared prefix rows)
        self.reserved = reserved      # owned pages reserved, not yet taken
        self.generated: List[int] = []
        self.logp = np.float32(0.0)
        self.first_logp = np.float32(0.0)
        self.last_logp = np.float32(0.0)
        self.prefill_pos = 0          # prompt tokens consumed by prefill
        self.shared: List[int] = []   # prefix-cache pages mapped read-only
        self.shared_entry = None      # the cache entry holding our ref
        self.first_token_t = 0.0
        self.max_new = max_new
        self.done = False
        self.frozen = False           # migrated: exported, no more steps

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.prompt)


# ---------------------------------------------------------------------------
# shared math: token selection and cache writes
# ---------------------------------------------------------------------------

class _Sampling:
    """Per-row sampling boards of one call, on the call's device: request
    seeds, temperatures, top-k and top-p.  ``sampled`` — known on the
    host — says whether any row samples; a greedy call takes the plain
    argmax and derives no key."""

    __slots__ = ("seeds", "temps", "top_ks", "top_ps", "sampled")

    def __init__(self, seeds, temps, top_ks, top_ps, sampled: bool):
        self.seeds, self.temps = seeds, temps
        self.top_ks, self.top_ps = top_ks, top_ps
        self.sampled = sampled

    @classmethod
    def from_host(cls, seeds, temps, top_ks, top_ps, device) -> "_Sampling":
        temps = np.asarray(temps, np.float32)

        def t(a, dt):
            return torch.from_numpy(np.asarray(a, dt)).to(device)

        return cls(t(seeds, np.int32), t(temps, np.float32),
                   t(top_ks, np.int32), t(top_ps, np.float32),
                   bool(np.any(temps > 0.0)))

    def repeat(self, c: int) -> "_Sampling":
        """Each row ``c`` times (the rows of a verify chunk)."""
        return _Sampling(*(b[:, None].expand(-1, c).reshape(-1) for b in (
            self.seeds, self.temps, self.top_ks, self.top_ps)),
            self.sampled)

    def select(self, logits, base_key, positions):
        """:func:`_select_tokens` of ``logits`` (B, V) for tokens at
        ``positions`` (B,) long."""
        if not self.sampled:
            return _select_tokens(logits)
        keys = prng.fold_in(base_key, self.seeds)
        return _select_tokens(logits, keys, positions, self.temps,
                              self.top_ks, self.top_ps)


def _select_tokens(logits, keys=None, positions=None, temps=None,
                   top_ks=None, top_ps=None):
    """Per-row next-token selection shared by the engine and the static
    reference: ``(token, its log-prob)``, the log-prob from the
    UNfiltered log-softmax.

    Without ``temps`` every row takes the argmax.  With them, rows with
    ``temps > 0`` apply temperature, top-k (threshold at the k-th sorted
    value), top-p (keep the token that crosses the mass) and a Gumbel-max
    draw ``argmax(z - log(-log(u)))`` with ``u = uniform(fold_in(key,
    position), (vocab,), tiny, 1)``: ``keys`` (B, 2) are the rows'
    request keys and ``positions`` (B,) the positions the tokens will
    occupy.  The JAX engine's rule, bit for bit in its draws.  No value
    crosses from the host: a captured program can select."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    tok = greedy
    if temps is not None:
        vocab = logits.shape[-1]
        z = logits / torch.clamp(temps, min=1e-6)[:, None]
        zs = torch.sort(z, dim=-1, descending=True).values
        kth = zs.gather(-1, (top_ks.long() - 1).clamp(0, vocab - 1)[:, None])
        z = torch.where((top_ks > 0)[:, None] & (z < kth), -math.inf, z)
        zs2 = torch.sort(z, dim=-1, descending=True).values
        ps = torch.softmax(zs2, dim=-1)
        keep = (torch.cumsum(ps, dim=-1) - ps) < top_ps[:, None]
        minz = torch.where(keep, zs2, math.inf).amin(dim=-1, keepdim=True)
        z = torch.where((top_ps < 1.0)[:, None] & (z < minz), -math.inf, z)
        u = prng.uniform(prng.fold_in(keys, positions), (vocab,),
                         float(np.finfo(np.float32).tiny), 1.0)
        sampled = torch.argmax(z - torch.log(-torch.log(u)), dim=-1)
        tok = torch.where(temps <= 0.0, greedy, sampled)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok, logp


def _write_chunk(buf, positions, new, cap):
    """Write ``new`` (B, h, C, hd) into ``buf`` (B+1, h, K, hd) in place
    at per-row positions ``positions + [0..C)``; a position past the cap
    or the buffer (a padded chunk tail) lands in the sink row B instead,
    so the write has one shape whatever the positions."""
    B, _, C, _ = new.shape
    cols = positions[:, None] + torch.arange(C, device=buf.device)[None, :]
    keep = cols < min(cap, buf.shape[2])
    rows = torch.where(keep, torch.arange(B, device=buf.device)[:, None], B)
    buf[rows, :, torch.where(keep, cols, 0)] = \
        new.permute(0, 2, 1, 3).to(buf.dtype)


# ---------------------------------------------------------------------------
# model adapter: the layer math both decode paths share
# ---------------------------------------------------------------------------

class _AdapterBase:
    """The step math both decode paths share, over an explicit KV buffer:
    the engine feeds it a page-gathered view (or attends through the
    paged kernel), the static reference a contiguous cache.

    ``weight_quant="int8"`` serves a copy of the model whose matmul
    weights are int8 at rest (``nn.quantized.Int8Weights``: per-out-column
    scales; the caller's model is left as it is); every engine program
    runs inside :meth:`weights`, which lends ``self.model`` a dequantized
    float32 view for that call only (inside a captured graph, the view's
    dequantize kernels are part of the graph).

    ``layout`` (a ``parallelism=`` combo string or a ``ResolvedLayout``)
    serves the model sharded: its parameters become DTensors per its
    table (unless they already are), then under ``weight_quant`` the
    int8 payloads take the same placements.  The engine's pools, inputs
    and outputs stay plain tensors, the same on every rank: each rank's
    pool holds every head, and the attention gathers q and the new k /
    v first (``parallel.local_ops.paged_attention``), so the kernels run
    as without a layout and an int8 page's scale is the amax over all
    its heads, as in the JAX engine.  Every rank must be called with the
    same requests, in the same order."""

    def __init__(self, model, weight_quant: Optional[str] = None,
                 layout=None):
        self.layout = None
        if layout is not None:
            from bigdl_tpu_torch.parallel.mesh_policy import (
                ResolvedLayout, mesh_and_layout)

            self.layout = (layout if isinstance(layout, ResolvedLayout)
                           else mesh_and_layout(str(layout),
                                                model.embedding.device))
            if not is_dtensor(model.embedding):
                self.layout.shard_params(model)
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant {weight_quant!r}: None | 'int8'")
        self.weight_quant = weight_quant
        # placed first, then quantized: the int8 payloads and their
        # scales are DTensors with the float weights' placements
        self._w8 = Int8Weights(model) if weight_quant == "int8" else None
        self.model = self._w8.module if self._w8 is not None else model
        self.device = model.embedding.device

    def _on_layout(self):
        """Plain tensors (tokens, positions, the pools) are replicated
        ones on a layout."""
        if self.layout is None:
            return nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()

    def weights(self):
        """Context in which the model's parameters hold float32 values:
        the dequantized view under ``weight_quant="int8"``, else the
        parameters as they are."""
        return self._w8.view() if self._w8 is not None else nullcontext()

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
        # float32 attention against the cast wo: JAX promotes the
        # product to float32
        return (matmul_promote(a, attn.wo) + attn.bo).to(x.dtype)

    def _logits(self, x):
        h = self.model.ln_out(x)
        # the engine samples from every rank's whole logits
        return local_ops.replicated(matmul_f32(h, self.model.embedding.T))

    def _embed(self, tokens, positions):
        """Token embeddings at absolute positions ``positions[:, None] +
        [0..C)``; a padded final chunk can run past the cap, and its tail
        rows read the last position (their K/V is never written or
        attended).  Returns (x, q_pos)."""
        C = tokens.shape[1]
        cap = self._pe.shape[0] - 1
        q_pos = positions[:, None] + torch.arange(C, device=self.device)
        emb = self.model.embedding
        e = (local_ops.vocab_lookup(emb, tokens) if is_dtensor(emb)
             else emb[tokens])
        x = e * self._scale + self._pe[q_pos.clamp(max=cap)]
        return x, q_pos

    def _causal_valid(self, q_pos, kbuf, self_attend):
        """The causal mask (B, C, K) over the buffers, built once a call;
        None when ``self_attend`` owns the attention."""
        if self_attend is not None:
            return None
        return (torch.arange(kbuf.shape[3], device=self.device)
                [None, None, :] <= q_pos[:, :, None])

    def _self_attention(self, i, layer_attn, h1, positions, kbuf, vbuf,
                        self_attend, valid):
        """Layer ``i``'s self-attention of the normed input ``h1``: the
        engine's ``self_attend`` hook, or a write into the buffers and an
        attention over them under ``valid`` (:meth:`_causal_valid`).
        Returns (output, k_new, v_new)."""
        sp = layer_attn
        q = self._split(_attn_project(sp, h1, "wq", "bq"))
        k_new = self._split(_attn_project(sp, h1, "wk", "bk"))
        v_new = self._split(_attn_project(sp, h1, "wv", "bv"))

        def attend(q, k_new, v_new):
            if self_attend is not None:
                return self_attend(i, q, k_new, v_new), k_new, v_new
            cap = self._pe.shape[0] - 1
            B = q.shape[0]
            _write_chunk(kbuf[:, i], positions, k_new, cap)
            _write_chunk(vbuf[:, i], positions, v_new, cap)
            return (self._attend(q, kbuf[:B, i], vbuf[:B, i], valid),
                    k_new, v_new)

        if is_dtensor(q):
            # a layout: the pool holds whole heads on every rank
            return local_ops.paged_attention(attend, q, k_new, v_new)
        return attend(q, k_new, v_new)


class LMAdapter(_AdapterBase):
    """Causal LM (``Transformer(mode="lm")``): the prompt prefills the
    self-attention cache; generation continues from its last token."""

    def __init__(self, model, cap: int, weight_quant: Optional[str] = None,
                 layout=None):
        if getattr(model, "mode", None) != "lm":
            raise ValueError("LMAdapter needs a Transformer(mode='lm')")
        super().__init__(model, weight_quant, layout)
        layer = model.decoder[0].attn
        self.num_heads = layer.num_heads
        self.head_dim = layer.head_dim
        self.num_layers = len(model.decoder)
        self._pe = positional_encoding(cap + 1, model.hidden_size,
                                       device=self.device)
        self._scale = math.sqrt(model.hidden_size)

    def ctx_specs(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        return {}

    def prepare(self, tokens):
        """LM: the prompt IS the decoder prompt; no context."""
        return np.asarray(tokens, np.int32).reshape(-1), {}

    def chunk_forward(self, tokens, positions, kbuf, vbuf, ctx=None,
                      self_attend=None, model=None):
        """One step of C tokens per row: embed at absolute positions,
        write each layer's K/V into the buffer, attend causally over the
        cache, return last-layer logits.  ``tokens`` (B, C) and
        ``positions`` (B,) are int64; ``kbuf/vbuf`` (B+1, L, h, K, hd)
        float32 are written in place, row B a sink that takes the writes
        of positions past the cap or the buffer (see
        :func:`_write_chunk`).  ``self_attend(i, q, k_new, v_new)``
        replaces the buffer attention (the engine's paged path, which
        owns its own cache writes); ``kbuf/vbuf`` may then be None.
        ``model`` walks a twin's layers instead (the speculative draft:
        the same parameters, block-sparse FFNs).  An LM has no ``ctx``."""
        with self._on_layout():
            x, q_pos = self._embed(tokens, positions)
            valid = self._causal_valid(q_pos, kbuf, self_attend)
            k_news, v_news = [], []
            for i, layer in enumerate((model or self.model).decoder):
                a, k_new, v_new = self._self_attention(
                    i, layer.attn, layer.ln1(x), positions, kbuf, vbuf,
                    self_attend, valid)
                x = x + self._merge(a, x, layer.attn)
                x = x + layer.ffn(layer.ln2(x))
                k_news.append(k_new)
                v_news.append(v_new)
            return (self._logits(x), kbuf, vbuf,
                    torch.stack(k_news, 1), torch.stack(v_news, 1))

    def build_draft(self, spec: SpecConfig):
        """The weight-sharing speculative DRAFT twin: the same LM
        architecture built with ``ffn_sparsity=spec.sparsity``, whose
        parameters are the served model's own ``Parameter`` objects (no
        copy), and whose FFN block masks are pruned once from the served
        weights (their dequantized view under ``weight_quant``).
        ``sparsity=0.0`` gives a dense twin, bit-identical to the
        target."""
        if spec.draft_impl != "auto":
            raise ValueError(f"SpecConfig.draft_impl {spec.draft_impl!r}: "
                             "only 'auto' (block_sparse_matmul) is ported")
        m = self.model
        sparsity = float(spec.sparsity)
        draft = Transformer(
            m.vocab_size, m.hidden_size, self.num_heads,
            ffn_size=int(m.decoder[0].ffn.l1.out_features),
            num_layers=self.num_layers, dropout=0.0, mode="lm",
            ffn_sparsity=sparsity, sparse_block=tuple(spec.sparse_block))
        for mod_name, mod in draft.named_modules():
            for pname in list(mod._parameters):
                full = f"{mod_name}.{pname}" if mod_name else pname
                mod._parameters[pname] = m.get_parameter(full)
        draft.train(False)
        if sparsity > 0.0:
            with self.weights():
                derive_draft_masks(draft, sparsity)
        return draft


class Seq2SeqAdapter(_AdapterBase):
    """Translation Transformer (``mode="translation"``): the "prefill" is
    the ENCODER, run once a request at admission (:meth:`prepare`), which
    turns the source into each decoder layer's cross-attention K/V,
    padded to ``src_cap`` (the largest of ``src_buckets``), and the
    source length.  The decoder prompt is one BOS, and every decode step
    is query-length 1 over the paged self-attention cache plus the fixed
    cross context, masked to the source length: the op sequence of
    ``nn.attention.transformer_decode_cached``.  A source is encoded at
    the smallest of ``src_buckets`` that holds it, under a key-padding
    mask, so a padded encode gives the exact-length encode's rows."""

    def __init__(self, model, cap: int, bos_id: int,
                 src_buckets: Sequence[int] = (8, 16, 32, 64),
                 weight_quant: Optional[str] = None, layout=None):
        if getattr(model, "mode", None) != "translation":
            raise ValueError("Seq2SeqAdapter needs a translation-mode "
                             "Transformer")
        super().__init__(model, weight_quant, layout)
        layer = model.decoder[0].self_attn
        self.num_heads = layer.num_heads
        self.head_dim = layer.head_dim
        self.num_layers = len(model.decoder)
        self.bos_id = int(bos_id)
        self.src_buckets = tuple(sorted(int(b) for b in src_buckets))
        self.src_cap = self.src_buckets[-1]
        self._pe = positional_encoding(cap + 1, model.hidden_size,
                                       device=self.device)
        self._scale = math.sqrt(model.hidden_size)

    def ctx_specs(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        L, h, hd = self.num_layers, self.num_heads, self.head_dim
        return {"ck": ((L, h, self.src_cap, hd), torch.float32),
                "cv": ((L, h, self.src_cap, hd), torch.float32),
                "src_len": ((), torch.int32)}

    @torch.no_grad()
    def _encode(self, src: np.ndarray, src_len: int):
        """The cross-attention K/V of one bucket-padded source (1, bucket)
        under a key-padding mask: (L, h, src_cap, hd) each."""
        m = self.model
        bucket = src.shape[1]
        src_t = torch.from_numpy(src).to(self.device)
        mask = (torch.arange(bucket, device=self.device)
                < src_len)[None, None, None, :]
        with self.weights(), self._on_layout():
            x = m._embed(src_t)
            for layer in m.encoder:
                x = layer(x, mask=mask)
            pad = self.src_cap - bucket
            cks, cvs = [], []
            for layer in m.decoder:
                cp = layer.cross_attn
                for out, w, b in ((cks, "wk", "bk"), (cvs, "wv", "bv")):
                    t = local_ops.replicated(
                        self._split(_attn_project(cp, x, w, b))).float()
                    out.append(torch.nn.functional.pad(t, (0, 0, 0, pad))[0])
        return torch.stack(cks), torch.stack(cvs)

    def prepare(self, tokens):
        """(the BOS decoder prompt, the context of the source ``tokens``)."""
        src = np.asarray(tokens, np.int32).reshape(1, -1)
        t = src.shape[1]
        bucket = next((b for b in self.src_buckets if b >= t), None)
        if bucket is None:
            raise ValueError(f"source length {t} exceeds the largest "
                             f"src bucket {self.src_buckets[-1]}")
        if bucket > t:
            src = np.pad(src, ((0, 0), (0, bucket - t)))
        ck, cv = self._encode(src, t)
        ctx = {"ck": ck, "cv": cv,
               "src_len": torch.tensor(t, dtype=torch.int32,
                                       device=self.device)}
        return np.asarray([self.bos_id], np.int32), ctx

    def warmup_buckets(self, sample_src_lens: Optional[Sequence[int]] = None
                       ) -> None:
        """One encode of every source bucket."""
        for b in (sample_src_lens or self.src_buckets):
            self._encode(np.zeros((1, int(b)), np.int32), int(b))

    def chunk_forward(self, tokens, positions, kbuf, vbuf, ctx=None,
                      self_attend=None):
        """Decoder step: causal self-attention over the cache (as
        :meth:`LMAdapter.chunk_forward`), cross-attention over each row's
        context ``ctx`` (``ck`` / ``cv`` (B, L, h, src_cap, hd),
        ``src_len`` (B,)) masked to its source length, and the FFN."""
        with self._on_layout():
            x, q_pos = self._embed(tokens, positions)
            B, C = tokens.shape
            src_valid = (torch.arange(self.src_cap, device=self.device)
                         [None, None, :] < ctx["src_len"].reshape(-1, 1, 1))
            src_valid = src_valid.expand(B, C, self.src_cap)
            valid = self._causal_valid(q_pos, kbuf, self_attend)
            k_news, v_news = [], []
            for i, layer in enumerate(self.model.decoder):
                a, k_new, v_new = self._self_attention(
                    i, layer.self_attn, layer.ln1(x), positions, kbuf, vbuf,
                    self_attend, valid)
                x = x + self._merge(a, x, layer.self_attn)
                cp = layer.cross_attn
                qc = local_ops.replicated(self._split(
                    _attn_project(cp, layer.ln2(x), "wq", "bq")))
                a = self._attend(qc, ctx["ck"][:, i], ctx["cv"][:, i],
                                 src_valid)
                x = x + self._merge(a, x, cp)
                x = x + layer.ffn(layer.ln3(x))
                k_news.append(k_new)
                v_news.append(v_new)
            return (self._logits(x), kbuf, vbuf,
                    torch.stack(k_news, 1), torch.stack(v_news, 1))


# ---------------------------------------------------------------------------
# the closed program set: packed inputs and outputs, captured graphs
# ---------------------------------------------------------------------------

class _Fields:
    """Named fields of one flat int32 buffer (float32 fields hold their
    bits): a call's inputs or outputs, packed so that they cross between
    the host and the card in one copy."""

    def __init__(self, fields):
        self.layout = {}
        n = 0
        for name, shape, dtype in fields:
            size = int(np.prod(shape))
            self.layout[name] = (n, n + size, tuple(shape), dtype)
            n += size
        self.size = n

    def split(self, flat) -> Dict[str, Any]:
        """Typed views of ``flat`` (a numpy array or a tensor)."""
        out = {}
        for name, (a, b, shape, dtype) in self.layout.items():
            v = flat[a:b]
            if dtype == "float32":
                v = v.view(torch.float32 if isinstance(v, torch.Tensor)
                           else np.float32)
            out[name] = v.reshape(shape)
        return out


class _Program:
    """One program of the closed set: its function, its packed inputs and
    outputs (a host image, page-locked on CUDA, and the device buffer
    every graph of the program reads or writes), the inputs of an idle
    call (no row active: it writes only the sink pages), and the event
    after which its outputs are read."""

    def __init__(self, fn, inputs, outputs, sink: int, device):
        on_card = device.type == "cuda"
        self.fn = fn
        self.inputs, self.outputs = _Fields(inputs), _Fields(outputs)
        self.host_in = torch.zeros(self.inputs.size, dtype=torch.int32,
                                   pin_memory=on_card)
        self.dev_in = torch.zeros(self.inputs.size, dtype=torch.int32,
                                  device=device)
        self.host_out = torch.zeros(self.outputs.size, dtype=torch.int32,
                                    pin_memory=on_card)
        self.dev_out = torch.zeros(self.outputs.size, dtype=torch.int32,
                                   device=device)
        self.x = self.inputs.split(self.host_in.numpy())
        self.x_dev = self.inputs.split(self.dev_in)
        self.y = self.outputs.split(self.host_out.numpy())
        self.y_dev = self.outputs.split(self.dev_out)
        idle = np.zeros(self.inputs.size, np.int32)
        v = self.inputs.split(idle)
        v["top_ps"][:] = 1.0
        v["fresh"][:] = sink
        self.idle_np = idle
        self.idle = torch.from_numpy(idle)
        self.done = torch.cuda.Event() if on_card else None

    def reset(self) -> None:
        """The host image back to an idle call."""
        self.host_in.numpy()[:] = self.idle_np

    def run(self, n_blocks: int, sampled: bool) -> None:
        """The program on the inputs in ``dev_in``, its outputs written
        into ``dev_out``: what a graph captures and a replay repeats."""
        outs = self.fn(n_blocks, sampled, self.x_dev)
        for t, v in zip(outs, self.y_dev.values()):
            v.copy_(t)


@dataclass
class _Graph:
    """One captured program: the graph and the kernel launches its
    capture recorded (credited at each replay)."""

    graph: Any
    launches: Any


class _Marks:
    """Points that split a program's device time (the speculative
    iteration's draft and verify): CUDA events recorded inside the
    program, external so that a replay of its graph records them too;
    on the CPU, where every op has finished when it returns, the host
    clock."""

    def __init__(self, n: int, device):
        self._ev = ([torch.cuda.Event(enable_timing=True, external=True)
                     for _ in range(n)] if device.type == "cuda" else None)
        self._t = [0.0] * n

    def mark(self, i: int) -> None:
        if self._ev is not None:
            self._ev[i].record()
        else:
            self._t[i] = time.perf_counter()

    def seconds(self, i: int, j: int) -> float:
        """From mark ``i`` to mark ``j``, once both have been reached."""
        if self._ev is not None:
            return self._ev[i].elapsed_time(self._ev[j]) / 1e3
        return self._t[j] - self._t[i]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DecodeEngine:
    """Fixed slot pool + paged KV cache + step-granular scheduling.

    Thread model: clients call :meth:`submit` and :meth:`cancel` (any
    thread); one engine thread owns the slots, pages and device cache,
    one iteration at a time under ``_iter_lock``.  Results are delivered
    through ``DecodeRequest.wait()`` / ``on_done``; per-token streaming
    through ``on_token`` (called on the engine thread).

    ``metrics`` (default: the process-wide ``optim.metrics`` registry)
    receives the ``serving.decode.*`` counters, histograms and gauges
    under the JAX engine's names; ``events`` keeps the last 512
    scheduling events."""

    # eager runs of a program on idle rows before its capture
    WARM_RUNS = 1

    def __init__(self, adapter: _AdapterBase,
                 config: Optional[DecodeConfig] = None, metrics=None,
                 name: str = "decode"):
        apply_precision_policy()
        self.adapter = adapter
        self.cfg = cfg = config or DecodeConfig()
        if metrics is None:
            from bigdl_tpu_torch.optim.metrics import global_metrics

            metrics = global_metrics()
        self.metrics = metrics
        self.name = name
        self.device = adapter.device
        on_card = self.device.type == "cuda"
        if cfg.cuda_graphs and not on_card:
            raise ValueError(f"DecodeConfig.cuda_graphs=True needs a CUDA "
                             f"device, got {self.device}; None runs "
                             f"eagerly off the card")
        self._graphs_on = (on_card if cfg.cuda_graphs is None
                           else bool(cfg.cuda_graphs))
        L, h, hd = adapter.num_layers, adapter.num_heads, adapter.head_dim
        # one sink page past the pool: the target of every masked write
        self._sink = cfg.total_pages
        shape = (L, cfg.total_pages + 1, h, cfg.page_size, hd)
        # int8 pages: one float32 abs-max scale per (layer, page) beside
        # the int8 payload
        self._quant_kv = cfg.kv_dtype == "int8"
        kv_dt = torch.int8 if self._quant_kv else torch.float32
        self._kv_k = torch.zeros(shape, dtype=kv_dt, device=self.device)
        self._kv_v = torch.zeros_like(self._kv_k)
        self._kv_sk = self._kv_sv = None
        if self._quant_kv:
            self._kv_sk = torch.zeros((L, cfg.total_pages + 1),
                                      dtype=torch.float32, device=self.device)
            self._kv_sv = torch.zeros_like(self._kv_sk)
        # pages popped off the free list whose scales still hold the last
        # owner's: zeroed by the next call before it reads them
        self._fresh_pages: List[int] = []
        # the adapter's per-slot context (a seq2seq adapter's encoder
        # output): static buffers written at admission, outside the
        # programs, and read by the captured step and prefill programs
        self._ctx_bufs = {
            k: torch.zeros((cfg.slots,) + tuple(shape), dtype=dt,
                           device=self.device)
            for k, (shape, dt) in adapter.ctx_specs().items()}
        # prefix/KV reuse: pages the cache holds are off the free list,
        # so the page accounting stays exact
        self._prefix_cache = None
        if cfg.prefix_cache_pages > 0 and cfg.continuous:
            from bigdl_tpu_torch.serving.fleet.prefix_cache import \
                PrefixCache

            self._prefix_cache = PrefixCache(
                min(cfg.prefix_cache_pages, cfg.total_pages),
                cfg.page_size, page_dtype=cfg.kv_dtype)
        # speculative decoding: the draft's K/V live in a parallel float32
        # pool indexed by the SAME page table, so one allocation and one
        # release cover both
        self._spec = cfg.speculative
        self._draft_model = None
        self._dr_k = self._dr_v = None
        if self._spec is not None:
            sp = self._spec
            if not cfg.continuous:
                raise ValueError("speculative decoding requires "
                                 "continuous mode")
            if adapter.ctx_specs() or not hasattr(adapter, "build_draft"):
                raise ValueError(
                    "speculative decoding supports LM adapters only (a "
                    "seq2seq draft would need its own cross context)")
            if not 1 <= int(sp.k) < cfg.cap:
                raise ValueError(f"SpecConfig.k must be in [1, {cfg.cap}), "
                                 f"got {sp.k}")
            if sp.verify_impl not in ("auto", "scan", "chunk"):
                raise ValueError(f"SpecConfig.verify_impl "
                                 f"{sp.verify_impl!r}: auto | scan | chunk")
            if sp.verify_impl == "chunk" and self._quant_kv:
                raise ValueError(
                    "SpecConfig.verify_impl='chunk' requires float32 KV "
                    "pages (the int8 page write is per position; the scan "
                    "verify handles kv_dtype='int8')")
            if sp.draft_window is not None and int(sp.draft_window) < 1:
                raise ValueError(f"SpecConfig.draft_window must be None or "
                                 f">= 1, got {sp.draft_window}")
            self._draft_model = adapter.build_draft(sp)
            self._dr_k = torch.zeros(shape, dtype=torch.float32,
                                     device=self.device)
            self._dr_v = torch.zeros_like(self._dr_k)
        self._base_key = prng.PRNGKey(cfg.base_seed, device=self.device)
        # host-side slot boards (numpy; packed into each call's inputs)
        S = cfg.slots
        self._page_table = np.zeros((S, cfg.pages_per_slot), np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._last_tokens = np.zeros((S,), np.int32)
        self._active_mask = np.zeros((S,), bool)
        self._seeds = np.zeros((S,), np.int32)
        self._temps = np.zeros((S,), np.float32)
        self._top_ks = np.zeros((S,), np.int32)
        self._top_ps = np.ones((S,), np.float32)
        self._slots: List[Optional[_ActiveSeq]] = [None] * S
        self._free_pages: List[int] = list(range(cfg.total_pages))
        self._reserved_pages = 0
        # the closed program set and its graphs
        self._programs = self._build_programs()
        self._marks = _Marks(3, self.device)
        self._graphs: Dict[Tuple[str, int, bool], _Graph] = {}
        # the compute dtype the graphs were captured in: a call in
        # another raises (check_compute_dtype)
        self.graph_dtype: Optional[torch.dtype] = None
        # calls by (program, bucket, sampled), graphs or not
        self.calls: Counter = Counter()
        self._graph_pool = None
        self._side: Optional[torch.cuda.Stream] = None
        self._warming = False
        self.warmup_s = 0.0
        # work queue: (deadline_t, seq, req)
        self._heap: List[Tuple[float, int, DecodeRequest]] = []
        self._seq = itertools.count(1)
        self._wave_steps = 0     # continuous=False: steps into the wave
        self._wave_horizon = cfg.max_new_tokens
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # cross-thread cancellation: rid -> reason, swept on the engine
        # thread; _iter_lock serialises one engine iteration (and warmup)
        self._cancelled: Dict[str, str] = {}
        self._iter_lock = threading.Lock()
        # callers off the engine thread waiting for _iter_lock: the loop
        # yields it at its next iteration edge (a lock is not fair, and
        # the loop would take it back at once)
        self._iter_waiting = 0
        # scheduling events ("admit", "prefill_chunk", "decode_step",
        # "spec_step", "cancel", "expire", "release", ...), also dumped by
        # the flight recorder (weakref'd: a collected engine is pruned)
        self.events: deque = deque(maxlen=512)
        flight.register_dump_source(
            f"decode_engine:{name}:{id(self):x}", self._ring_snapshot)
        self._tokens_window: deque = deque(maxlen=256)   # (t, n)
        self._accept_window: deque = deque(maxlen=256)   # (t, acc, judged)
        self._gauge_t = 0.0
        self._last_step_t = 0.0
        self.stats = {"requests": 0, "completed": 0, "expired": 0,
                      "tokens": 0, "steps": 0, "prefill_chunks": 0,
                      "prefill_calls": 0, "rejected": 0, "kv_exports": 0,
                      "kv_imports": 0, "cancelled": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_rejected": 0}
        self.metrics.describe(
            "serving.decode.tokens_per_s",
            "generated tokens/s over the recent step window")

    def kv_bytes_per_page(self) -> int:
        """Device bytes one page row costs across every layer's K and V
        pool in the stored type, plus for int8 the two float32 scales
        per (layer, page), plus for speculation the float32 draft row."""
        a = self.adapter
        elems = a.num_layers * a.num_heads * self.cfg.page_size * a.head_dim
        itemsize = 1 if self._quant_kv else 4
        scale_bytes = 2 * a.num_layers * 4 if self._quant_kv else 0
        draft_bytes = 2 * elems * 4 if self._spec is not None else 0
        return 2 * elems * itemsize + scale_bytes + draft_bytes

    # -- client side --------------------------------------------------------
    def submit(self, req: DecodeRequest) -> DecodeRequest:
        return self.submit_many([req])[0]

    def submit_many(self, reqs: Sequence[DecodeRequest]
                    ) -> List[DecodeRequest]:
        """Queue ``reqs`` together: the engine admits none of them before
        all are queued, so the requests of one call are scheduled as one
        batch (the same schedule, and so the same bits, from run to
        run).  A full queue refuses the whole batch."""
        if self._stop.is_set():
            raise RuntimeError("decode engine stopped")
        for req in reqs:
            prompt = np.asarray(req.tokens, np.int32).reshape(-1)
            if len(prompt) == 0:
                raise ValueError("empty prompt: a generate request needs "
                                 "at least one input token")
            if getattr(self.adapter, "bos_id", None) is None \
                    and len(prompt) >= self.cfg.cap:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens exceeds the cache cap "
                    f"{self.cfg.cap} (page_size * pages_per_slot)")
            if req.handoff is not None or req.export_kv:
                self._validate_fleet_request(req, prompt)
        now = time.time()
        for req in reqs:
            req.admit_t = now
            req.rid = req.rid or f"{self.name}-{next(self._seq)}"
        with self._cv:
            if len(self._heap) + len(reqs) > self.cfg.queue_capacity:
                self.stats["rejected"] += len(reqs)
                raise RuntimeError("decode queue full")
            for req in reqs:
                req.seq = next(self._seq)
                heapq.heappush(self._heap, (req.deadline_t, req.seq, req))
            self._cv.notify_all()
        self._ensure_thread()
        return list(reqs)

    def generate(self, prompts, **kw) -> List[DecodeResult]:
        """Synchronous helper: submit every prompt, wait for all."""
        reqs = self.submit_many([DecodeRequest(tokens=np.asarray(p), **kw)
                                 for p in prompts])
        return [r.wait(timeout=300.0) for r in reqs]

    def submit_prefilled(self, handoff: dict, **kw) -> DecodeRequest:
        """Admit a request whose prefill ran on another engine:
        ``handoff`` is the dict ``fleet.handoff.unpack_handoff`` returns
        (the prompt tokens, the first generated token and its log-prob,
        the prompt's page images).  The sampling parameters and seed
        default to the handoff's own; ``kw`` overrides ride through to
        :class:`DecodeRequest` (``max_new_tokens``, ``rid``,
        ``on_token``, ``deadline_t`` ...)."""
        meta = {k: handoff[k]
                for k in ("temperature", "top_k", "top_p", "seed")
                if k in handoff}
        meta.update(kw)
        return self.submit(DecodeRequest(
            tokens=np.asarray(handoff["tokens"], np.int32), handoff=handoff,
            **meta))

    def _validate_fleet_request(self, req: DecodeRequest,
                                prompt: np.ndarray) -> None:
        """Refuse a malformed handoff or export at the door: admitted, it
        would fail on the engine thread and take the in-flight batch with
        it.  The JAX engine's checks and messages."""
        if not self.cfg.continuous:
            raise ValueError("KV handoff/export requires continuous mode")
        if self.adapter.ctx_specs():
            raise ValueError(
                "KV handoff/export supports LM adapters only (a seq2seq "
                "'prefill' is the encoder — there are no prompt KV "
                "pages to transfer)")
        if req.handoff is None:
            return
        h = req.handoff
        cfg, a = self.cfg, self.adapter
        hd_dt = str(h.get("kv_dtype", "float32"))
        if hd_dt != cfg.kv_dtype:
            raise ValueError(
                f"handoff kv_dtype {hd_dt!r} does not match this "
                f"engine's kv_dtype {cfg.kv_dtype!r}; refusing the "
                "page import (re-prefill instead)")
        n = -(-len(prompt) // cfg.page_size)
        want = (a.num_layers, n, a.num_heads, cfg.page_size, a.head_dim)
        k = np.asarray(h.get("k"))
        v = np.asarray(h.get("v"))
        if k.shape != want or v.shape != want:
            raise ValueError(f"handoff K/V shape {k.shape} does not "
                             f"match engine geometry {want}")
        if self._quant_kv:
            ks = np.asarray(h.get("k_scales"))
            vs = np.asarray(h.get("v_scales"))
            if ks.shape != (a.num_layers, n) \
                    or vs.shape != (a.num_layers, n):
                raise ValueError(
                    f"int8 handoff scale shape {ks.shape} does not "
                    f"match (layers, pages) {(a.num_layers, n)}")
        toks = np.asarray(h.get("tokens"), np.int32).reshape(-1)
        if not np.array_equal(toks, prompt):
            raise ValueError("handoff prompt tokens do not match the "
                             "request's tokens")

    @contextmanager
    def _between_iterations(self):
        """``_iter_lock`` for a caller off the engine thread, taken at
        the loop's next iteration edge."""
        with self._cv:
            self._iter_waiting += 1
        try:
            self._iter_lock.acquire()
        finally:
            with self._cv:
                self._iter_waiting -= 1
        try:
            yield
        finally:
            self._iter_lock.release()

    def _ring_snapshot(self) -> dict:
        """The scheduling ring and the stats as one flight-dump line."""
        return {"engine": self.name,
                "events": [list(e) for e in list(self.events)],
                "stats": dict(self.stats)}

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._heap)

    def active_slots(self) -> int:
        return int(self._active_mask.sum())

    def decode_pressure(self) -> Dict[str, Any]:
        """Admission-pressure snapshot for the fleet router: free slots,
        reservable pages, the prefill backlog (prefilling slots + queued
        requests), the handoffs exported and imported, and the prefix
        cache's counters, with the JAX engine's keys.  Read from any
        thread: a torn read across fields skews a score, never
        correctness."""
        queued = self.queue_depth()
        slots = list(self._slots)
        out = {
            "total_slots": self.cfg.slots,
            "free_slots": sum(s is None for s in slots),
            "total_pages": self.cfg.total_pages,
            "free_pages": max(len(self._free_pages)
                              - self._reserved_pages, 0),
            "queued": queued,
            "prefill_backlog": queued + sum(
                1 for s in slots if s is not None and s.prefilling),
            "active": int(self._active_mask.sum()),
            "kv_exports": self.stats["kv_exports"],
            "kv_imports": self.stats["kv_imports"],
            "page_dtype": self.cfg.kv_dtype,
            "kv_bytes_per_page": self.kv_bytes_per_page(),
            "speculative": self._spec is not None,
            "spec_k": int(self._spec.k) if self._spec is not None else 0,
        }
        if self._prefix_cache is not None:
            out["prefix_cache"] = self._prefix_cache.stats()
        return out

    def cancel(self, rid: str, reason: str = "cancelled") -> None:
        """Cancel a queued or in-flight request from any thread.  The
        engine thread sweeps the mark before its next iteration: a queued
        request leaves the heap, an active slot frees its target and
        draft pages at once and its row is inactive in the next call.
        An unknown rid is a no-op (the request may have just finished)."""
        with self._cv:
            self._cancelled[rid] = reason
            self._cv.notify_all()

    def migrate_live_slots(self) -> Tuple[List[dict], List[str], List[str]]:
        """Freeze and export every migratable live slot: under
        ``_iter_lock`` (so no token is emitted after its slot's state
        left), each eligible slot's written pages and sampling state are
        copied into a handoff dict another engine imports with
        :meth:`submit_prefilled`, and the slot stops decoding.  The
        caller ships the handoffs, then evicts the frozen rids with
        :meth:`cancel` (``reason="migrated"``).

        A handoff is shaped as a fresh prefill of ``prompt +
        generated[:-1]`` would export it: ``lengths[s]`` cache positions
        are written and the pending last token travels as
        ``first_token``.  Sampling keys are counter-based at absolute
        positions, so the importing engine continues as the slot would
        have.  Returns ``(exports, frozen_rids, leftover_rids)``: the
        leftovers are live slots that cannot move (still prefilling, no
        token yet, an export request, a seq2seq slot) and the queued
        requests; the caller evicts those too."""
        exports: List[dict] = []
        frozen: List[str] = []
        leftover: List[str] = []
        cfg = self.cfg
        if not cfg.continuous:
            return exports, frozen, leftover
        with self._between_iterations(), DEVICE_GATE.work(self.device):
            for s, seq in enumerate(self._slots):
                if seq is None or seq.done or seq.frozen:
                    continue
                req = seq.req
                if (seq.ctx or seq.prefilling or not seq.generated
                        or req.export_kv):
                    leftover.append(req.rid)
                    continue
                n = -(-int(self._lengths[s]) // cfg.page_size)
                export = {
                    "tokens": np.concatenate([
                        np.asarray(seq.prompt, np.int32),
                        np.asarray(seq.generated[:-1], np.int32)]),
                    "first_token": int(seq.generated[-1]),
                    "first_logp": float(seq.last_logp),
                    "temperature": float(req.temperature),
                    "top_k": int(req.top_k),
                    "top_p": float(req.top_p),
                    "seed": int(req.seed),
                    "request_id": req.rid,
                    "migrated": True,
                    "resume_len": len(seq.generated),
                    "kv_dtype": cfg.kv_dtype,
                    **self._export_pages(self._page_table[s, :n])}
                exports.append(export)
                seq.frozen = True
                self._active_mask[s] = False
                frozen.append(req.rid)
                self.stats["kv_exports"] += 1
                self.metrics.inc("serving.fleet.kv_exports")
                self.events.append(("kv_export", req.rid, int(n)))
            with self._cv:
                leftover.extend(r.rid for _, _, r in self._heap)
        return exports, frozen, leftover

    def _export_pages(self, pids) -> Dict[str, np.ndarray]:
        """Host copies of the pages ``pids`` in their stored type, (L, n,
        h, page, hd) K and V, and for int8 their (L, n) scales: a copy on
        the engine thread between calls."""
        if (np.asarray(pids) == self._sink).any():
            raise AssertionError("the sink page is never exported")
        ids = torch.from_numpy(np.asarray(pids, np.int64)).to(self.device)
        out = {"k": self._kv_k[:, ids].cpu().numpy(),
               "v": self._kv_v[:, ids].cpu().numpy()}
        if self._quant_kv:
            out["k_scales"] = self._kv_sk[:, ids].cpu().numpy()
            out["v_scales"] = self._kv_sv[:, ids].cpu().numpy()
        return out

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

    def closed_set(self) -> List[Tuple[str, int, bool]]:
        """Every (program, cache bucket, sampled) the engine can call:
        the decode step (the speculative iteration in its place under
        speculation, where the plain step never runs) and the prefill
        call, greedy and sampled, for every bucket."""
        names = ("spec" if self._spec is not None else "step", "prefill")
        return [(name, nb, sampled) for nb in self.cfg.len_buckets()
                for sampled in (False, True) for name in names]

    def warmup(self) -> "DecodeEngine":
        """The closed program set before traffic.  With graphs on, each
        program of :meth:`closed_set` runs once eagerly on idle rows on a
        side stream and is captured (``serving.decode.graph_captures``);
        a capture after warmup counts as
        ``serving.decode.unexpected_captures``.  Eagerly, each runs once
        on idle rows (the kernels built, the libraries initialised).
        Idle rows write only the sink pages.  An adapter's encoder
        (``warmup_buckets``) runs once at each source bucket first."""
        t0 = time.perf_counter()
        with self._between_iterations(), DEVICE_GATE.work(self.device):
            self._warming = True
            try:
                if hasattr(self.adapter, "warmup_buckets"):
                    self.adapter.warmup_buckets()
                for key in self.closed_set():
                    if not self._graphs_on:
                        prog = self._programs[key[0]]
                        prog.dev_in.copy_(prog.idle)
                        with torch.no_grad():
                            prog.run(key[1], key[2])
                    elif key not in self._graphs:
                        self._capture(key)
            finally:
                self._warming = False
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        return self

    def check_compute_dtype(self) -> None:
        """Raise if the compute dtype (``tensor.policy``) is not the one
        the engine's graphs were captured in: a graph replays the
        products it captured, so a later dtype would not reach them."""
        dt = get_compute_dtype(self.device)
        if self.graph_dtype is not None and dt != self.graph_dtype:
            raise RuntimeError(
                f"the decode engine's CUDA graphs were captured in compute "
                f"dtype {self.graph_dtype} and a call runs in {dt}: serve "
                f"each dtype from an engine warmed up in it")

    @property
    def graphs_captured(self) -> int:
        return len(self._graphs)

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes the graphs' shared memory pool holds (the
        allocator's segments of that pool), or None without graphs."""
        if self._graph_pool is None:
            return None
        pool = tuple(self._graph_pool)
        segs = torch.cuda.memory._snapshot()["segments"]
        return int(sum(s["total_size"] for s in segs
                       if tuple(s.get("segment_pool_id", ())) == pool))

    # -- the programs -------------------------------------------------------
    def _fresh_width(self) -> int:
        """Pages one call can pop off the free list (the int8 scales that
        call resets): a decode step one a slot, a speculative iteration
        the pages k+1 positions reach a slot, a prefill call the pages a
        chunk reaches a row."""
        cfg = self.cfg
        page = cfg.page_size
        per_slot = 1 if self._spec is None \
            else cdiv(self._spec.k + 1, page) + 1
        n = max(cfg.slots * per_slot,
                cfg.prefill_batch * (cdiv(cfg.prompt_chunk, page) + 1))
        return min(n, cfg.total_pages)

    def _build_programs(self) -> Dict[str, _Program]:
        cfg = self.cfg
        S, B, W = cfg.slots, cfg.prefill_batch, cfg.pages_per_slot
        F = self._fresh_width()

        def boards(n):
            return [("seeds", (n,), "int32"), ("temps", (n,), "float32"),
                    ("top_ks", (n,), "int32"), ("top_ps", (n,), "float32")]

        decode_in = [("pt", (S, W), "int32"), ("lengths", (S,), "int32"),
                     ("last", (S,), "int32"), ("active", (S,), "int32"),
                     *boards(S), ("fresh", (F,), "int32")]
        progs = {
            "step": _Program(self._step_program, decode_in,
                             [("tok", (S,), "int32"),
                              ("logp", (S,), "float32")],
                             self._sink, self.device),
            "prefill": _Program(
                self._prefill_program,
                [("pt", (B, W), "int32"),
                 ("tokens", (B, cfg.prompt_chunk), "int32"),
                 ("position", (B,), "int32"), ("last_index", (B,), "int32"),
                 ("active", (B,), "int32"), *boards(B),
                 ("slot_idx", (B,), "int32"), ("fresh", (F,), "int32")],
                [("tok", (B,), "int32"), ("logp", (B,), "float32")],
                self._sink, self.device)}
        if self._spec is not None:
            C = self._spec.k + 1
            progs["spec"] = _Program(
                self._spec_program, decode_in,
                [("d_toks", (S, C), "int32"), ("g_toks", (S, C), "int32"),
                 ("g_logps", (S, C), "float32")], self._sink, self.device)
        return progs

    def _sampling(self, x, sampled: bool) -> _Sampling:
        return _Sampling(x["seeds"], x["temps"], x["top_ks"], x["top_ps"],
                         sampled)

    def _reset_scales(self, fresh) -> None:
        """Zero the int8 scales of the pages just popped off the free
        list (the fixed-width ``fresh`` ids, padded with the sink) before
        the call reads them: a reused page would otherwise dequantize its
        last owner's payload under its last owner's scale."""
        if self._quant_kv:
            ids = fresh.long()
            self._kv_sk.index_fill_(1, ids, 0.0)
            self._kv_sv.index_fill_(1, ids, 0.0)

    def _step_program(self, n_blocks, sampled, x):
        """One decode step for every slot: write each active slot's new
        K/V at position ``lengths`` and select its next token.  Returns
        (tokens, log-probs) over all slots."""
        self._reset_scales(x["fresh"])
        pos = x["lengths"].long()
        with self.adapter.weights():
            logits = self._decode_body(n_blocks, x["pt"], pos,
                                       x["last"].long()[:, None],
                                       x["active"].bool(), self._ctx_bufs)
            return self._sampling(x, sampled).select(logits, self._base_key,
                                                     pos + 1)

    def _prefill_program(self, n_blocks, sampled, x):
        """Prefill one chunk for up to ``prefill_batch`` rows in one
        call: attend over the pages written so far, write every active
        row's chunk K/V into its pages, and select the FIRST generated
        token at ``last_index`` (meaningful for rows on their final
        chunk).  Each row reads the context of its slot ``slot_idx``.
        With speculation the draft twin consumes the same chunk into its
        own pool.  Returns (tokens, log-probs)."""
        self._reset_scales(x["fresh"])
        a = self.adapter
        pt_rows = x["pt"]
        pt = pt_rows[:, :n_blocks].long()
        tok_t = x["tokens"].long()
        pos_t = x["position"].long()
        li = x["last_index"].long()
        active = x["active"].bool()
        with a.weights():
            if self._quant_kv:
                kbuf = self._gather(self._kv_k, pt, self._kv_sk)
                vbuf = self._gather(self._kv_v, pt, self._kv_sv)
            else:
                kbuf = self._gather(self._kv_k, pt)
                vbuf = self._gather(self._kv_v, pt)
            rows = x["slot_idx"].long()
            ctx = {k: v[rows] for k, v in self._ctx_bufs.items()}
            logits, _, _, k_new, v_new = a.chunk_forward(tok_t, pos_t, kbuf,
                                                         vbuf, ctx=ctx)
            B = logits.shape[0]
            last = logits[torch.arange(B, device=self.device), li]  # (B, V)
            tok, logp = self._sampling(x, sampled).select(
                last, self._base_key, pos_t + li + 1)
            if self._quant_kv:
                self._write_back_int8(kbuf, vbuf, pt, pos_t, active)
            else:
                self._write_chunk_pages(self._kv_k, self._kv_v, k_new, v_new,
                                        pt_rows, pos_t, active)
            if self._spec is not None:
                self._draft_prefill(pt, tok_t, pos_t, pt_rows, active)
        return tok, logp

    def _spec_program(self, n_blocks, sampled, x):
        """One speculative iteration on the device: the draft's k+1
        steps, then ONE target verify of the chunk built from the drafts
        (they never leave the device).  Any sampled row routes the verify
        to its scan form.  Returns the drafts and the target's tokens and
        log-probs, (S, k+1) each."""
        self._reset_scales(x["fresh"])
        pos = x["lengths"].long()
        last = x["last"].long()
        active = x["active"].bool()
        sampling = self._sampling(x, sampled)
        self._marks.mark(0)
        with self.adapter.weights():
            d_toks = self._draft(n_blocks, x["pt"], pos, last, active,
                                 sampling)
            self._marks.mark(1)
            g_toks, g_logps = self._verify(n_blocks, x["pt"], pos, last,
                                           d_toks, active, sampling,
                                           force_scan=sampled)
        self._marks.mark(2)
        return d_toks, g_toks, g_logps

    # -- device math --------------------------------------------------------
    def _gather(self, kv, pt, sc=None):
        """(L, P+1, h, page, hd)[pages pt (B, nb)] -> (B+1, L, h,
        nb*page, hd): each row's pages as one contiguous cache (each page
        times its (layer, page) scale for an int8 pool ``sc``; a fresh
        page has scale 0, so its stale payload reads as zeros), and a
        sink row B for :func:`_write_chunk`."""
        g = kv[:, pt]                       # (L, B, nb, h, page, hd)
        if sc is not None:
            g = g.float() * sc[:, pt][..., None, None, None]
        L, B, nb, h, page, hd = g.shape
        out = g.new_empty((B + 1, L, h, nb * page, hd))
        out[:B].view(B, L, h, nb, page, hd).copy_(g.permute(1, 0, 3, 2, 4, 5))
        return out

    def _use_flash(self) -> bool:
        if self.cfg.use_flash_decode is not None:
            return bool(self.cfg.use_flash_decode)
        return self.device.type == "cuda"

    def _page_ids(self, pt_full, pos, ok):
        """The page id holding each position ``pos`` (any shape, rows
        first) in ``pt_full`` (rows, pages_per_slot), the sink where
        ``ok`` is False."""
        cfg = self.cfg
        j = (pos // cfg.page_size).clamp(max=cfg.pages_per_slot - 1)
        pid = pt_full.long().gather(1, j.reshape(j.shape[0], -1))
        return torch.where(ok, pid.reshape(pos.shape), self._sink)

    def _write_chunk_pages(self, pool_k, pool_v, k_new, v_new, pt_rows,
                           start, active) -> None:
        """Write a chunk's fresh K/V, (B, L, h, C, hd) for positions
        ``start .. start+C-1`` of each row, into float32 pools in place;
        positions of inactive rows or past the cap go to the sink
        (padded prompt tails inside the cap are written, as the JAX
        engine writes them)."""
        C = k_new.shape[3]
        pos_c = start[:, None] + torch.arange(C, device=self.device)[None, :]
        ok = active[:, None] & (pos_c < self.cfg.cap)
        pid = self._page_ids(pt_rows, pos_c, ok)
        off = pos_c % self.cfg.page_size
        # (L, P+1, h, page, hd)[:, pid, :, off] <- (B, C, L, h, hd)
        pool_k[:, pid, :, off] = k_new.permute(0, 3, 1, 2, 4).to(pool_k.dtype)
        pool_v[:, pid, :, off] = v_new.permute(0, 3, 1, 2, 4).to(pool_v.dtype)

    def _write_back_int8(self, kbuf, vbuf, pt, position, active) -> None:
        """Requantize and write back the int8 pages a prefill chunk
        touched: a fixed ``ceil(prompt_chunk / page_size) + 1`` pages a
        row from ``position // page_size`` on, a page past the row's
        reach (or an inactive row's) sent to the sink.  Table rows past a
        slot's allocation may name pages other slots own now, so only
        the reach is written.  Untouched positions of a touched page came
        from the dequantized gather, so under the monotone scale floor
        they requantize exactly."""
        cfg = self.cfg
        page, C = cfg.page_size, cfg.prompt_chunk
        B, n_blocks = pt.shape
        dev = self.device
        j = (position // page)[:, None] \
            + torch.arange(cdiv(C, page) + 1, device=dev)[None, :]
        lim = torch.clamp(position + C, max=cfg.cap)[:, None]
        ok = active[:, None] & (j * page < lim) & (j < n_blocks)
        jc = j.clamp(max=n_blocks - 1)
        pid = torch.where(ok, pt.gather(1, jc), self._sink)      # (B, TP)
        cols = jc[:, :, None] * page + torch.arange(page, device=dev)
        rows = torch.arange(B, device=dev)[:, None, None]
        for buf, pool, scales in ((kbuf, self._kv_k, self._kv_sk),
                                  (vbuf, self._kv_v, self._kv_sv)):
            # (B, TP, page, L, h, hd) -> (L, B, TP, h, page, hd)
            pages = buf[rows, :, :, cols].permute(3, 0, 1, 4, 2, 5)
            q, sc = quantize_pages(pages, floor_scales=scales[:, pid])
            pool[:, pid] = q
            scales[:, pid] = sc

    def _decode_body(self, n_blocks, pt_full, pos, tokens, active, ctx=None):
        """One decode-step body: ``tokens`` (S, 1) int64 sit at positions
        ``pos`` (S,) int64, each row reading its slot's context ``ctx``.  Writes every row's K/V at its position into
        the pool — an inactive row's, or one at the cap, into the sink —
        then attends (a row at the cap still attends); returns the
        logits (S, V).  With int8 pages the write is a read-modify-write
        of the one page it lands in: dequantize, insert the row,
        requantize under the page's monotone scale floor (the untouched
        positions requantize exactly)."""
        cfg = self.cfg
        adapter = self.adapter
        pt = pt_full[:, :n_blocks]          # row-strided view
        len32 = pos.int()
        # write target of this step's K/V: the page holding the position
        wid = self._page_ids(pt_full, pos, active & (pos < cfg.cap))
        off = pos % cfg.page_size
        use_flash = self._use_flash()
        if self._quant_kv:
            rows = torch.arange(pos.shape[0], device=self.device)

            def rmw(pool, scales, i, new):
                floor = scales[i, wid]
                pg = pool[i, wid].float() * floor[:, None, None, None]
                pg[rows, :, off] = new[:, :, 0]
                q, sc = quantize_pages(pg, floor_scales=floor)
                pool[i, wid] = q
                scales[i, wid] = sc

            def self_attend(i, q, k_new, v_new):
                rmw(self._kv_k, self._kv_sk, i, k_new)
                rmw(self._kv_v, self._kv_sv, i, v_new)
                if use_flash:
                    out = paged_decode_attention(
                        q[:, :, 0].contiguous(), self._kv_k[i],
                        self._kv_v[i], pt, len32, k_scales=self._kv_sk[i],
                        v_scales=self._kv_sv[i])
                    return out[:, :, None]
                # gathered path: dequantize this layer's pages and attend
                # over the contiguous view
                ptl = pt.long()
                kb = _gather_pages(self._kv_k[i], self._kv_sk[i], ptl)
                vb = _gather_pages(self._kv_v[i], self._kv_sv[i], ptl)
                valid = (torch.arange(kb.shape[2], device=self.device)
                         [None, :] <= pos[:, None])[:, None, :]
                return adapter._attend(q, kb, vb, valid)

            return adapter.chunk_forward(tokens, pos, None, None, ctx=ctx,
                                         self_attend=self_attend)[0][:, 0]
        if use_flash:
            def self_attend(i, q, k_new, v_new):
                # write this layer's K/V into the pages FIRST, then run
                # the single-query kernel straight off the page pool
                kp, vp = self._kv_k[i], self._kv_v[i]
                kp[wid, :, off] = k_new[:, :, 0]
                vp[wid, :, off] = v_new[:, :, 0]
                out = paged_decode_attention(q[:, :, 0].contiguous(), kp, vp,
                                             pt, len32)
                return out[:, :, None]

            return adapter.chunk_forward(tokens, pos, None, None, ctx=ctx,
                                         self_attend=self_attend)[0][:, 0]
        pt64 = pt.long()
        kbuf = self._gather(self._kv_k, pt64)
        vbuf = self._gather(self._kv_v, pt64)
        logits, _, _, k_new, v_new = adapter.chunk_forward(tokens, pos, kbuf,
                                                           vbuf, ctx=ctx)
        self._kv_k[:, wid, :, off] = k_new[:, :, :, 0]
        self._kv_v[:, wid, :, off] = v_new[:, :, :, 0]
        return logits[:, 0]

    def _draft_prefill(self, pt, tok_t, pos_t, pt_rows, active):
        """The draft twin consumes a prefill chunk, so its pool holds the
        prompt position for position before its first draft step (no
        token is selected: the first generated token is the target's)."""
        kbuf = self._gather(self._dr_k, pt)
        vbuf = self._gather(self._dr_v, pt)
        _, _, _, k_new, v_new = self.adapter.chunk_forward(
            tok_t, pos_t, kbuf, vbuf, model=self._draft_model)
        self._write_chunk_pages(self._dr_k, self._dr_v, k_new, v_new,
                                pt_rows, pos_t, active)

    def _draft(self, n_blocks, pt_full, pos, last, active,
               sampling: _Sampling):
        """Draft ``k+1`` tokens per slot with the sparse twin: ``k+1``
        single-token steps over the gathered float32 draft cache (the
        extra step writes the draft K/V at ``lengths+k`` that a fully
        accepted chunk's bonus token needs next iteration), then the
        chunk's K/V go into the draft pool.  Selection uses the verify's
        keys and positions, so a close draft samples the target's token.

        With ``SpecConfig.draft_window=W`` and a bucket wider than W the
        steps carry a RING of the last W positions' draft K/V instead of
        the gathered cache (:meth:`_draft_ring`).  Returns the drafted
        tokens (S, k+1) on the device."""
        pt = pt_full[:, :n_blocks].long()
        W = self._spec.draft_window
        ring = None
        if W is not None and int(W) < n_blocks * self.cfg.page_size:
            ring = self._draft_ring(int(W), pt, pos)
        else:
            kbuf = self._gather(self._dr_k, pt)
            vbuf = self._gather(self._dr_v, pt)
        p = pos
        toks, k_news, v_news = [], [], []
        for _ in range(self._spec.k + 1):
            if ring is not None:
                logits, _, _, k_new, v_new = self.adapter.chunk_forward(
                    last[:, None], p, None, None, model=self._draft_model,
                    self_attend=ring(p))
            else:
                logits, kbuf, vbuf, k_new, v_new = \
                    self.adapter.chunk_forward(last[:, None], p, kbuf, vbuf,
                                               model=self._draft_model)
            last, _ = sampling.select(logits[:, 0], self._base_key, p + 1)
            toks.append(last)
            k_news.append(k_new)
            v_news.append(v_new)
            p = p + 1
        self._write_chunk_pages(self._dr_k, self._dr_v, torch.cat(k_news, 3),
                                torch.cat(v_news, 3), pt_full, pos, active)
        return torch.stack(toks, 1)

    def _draft_ring(self, W: int, pt, lengths):
        """The draft's attention window: ring slot ``j`` starts with the
        last cached position congruent to ``j`` mod ``W`` (a negative
        position is not cached yet and stays masked), read from the draft
        pool through the page table ``pt`` (S, nb).  Returns
        ``ring(pos)``, the ``self_attend`` hook of the step at positions
        ``pos``: it writes each layer's new K/V into slot ``pos % W`` and
        attends the whole ring under a ``q >= 0`` mask.  The JAX engine's
        ring, op for op."""
        cfg = self.cfg
        page, nb = cfg.page_size, pt.shape[1]
        span = torch.arange(W, device=self.device)
        last = (lengths - 1)[:, None]
        q_seed = last - (last - span) % W                         # (S, W)
        cell = q_seed.clamp(0, cfg.cap - 1)
        pid = pt.gather(1, (cell // page).clamp(0, nb - 1))
        off = cell % page
        # (L, P+1, h, page, hd)[:, pid, :, off] -> (S, W, L, h, hd)
        rk = self._dr_k[:, pid, :, off].permute(2, 0, 3, 1, 4).contiguous()
        rv = self._dr_v[:, pid, :, off].permute(2, 0, 3, 1, 4).contiguous()
        rows = torch.arange(pt.shape[0], device=self.device)

        def ring(pos):
            slot = pos % W
            q_j = pos[:, None] - (pos[:, None] - span) % W
            ok = (q_j >= 0)[:, None, :]                          # (S, 1, W)

            def self_attend(i, q, k_new, v_new):
                rk[i][rows, :, slot] = k_new[:, :, 0]
                rv[i][rows, :, slot] = v_new[:, :, 0]
                return self.adapter._attend(q, rk[i], rv[i], ok)

            return self_attend

        return ring

    def _verify(self, n_blocks, pt_full, pos, last, d_toks, active,
                sampling: _Sampling, force_scan: bool):
        """ONE target call scoring the chunk ``[last_token, d_0 ..
        d_{k-1}]`` at positions ``lengths .. lengths+k``; returns the
        target's selections and log-probs (S, k+1) for positions
        ``lengths+1 .. lengths+k+1``.  The chunk row is built on the
        device from the draft's output, so nothing waits for the draft.

        Two forms (``SpecConfig.verify_impl``): **scan**, k+1 decode-step
        bodies (the int8 pages' form, and any iteration with a sampled
        slot); **chunk**, the chunk's K/V written into the pages and all
        k+1 queries attended in one ``paged_verify_attention`` call per
        layer."""
        C = self._spec.k + 1
        impl = self._spec.verify_impl
        chunk_mode = (not self._quant_kv and not force_scan and (
            self._use_flash() if impl == "auto" else impl == "chunk"))
        tokens = torch.cat([last[:, None], d_toks[:, :C - 1]], dim=1)
        if not chunk_mode:
            toks, logps = [], []
            for j in range(C):
                logits = self._decode_body(n_blocks, pt_full, pos + j,
                                           tokens[:, j:j + 1], active)
                t, lp = sampling.select(logits, self._base_key, pos + j + 1)
                toks.append(t)
                logps.append(lp)
            return torch.stack(toks, 1), torch.stack(logps, 1)
        S = tokens.shape[0]
        pt = pt_full[:, :n_blocks]
        len32 = pos.int()
        pos_c = pos[:, None] + torch.arange(C, device=self.device)[None, :]
        pid = self._page_ids(pt_full, pos_c,
                             active[:, None] & (pos_c < self.cfg.cap))
        off = pos_c % self.cfg.page_size

        def self_attend(i, q, k_new, v_new):
            # the chunk's K/V into the pages first, then all C queries
            self._kv_k[i][pid, :, off] = k_new.permute(0, 2, 1, 3)
            self._kv_v[i][pid, :, off] = v_new.permute(0, 2, 1, 3)
            return paged_verify_attention(q.contiguous(), self._kv_k[i],
                                          self._kv_v[i], pt, len32)

        logits = self.adapter.chunk_forward(tokens, pos, None, None,
                                            self_attend=self_attend)[0]
        tok, logp = sampling.repeat(C).select(
            logits.reshape(S * C, -1), self._base_key,
            (pos_c + 1).reshape(-1))
        return tok.reshape(S, C), logp.reshape(S, C)

    # -- calls --------------------------------------------------------------
    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._side

    def _capture(self, key) -> _Graph:
        """Capture one program of the closed set on idle inputs into a
        CUDA graph in the engine's shared memory pool, after
        ``WARM_RUNS`` eager runs on idle rows on the capture's side
        stream.  A synchronizing call inside the program raises
        (``set_sync_debug_mode("error")``) before it reaches the card,
        so the capture ends cleanly and the error names the call;
        nothing runs eagerly in its place.  The capture holds
        ``ops.common.DEVICE_GATE`` alone, so a server's other threads
        hold their card work off until it ends, and it runs in
        ``capture_error_mode="thread_local"``."""
        name = key[0]
        self.check_compute_dtype()
        if self.graph_dtype is None:
            self.graph_dtype = get_compute_dtype(self.device)
        prog = self._programs[name]
        w8 = self.adapter._w8
        if w8 is not None and w8.held_here():
            raise RuntimeError(
                "a decode program cannot be captured inside an open "
                "weights() view: the graph would read float32 weights "
                "freed when the view closes; capture (warmup) outside it")
        with DEVICE_GATE.capture():
            return self._capture_alone(key, prog)

    def _capture_alone(self, key, prog) -> _Graph:
        """:meth:`_capture` while no other thread works on the card."""
        name, n_blocks, sampled = key
        side = self._side_stream()
        cur = torch.cuda.current_stream(self.device)
        prog.dev_in.copy_(prog.idle)
        side.wait_stream(cur)
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(self.WARM_RUNS):
                    prog.run(n_blocks, sampled)
            graph = torch.cuda.CUDAGraph()
            mode = torch.cuda.get_sync_debug_mode()
            with captured_launches() as launches:
                try:
                    # entering the capture synchronizes: the mode goes on
                    # inside it
                    with torch.cuda.graph(graph, pool=self._graph_pool,
                                          stream=side,
                                          capture_error_mode="thread_local"):
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            prog.run(n_blocks, sampled)
                        finally:
                            torch.cuda.set_sync_debug_mode(mode)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"the decode engine's {name} program (bucket "
                        f"{n_blocks} pages, "
                        f"{'sampled' if sampled else 'greedy'}) cannot be "
                        f"captured as a CUDA graph: {e}.  A program that "
                        f"reads the card on the host (.item(), .cpu(), "
                        f"bool of a tensor, a Python value copied to the "
                        f"card, a mask of data-dependent shape) cannot be "
                        f"replayed; serve it with "
                        f"DecodeConfig(cuda_graphs=False)") from e
        cur.wait_stream(side)
        entry = self._graphs[key] = _Graph(graph, launches)
        self.metrics.inc("serving.decode.graph_captures" if self._warming
                         else "serving.decode.unexpected_captures")
        return entry

    def _call(self, name: str, n_blocks: int, sampled: bool
              ) -> Dict[str, np.ndarray]:
        """One engine call of a program whose inputs are written in its
        host image: one copy of them to the card, a replay of the
        program's graph (captured now if warmup did not, and counted as
        unexpected) or, eagerly, the program itself, then one copy of
        the outputs back, read after an event.  Returns the outputs."""
        prog = self._programs[name]
        key = (name, n_blocks, sampled)
        self.calls[key] += 1
        graph = None
        if self._graphs_on:
            self.check_compute_dtype()
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._capture(key)
        prog.dev_in.copy_(prog.host_in, non_blocking=True)
        if graph is not None:
            graph.graph.replay()
            credit_launches(graph.launches)
        else:
            with torch.no_grad():
                prog.run(n_blocks, sampled)
        prog.host_out.copy_(prog.dev_out, non_blocking=True)
        if prog.done is not None:
            prog.done.record()
            prog.done.synchronize()
        return {k: v.copy() for k, v in prog.y.items()}

    def _fill_decode(self, x) -> None:
        """The slot boards into a decode-shaped program's inputs."""
        x["pt"][:] = self._page_table
        x["lengths"][:] = self._lengths
        x["last"][:] = self._last_tokens
        x["active"][:] = self._active_mask
        x["seeds"][:] = self._seeds
        x["temps"][:] = self._temps
        x["top_ks"][:] = self._top_ks
        x["top_ps"][:] = self._top_ps
        self._fill_fresh(x)

    def _fill_fresh(self, x) -> None:
        """The pages popped off the free list since the last call into
        the call's fixed-width ``fresh`` field, padded with the sink."""
        fresh, self._fresh_pages = self._fresh_pages, []
        slot = x["fresh"]
        if len(fresh) > len(slot):
            raise RuntimeError(f"{len(fresh)} pages taken for one call, "
                               f"more than its {len(slot)} scale resets")
        slot[:] = self._sink
        slot[:len(fresh)] = fresh

    # -- engine loop --------------------------------------------------------
    def _run(self) -> None:
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else nullcontext():
            while not self._stop.is_set():
                occupied = any(s is not None for s in self._slots)
                with self._cv:
                    if not self._heap and not occupied \
                            and not self._cancelled:
                        self._cv.wait(0.2)
                        continue
                while self._iter_waiting:
                    time.sleep(0.0005)
                try:
                    with self._iter_lock, DEVICE_GATE.work(self.device):
                        now = time.time()
                        self._sweep_cancelled()
                        self._expire(now)
                        self._admit()
                        did = self._decode_step()
                        # one prefill call per token a decode iteration
                        # can emit: a speculative iteration advances a
                        # stream up to k+1 tokens, and prefilling slots
                        # keep pace
                        for _ in range(1 if self._spec is None
                                       else self._spec.k + 1):
                            pf = self._prefill_one()
                            did = pf or did
                            if not pf:
                                break
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
                    with self._iter_lock:
                        for s, seq in enumerate(self._slots):
                            if seq is not None:
                                self._finish_error(seq.req, e)
                                self._release_slot(s)

    def _sweep_cancelled(self) -> None:
        """Apply the cancellations marked since the last iteration: a
        queued request leaves the heap, an active slot is released (its
        target and draft pages at once); each gets a
        :class:`RequestCancelledError`, a stream with tokens out its
        ``partial_tokens``."""
        with self._cv:
            if not self._cancelled:
                return
            marks, self._cancelled = self._cancelled, {}
            dropped = [r for _, _, r in self._heap if r.rid in marks]
            if dropped:
                self._heap = [(d, q, r) for d, q, r in self._heap
                              if r.rid not in marks]
                heapq.heapify(self._heap)
        for req in dropped:
            self.events.append(("cancel_queued", req.rid, marks[req.rid]))
            self._count_cancel(marks[req.rid])
            self._finish_error(req, RequestCancelledError(req.rid,
                                                          marks[req.rid]))
        for s, seq in enumerate(self._slots):
            if seq is not None and seq.req.rid in marks:
                reason = marks[seq.req.rid]
                self.events.append(("cancel", seq.req.rid, s, reason))
                self._count_cancel(reason)
                err = RequestCancelledError(seq.req.rid, reason)
                if seq.generated:
                    err.partial_tokens = np.asarray(seq.generated, np.int32)
                if not seq.done:
                    self._finish_error(seq.req, err)
                self._release_slot(s)

    def _count_cancel(self, reason: str) -> None:
        self.stats["cancelled"] += 1
        self.metrics.inc("serving.decode.cancelled")
        if reason == "client_disconnect":
            self.metrics.inc("serving.decode.client_disconnects")

    def _expire(self, now: float) -> None:
        """Queued requests past their deadline are dropped at pickup;
        active slots are re-checked per token and freed at once."""
        expired_q = []
        with self._cv:
            while self._heap and self._heap[0][0] <= now:
                expired_q.append(heapq.heappop(self._heap)[2])
        for req in expired_q:
            self.events.append(("expire_queued", req.rid))
            self._finish_expired(req, now)
        for s, seq in enumerate(self._slots):
            if seq is not None and not seq.done \
                    and seq.req.deadline_t <= now:
                self.events.append(("expire", seq.req.rid, s))
                self._finish_expired(seq.req, now, seq=seq)
                self._release_slot(s)

    def _pages_needed(self, prompt_len: int, max_new: int,
                      start: int = 0) -> int:
        """Worst-case page rows the slot's page table will reference:
        the padded final prefill chunk or the full generation, capped.
        ``start`` is where prefill resumes (a prefix-cache attach): the
        chunks then run from it, so the padded final chunk can reach
        past the cold padded extent.  Under speculation an iteration
        writes up to k positions past the emitted length (draft lookahead
        and verify chunk), so the reservation grows by k."""
        cfg = self.cfg
        C = cfg.prompt_chunk
        spec_k = self._spec.k if self._spec is not None else 0
        padded_prompt = min(start + -(-(prompt_len - start) // C) * C,
                            cfg.cap)
        worst = min(max(padded_prompt, prompt_len + max_new + spec_k),
                    cfg.cap)
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
            max_new = min(req.max_new_tokens or cfg.max_new_tokens,
                          cfg.cap - 1)
            try:
                if req.prepared is None:
                    # kept on the request: a page-pressure push-back must
                    # not run the adapter's prepare (a seq2seq encoder
                    # forward) again at every iteration
                    req.prepared = self.adapter.prepare(req.tokens)
                prompt, ctx = req.prepared
            except Exception as e:  # noqa: BLE001 — this request only
                self._finish_error(req, e)
                continue
            max_new = min(max_new, cfg.cap - len(prompt))
            if max_new <= 0:
                self._finish_error(req, ValueError(
                    f"prompt of {len(prompt)} tokens leaves no room to "
                    f"generate within the cache cap {cfg.cap}"))
                continue
            cache = self._prefix_cache
            attach = None
            if cache is not None and req.handoff is None:
                attach = cache.match(prompt)
            shared = len(attach.pages) if attach is not None else 0
            attach_len = len(attach.key) if attach is not None else 0
            # owned pages only: the shared prefix rows are the cache's
            need = max(self._pages_needed(len(prompt), max_new,
                                          start=attach_len) - shared, 0)
            short = need - (len(self._free_pages) - self._reserved_pages)
            if short > 0 and cache is not None:
                # out of pages: reclaim idle cached prefixes (never a page
                # a live slot references; the entry attached here is
                # shielded)
                freed = cache.evict(short, protect=attach)
                if freed:
                    self._free_pages.extend(freed)
                    self.metrics.inc(
                        "serving.fleet.prefix_cache_evicted_pages",
                        len(freed))
            if len(self._free_pages) - self._reserved_pages < need:
                # not enough reservable pages: push back and wait for a
                # mid-flight release (ordering preserved — same key)
                with self._cv:
                    heapq.heappush(self._heap, (d, req.seq, req))
                return
            s = free[0]
            seq = _ActiveSeq(req, prompt, ctx, reserved=need,
                             max_new=max_new)
            self._reserved_pages += need
            self._slots[s] = seq
            self._lengths[s] = 0
            self._last_tokens[s] = 0
            self._active_mask[s] = False          # active once prefilled
            self._seeds[s] = np.int32(req.seed)
            self._temps[s] = np.float32(req.temperature)
            self._top_ks[s] = np.int32(req.top_k)
            self._top_ps[s] = np.float32(req.top_p)
            if attach is not None:
                # the cached pages lead the page table read-only; prefill
                # resumes at the attach boundary (short of the prompt's
                # end, so the chunk selecting the first token runs here),
                # and every write lands in rows past the shared ones
                cache.attach(attach)
                seq.shared = list(attach.pages)
                seq.shared_entry = attach
                seq.prefill_pos = attach_len
                self._page_table[s, :shared] = attach.pages
                self.metrics.inc("serving.fleet.prefix_cache_hits")
                self.events.append(("prefix_attach", req.rid, s,
                                    attach_len))
            elif cache is not None and req.handoff is None:
                cache.record_miss()
                self.metrics.inc("serving.fleet.prefix_cache_misses")
            for k, v in ctx.items():
                # outside the programs: the captured graphs read the buffer
                self._ctx_bufs[k][s].copy_(v)
            self.stats["requests"] += 1
            self.metrics.inc("serving.decode.requests")
            self.events.append(("admit", req.rid, s))
            if req.handoff is not None:
                self._import_handoff(s, seq, req)
            tr = trace.active()
            if tr is not None:
                # submit -> slot claim, joined to the request by its id
                tr.add_event("decode/admission", req.admit_t, time.time(),
                             request_id=req.rid, slot=s,
                             tenant=req.tenant)

    def _ensure_pages(self, s: int, upto_tokens: int) -> None:
        """Allocate pages for slot ``s`` covering cache positions
        ``[0, upto_tokens)`` — lazily, inside the admission-time
        reservation, so allocation can never fail mid-flight.  Shared
        prefix-cache rows lead the table; owned pages follow them."""
        seq = self._slots[s]
        need = -(-min(upto_tokens, self.cfg.cap) // self.cfg.page_size)
        shared = len(seq.shared)
        while shared + len(seq.pages) < need:
            pid = self._free_pages.pop()
            self._reserved_pages -= 1
            self._page_table[s, shared + len(seq.pages)] = pid
            seq.pages.append(pid)
            if self._quant_kv:
                self._fresh_pages.append(pid)

    def _release_slot(self, s: int) -> None:
        seq = self._slots[s]
        if seq is None:
            return
        cache = self._prefix_cache
        pages = seq.pages
        if cache is not None and not seq.shared:
            # donate the page-aligned PROMPT prefix of a cold request:
            # positions below prefill_pos hold the prompt's K/V (decode
            # and padded prefill tails write at >= the prompt length), so
            # whole covered pages serve any prompt sharing the prefix.
            # An attached request does not donate: its prefix is cached
            n = min(seq.prefill_pos, len(seq.prompt)) // self.cfg.page_size
            if n > 0 and cache.insert(seq.prompt[:n * self.cfg.page_size],
                                      pages[:n],
                                      page_dtype=self.cfg.kv_dtype):
                self.events.append(("prefix_donate", seq.req.rid, n))
                pages = pages[n:]   # ownership moved to the cache
        self._free_pages.extend(pages)
        self._reserved_pages -= max(seq.reserved - len(seq.pages), 0)
        if seq.shared_entry is not None:
            cache.detach(seq.shared_entry)
        self._slots[s] = None
        self._active_mask[s] = False
        self._lengths[s] = 0
        self.events.append(("release", seq.req.rid, s))
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
        C = cfg.prompt_chunk
        prog = self._programs["prefill"]
        t0 = time.time()
        prog.reset()
        x = prog.x
        rows = []              # (b, s, real, final)
        max_need = 1
        for b, s in enumerate(picked):
            seq = self._slots[s]
            p0 = seq.prefill_pos
            chunk = seq.prompt[p0:p0 + C]
            real = len(chunk)
            x["tokens"][b, :real] = chunk
            x["position"][b] = p0
            x["last_index"][b] = real - 1
            x["active"][b] = 1
            for name, src in (("seeds", self._seeds), ("temps", self._temps),
                              ("top_ks", self._top_ks),
                              ("top_ps", self._top_ps)):
                x[name][b] = src[s]
            x["slot_idx"][b] = s
            self._ensure_pages(s, min(p0 + C, cfg.cap))
            x["pt"][b] = self._page_table[s]
            rows.append((b, s, real, (p0 + real) >= len(seq.prompt)))
            max_need = max(max_need, min(p0 + C, cfg.cap))
        self._fill_fresh(x)
        sampled = bool(np.any(x["temps"][:len(picked)] > 0.0))
        out = self._call("prefill", cfg.bucket_pages(max_need), sampled)
        toks, logps = out["tok"], out["logp"]
        now = time.time()
        self.stats["prefill_chunks"] += len(rows)
        self.stats["prefill_calls"] += 1
        self.metrics.inc("serving.decode.prefill_chunks", len(rows))
        self.events.append(("prefill_chunk",
                            [self._slots[s].req.rid for _, s, _, _ in rows]))
        tr = trace.active()
        for b, s, real, final in rows:
            seq = self._slots[s]
            if tr is not None:
                # one event a co-batched row, sharing the call's window
                tr.add_event("decode/prefill_chunk", t0, now,
                             request_id=seq.req.rid, slot=s,
                             chunk_start=seq.prefill_pos, tokens=real)
            seq.prefill_pos += real
            if final:
                self._lengths[s] = len(seq.prompt)
                self._emit_token(s, seq, int(toks[b]), logps[b], now)
        self.metrics.observe("serving.decode.prefill_s", now - t0)
        return True

    # -- decode -------------------------------------------------------------
    def _decode_step(self) -> bool:
        cfg = self.cfg
        if self._spec is not None:
            return self._spec_step()
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
        # a decode worker dying with streams in flight: the pool's proxy
        # fails the streams over
        faults.fire("fleet_worker_kill")
        for s in active:
            self._ensure_pages(s, int(self._lengths[s]) + 1)
        ref = active if active else occupied
        nb = cfg.bucket_pages(int(self._lengths[ref].max()) + 1)
        t0 = time.time()
        self._fill_decode(self._programs["step"].x)
        out = self._call("step", nb,
                         bool(np.any(self._temps[active] > 0.0)))
        toks, logps = out["tok"], out["logp"]
        now = time.time()
        self.stats["steps"] += 1
        self.metrics.inc("serving.decode.steps")
        self.events.append(("decode_step", len(active), nb))
        if active and self._last_step_t:
            # every active slot streams one token a step, so the step gap
            # is every in-flight stream's inter-token latency
            self.metrics.observe("serving.decode.inter_token_s",
                                 now - self._last_step_t)
        self._last_step_t = now
        tr = trace.active()
        for s in active:
            seq = self._slots[s]
            self._lengths[s] += 1          # last_token's K/V just landed
            self._emit_token(s, seq, int(toks[s]), logps[s], now)
            if tr is not None:
                tr.add_event("decode/token_step", t0, now,
                             request_id=seq.req.rid, slot=s,
                             index=len(seq.generated) - 1)
        self._tokens_window.append((now, len(active)))
        self.stats["tokens"] += len(active)
        self.metrics.inc("serving.decode.tokens_total", len(active))
        self.metrics.observe("serving.decode.step_s", now - t0)
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
        self._export_gauges(now)
        return True

    def _spec_step(self) -> bool:
        """One speculative iteration: one call drafts k (+1 cache-filling)
        tokens with the sparse twin and verifies the chunk with ONE
        target pass on the device, then the host accepts the longest
        agreeing prefix.  Emitted tokens are ALWAYS the verify's target
        selections — the drafted token at index j only gates whether the
        selection conditioned on it is usable — so the stream is the
        spec-off stream; speculation changes how many tokens one
        iteration yields (1 to k+1)."""
        cfg = self.cfg
        k = self._spec.k
        active = [s for s in range(cfg.slots) if self._active_mask[s]]
        if not active:
            return False
        faults.fire("fleet_worker_kill")
        for s in active:
            self._ensure_pages(s, min(int(self._lengths[s]) + 1 + k,
                                      cfg.cap))
        nb = cfg.bucket_pages(
            min(int(self._lengths[active].max()) + 1 + k, cfg.cap))
        t0 = time.time()
        self._fill_decode(self._programs["spec"].x)
        # any sampled slot routes the iteration to the scan verify: the
        # top-k/top-p thresholds are discontinuous in the chunk pass's
        # last-ulp logit drift
        out = self._call("spec", nb, bool(np.any(self._temps[active] > 0.0)))
        d_host, g_toks, g_logps = out["d_toks"], out["g_toks"], out["g_logps"]
        now = time.time()
        self.stats["steps"] += 1
        self.metrics.inc("serving.decode.steps")
        self.metrics.observe("serving.decode.spec_draft_step_s",
                             self._marks.seconds(0, 1))
        self.metrics.observe("serving.decode.spec_verify_step_s",
                             self._marks.seconds(1, 2))
        self.events.append(("spec_step", len(active), nb))
        if self._last_step_t:
            # under speculation the step gap covers up to k+1 tokens a
            # stream: still the stream's stall
            self.metrics.observe("serving.decode.inter_token_s",
                                 now - self._last_step_t)
        self._last_step_t = now
        n_tok = drafted = accepted = rejected = 0
        tr = trace.active()
        for s in active:
            seq = self._slots[s]
            emitted = 0
            mismatch = False
            for j in range(k + 1):
                if j >= 1 and int(d_host[s, j - 1]) != int(g_toks[s, j - 1]):
                    # the token fed at query j is not the target's pick
                    # for its position (already emitted as the
                    # correction): nothing from j on is usable; the pool
                    # K/V past ``lengths`` is rewritten next iteration
                    mismatch = True
                    break
                self._lengths[s] += 1   # the fed token's K/V landed
                self._emit_token(s, seq, int(g_toks[s, j]), g_logps[s, j],
                                 now)
                emitted += 1
                if self._slots[s] is not seq or seq.done:
                    break               # eos / length freed the slot
            # accepted = draft tokens the target agreed with; rejected =
            # the one mismatch that ends a chunk.  Drafts past an eos or
            # length finish were never judged: drafted, not rejected
            acc = min(max(emitted - 1, 0), k)
            drafted += k
            accepted += acc
            rejected += 1 if mismatch else 0
            n_tok += emitted
            if tr is not None:
                tr.add_event("decode/spec_step", t0, now,
                             request_id=seq.req.rid, slot=s,
                             emitted=emitted, accepted=acc)
        self.stats["tokens"] += n_tok
        self.stats["spec_drafted"] += drafted
        self.stats["spec_accepted"] += accepted
        self.stats["spec_rejected"] += rejected
        self.metrics.inc("serving.decode.tokens_total", n_tok)
        self.metrics.inc("serving.decode.spec_drafted_tokens", drafted)
        self.metrics.inc("serving.decode.spec_accepted_tokens", accepted)
        self.metrics.inc("serving.decode.spec_rejected_tokens", rejected)
        self._accept_window.append((now, accepted, accepted + rejected))
        self._tokens_window.append((now, n_tok))
        self.metrics.observe("serving.decode.step_s", now - t0)
        self._export_gauges(now)
        return True

    def _emit_token(self, s: int, seq: _ActiveSeq, tok: int,
                    logp: np.float32, now: float) -> None:
        req = seq.req
        if not seq.generated:
            seq.first_token_t = now
            seq.first_logp = np.float32(logp)
            self.metrics.observe("serving.decode.ttft_s", now - req.admit_t)
        seq.generated.append(tok)
        seq.logp = np.float32(seq.logp + logp)
        seq.last_logp = np.float32(logp)
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
        if req.export_kv:
            # before the slot releases its pages
            self._harvest_kv(seq)
        self.stats["completed"] += 1
        self.metrics.inc("serving.decode.completed")
        tr = trace.active()
        if tr is not None:
            t = time.time()
            tr.add_event("decode/publish", t, t, request_id=req.rid,
                         finish_reason=reason,
                         tokens=len(seq.generated))
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

    def _harvest_kv(self, seq: _ActiveSeq) -> None:
        """The export side of the prefill/decode split: the pages holding
        the prompt (shared prefix rows included) copied to the host onto
        ``kv_export``, in their stored type."""
        cfg = self.cfg
        req = seq.req
        n = -(-len(seq.prompt) // cfg.page_size)
        pids = list(seq.shared) + list(seq.pages)
        req.kv_export = {
            "tokens": np.asarray(seq.prompt, np.int32),
            "first_token": int(seq.generated[0]),
            "first_logp": float(seq.first_logp),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "top_p": float(req.top_p),
            "seed": int(req.seed),
            "request_id": req.rid,
            "kv_dtype": cfg.kv_dtype,
            **self._export_pages(pids[:n])}
        self.stats["kv_exports"] += 1
        self.metrics.inc("serving.fleet.kv_exports")
        self.events.append(("kv_export", req.rid, int(n)))

    def _import_handoff(self, s: int, seq: _ActiveSeq,
                        req: DecodeRequest) -> None:
        """The decode side of the split: pages for the prompt, the
        handoff's page images written into them (a copy on the engine
        thread, between calls), and the handoff's first token emitted.
        The slot then decodes as if the prefill had run here.  The
        imported pages take the handoff's int8 scales, so they leave the
        list of pages whose scales the next call resets."""
        cfg = self.cfg
        h = req.handoff
        plen = len(seq.prompt)
        n = -(-plen // cfg.page_size)
        self._ensure_pages(s, plen)
        pids = self._page_table[s, :n].copy()
        ids = torch.from_numpy(pids.astype(np.int64)).to(self.device)
        dt = torch.int8 if self._quant_kv else torch.float32
        for pool, key in ((self._kv_k, "k"), (self._kv_v, "v")):
            pool[:, ids] = torch.from_numpy(np.array(h[key])).to(
                self.device, dt)
        if self._quant_kv:
            for sc, key in ((self._kv_sk, "k_scales"),
                            (self._kv_sv, "v_scales")):
                sc[:, ids] = torch.from_numpy(np.array(
                    h[key], np.float32)).to(self.device)
            taken = set(pids.tolist())
            self._fresh_pages = [p for p in self._fresh_pages
                                 if p not in taken]
        seq.prefill_pos = plen
        self._lengths[s] = plen
        self.stats["kv_imports"] += 1
        self.metrics.inc("serving.fleet.kv_imports")
        self.events.append(("kv_import", req.rid, s, int(n)))
        self._emit_token(s, seq, int(h["first_token"]),
                         np.float32(h["first_logp"]), time.time())

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
        self.metrics.inc("serving.decode.expired")
        tr = trace.active()
        if tr is not None:
            tr.add_event("decode/publish", now, now, request_id=req.rid,
                         finish_reason="expired")
        err = DeadlineExceededError(req.rid, now - req.admit_t)
        if seq is not None and seq.generated:
            # a streaming request that already produced tokens: the
            # partial result rides on the error
            err.partial_tokens = np.asarray(seq.generated, np.int32)
        self._finish_error(req, err)

    def _export_gauges(self, now: float) -> None:
        """The engine's gauges, at most every 50 ms: slot occupancy, page
        utilization, queue depth, page bytes, tokens/s over the last 2 s
        and, under speculation, the acceptance rate."""
        if now - self._gauge_t < 0.05:
            return
        self._gauge_t = now
        cfg = self.cfg
        self.metrics.gauge("serving.decode.slot_occupancy",
                           float(sum(s is not None for s in self._slots))
                           / cfg.slots)
        used = cfg.total_pages - len(self._free_pages)
        self.metrics.gauge("serving.decode.page_utilization",
                           used / cfg.total_pages)
        self.metrics.gauge("serving.decode.queue_depth", self.queue_depth())
        self.metrics.gauge("serving.decode.kv_bytes_per_page",
                           float(self.kv_bytes_per_page()))
        if self._prefix_cache is not None:
            st = self._prefix_cache.stats()
            self.metrics.gauge("serving.fleet.prefix_cache_pages",
                               st["pages"])
            self.metrics.gauge("serving.fleet.prefix_cache_entries",
                               st["entries"])
        window = [(t, n) for t, n in self._tokens_window if now - t <= 2.0]
        if len(window) >= 2:
            span = now - window[0][0]
            if span > 0:
                self.metrics.gauge("serving.decode.tokens_per_s",
                                   sum(n for _, n in window) / span)
        if self._spec is not None:
            w = [(t, a, d) for t, a, d in self._accept_window
                 if now - t <= 2.0]
            total = sum(d for _, _, d in w)
            if total:
                self.metrics.gauge("serving.decode.spec_accept_rate",
                                   sum(a for _, a, _ in w) / total)

    # -- the whole-sequence reference ---------------------------------------
    def _t(self, a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def static_generate(self, requests: Sequence[DecodeRequest]
                        ) -> List[DecodeResult]:
        """The reference: each request decoded alone by the same chunked
        prefill followed by one-token steps over a contiguous
        whole-sequence KV cache (no pages, no slots, no scheduling).
        Each request runs at batch 2 (the row duplicated), as in the
        JAX engine."""
        out = []
        for req in requests:
            prompt, ctx = self.adapter.prepare(req.tokens)
            max_new = min(req.max_new_tokens or self.cfg.max_new_tokens,
                          self.cfg.cap - len(prompt))
            with self.adapter.weights():
                out.append(self._static_one(req, prompt, ctx, max_new))
        return out

    @torch.no_grad()
    def _static_one(self, req: DecodeRequest, prompt: np.ndarray, ctx,
                    max_new: int) -> DecodeResult:
        cfg = self.cfg
        a = self.adapter
        B = 2                                  # duplicated row
        sampling = _Sampling.from_host(
            [req.seed] * B, [req.temperature] * B, [req.top_k] * B,
            [req.top_p] * B, self.device)
        kbuf = torch.zeros((B + 1, a.num_layers, a.num_heads, cfg.cap,
                            a.head_dim), device=self.device)
        vbuf = torch.zeros_like(kbuf)
        ctx2 = {k: torch.stack([v, v]) for k, v in ctx.items()}
        C = cfg.prompt_chunk
        t0 = time.time()
        tok = logp = None
        for p0 in range(0, len(prompt), C):
            chunk = np.zeros((C,), np.int32)
            real = len(prompt[p0:p0 + C])
            chunk[:real] = prompt[p0:p0 + C]
            logits, kbuf, vbuf, _, _ = a.chunk_forward(
                self._t(np.stack([chunk, chunk]), torch.long),
                self._t([p0, p0], torch.long), kbuf, vbuf, ctx=ctx2)
            tok, logp = sampling.select(
                logits[:, real - 1], self._base_key,
                self._t([p0 + real] * B, torch.long))
        gen = [int(tok[0])]
        total = np.float32(logp[0].item())
        reason = "eos" if gen[0] == cfg.eos_id else "length"
        pos = len(prompt)
        while reason != "eos" and len(gen) < max_new:
            logits, kbuf, vbuf, _, _ = a.chunk_forward(
                tok[:, None], self._t([pos, pos], torch.long), kbuf, vbuf,
                ctx=ctx2)
            tok, logp = sampling.select(logits[:, 0], self._base_key,
                                        self._t([pos + 1] * B, torch.long))
            gen.append(int(tok[0]))
            total = np.float32(total + logp[0].item())
            if gen[-1] == cfg.eos_id:
                reason = "eos"
            pos += 1
        return DecodeResult(tokens=np.asarray(gen, np.int32),
                            logp=float(total), prompt_len=len(prompt),
                            ttft_s=time.time() - t0, finish_reason=reason)
