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
  re-evaluated between steps from a (deadline, seq) heap; a finished or
  expired sequence frees its slot and pages immediately.
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

:meth:`DecodeEngine.static_generate` decodes each request alone over a
contiguous cache with no pages, slots or scheduling; it is the engine's
own reference.  Both paths share ``chunk_forward`` (the layer math) and
``_select_tokens``.

What this port covers: the LM adapter, float32 and int8 pages, int8
serving weights, greedy and seeded sampled selection, speculative
decoding, continuous and whole-batch-restart (``continuous=False``)
scheduling.  The prefix cache and the draft attention window
(``SpecConfig.draft_window``) are refused with a ``ValueError`` until
they are ported.

PyTorch writes are in place: the page pool is updated where it lies,
and every write is masked to active rows and in-range positions first
(JAX dropped out-of-range scatter writes; PyTorch's index writes would
raise or corrupt).  Every mask is computed on the host, so no write
waits on the device."""

import heapq
import itertools
import logging
import math
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import (Transformer, _attn_project,
                                          positional_encoding)
from bigdl_tpu_torch.nn.quantized import Int8Weights
from bigdl_tpu_torch.ops.block_sparse import derive_draft_masks
from bigdl_tpu_torch.ops.flash_attention import (_gather_pages,
                                                 paged_decode_attention,
                                                 paged_verify_attention)
from bigdl_tpu_torch.ops.quantized import quantize_pages
from bigdl_tpu_torch.tensor.policy import apply_precision_policy, cast_compute
from bigdl_tpu_torch.utils import prng

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
    # not ported yet: a draft attending only its last W positions
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
    # not ported yet; kept so a config asking for it is refused
    prefix_cache_pages: int = 0
    # KV page storage: "float32", or "int8" pages with one float32
    # abs-max scale per (layer, page) — 4x fewer page bytes, token
    # parity with float32 within the quantization budget
    kv_dtype: str = "float32"
    # a SpecConfig turns every decode iteration into draft(k) + verify
    # (continuous LM engines only)
    speculative: Optional[SpecConfig] = None

    def __post_init__(self):
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError(f"DecodeConfig.kv_dtype must be 'float32' or "
                             f"'int8', got {self.kv_dtype!r}")
        if self.speculative is not None and not isinstance(
                self.speculative, SpecConfig):
            raise ValueError(f"DecodeConfig.speculative must be a "
                             f"SpecConfig or None, got "
                             f"{type(self.speculative).__name__}")
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
    """One generation request; ``tokens`` is the prompt.
    ``temperature > 0`` samples with ``top_k`` (0 = off), ``top_p`` (1.0
    = off) and the request's ``seed``."""

    tokens: np.ndarray
    max_new_tokens: Optional[int] = None
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
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

class _Sampling:
    """Per-row sampling boards of one call, on the host: request seeds,
    temperatures, top-k and top-p.  ``sampled`` says whether any row
    samples (else selection is the plain argmax)."""

    __slots__ = ("seeds", "temps", "top_ks", "top_ps", "sampled")

    def __init__(self, seeds, temps, top_ks, top_ps):
        self.seeds = np.asarray(seeds, np.int32)
        self.temps = np.asarray(temps, np.float32)
        self.top_ks = np.asarray(top_ks, np.int32)
        self.top_ps = np.asarray(top_ps, np.float32)
        self.sampled = bool(np.any(self.temps > 0.0))

    def repeat(self, c: int) -> "_Sampling":
        """Each row ``c`` times (the rows of a verify chunk)."""
        return _Sampling(*(np.repeat(a, c) for a in (
            self.seeds, self.temps, self.top_ks, self.top_ps)))

    def select(self, logits, base_key, positions):
        """:func:`_select_tokens` of ``logits`` (B, V) for tokens at
        ``positions`` (B,) long; the row keys are derived only when a row
        samples."""
        if not self.sampled:
            return _select_tokens(logits)
        dev = logits.device
        keys = prng.fold_in(base_key, torch.from_numpy(self.seeds).to(dev))
        return _select_tokens(
            logits, keys, positions, torch.from_numpy(self.temps).to(dev),
            torch.from_numpy(self.top_ks).to(dev),
            torch.from_numpy(self.top_ps).to(dev))


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
    occupy.  The JAX engine's rule, bit for bit in its draws."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    tok = greedy
    if temps is not None:
        vocab = logits.shape[-1]
        z = logits / torch.clamp(temps, min=1e-6)[:, None]
        zs = torch.sort(z, dim=-1, descending=True).values
        kth = zs.gather(-1, (top_ks.long() - 1).clamp(0, vocab - 1)[:, None])
        neg = torch.tensor(float("-inf"), device=z.device)
        z = torch.where((top_ks > 0)[:, None] & (z < kth), neg, z)
        zs2 = torch.sort(z, dim=-1, descending=True).values
        ps = torch.softmax(zs2, dim=-1)
        keep = (torch.cumsum(ps, dim=-1) - ps) < top_ps[:, None]
        minz = torch.where(keep, zs2, -neg).amin(dim=-1, keepdim=True)
        z = torch.where((top_ps < 1.0)[:, None] & (z < minz), neg, z)
        u = prng.uniform(prng.fold_in(keys, positions), (vocab,),
                         float(np.finfo(np.float32).tiny), 1.0)
        sampled = torch.argmax(z - torch.log(-torch.log(u)), dim=-1)
        tok = torch.where(temps <= 0.0, greedy, sampled)
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
    reference a contiguous cache.

    ``weight_quant="int8"`` serves a copy of the model whose matmul
    weights are int8 at rest (``nn.quantized.Int8Weights``: per-out-column
    scales; the caller's model is left as it is); every engine call runs
    inside :meth:`weights`, which lends ``self.model`` a dequantized
    float32 view for that call only."""

    def __init__(self, model, cap: int, weight_quant: Optional[str] = None):
        if getattr(model, "mode", None) != "lm":
            raise ValueError("LMAdapter needs a Transformer(mode='lm')")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant {weight_quant!r}: None | 'int8'")
        self.weight_quant = weight_quant
        self._w8 = Int8Weights(model) if weight_quant == "int8" else None
        self.model = self._w8.module if self._w8 is not None else model
        self.device = model.embedding.device
        layer = model.decoder[0].attn
        self.num_heads = layer.num_heads
        self.head_dim = layer.head_dim
        self.num_layers = len(model.decoder)
        self._pe = positional_encoding(cap + 1, model.hidden_size,
                                       device=self.device)
        self._scale = math.sqrt(model.hidden_size)

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
                      self_attend=None, model=None):
        """One step of C tokens per row: embed at absolute positions,
        write each layer's K/V into the buffer, attend causally over the
        cache, return last-layer logits.  ``tokens`` (B, C) and
        ``positions`` (B,) are int64; ``kbuf/vbuf`` (B, L, h, K, hd)
        float32 are written in place.  ``self_attend(i, q, k_new,
        v_new)`` replaces the buffer attention (the engine's paged path,
        which owns its own cache writes); ``kbuf/vbuf`` may then be
        None.  ``model`` walks a twin's layers instead (the speculative
        draft: the same parameters, block-sparse FFNs)."""
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
        for i, layer in enumerate((model or self.model).decoder):
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
        shape = (L, cfg.total_pages, h, cfg.page_size, hd)
        # int8 pages: one float32 abs-max scale per (layer, page) beside
        # the int8 payload
        self._quant_kv = cfg.kv_dtype == "int8"
        kv_dt = torch.int8 if self._quant_kv else torch.float32
        self._kv_k = torch.zeros(shape, dtype=kv_dt, device=self.device)
        self._kv_v = torch.zeros_like(self._kv_k)
        self._kv_sk = self._kv_sv = None
        if self._quant_kv:
            self._kv_sk = torch.zeros((L, cfg.total_pages),
                                      dtype=torch.float32, device=self.device)
            self._kv_sv = torch.zeros_like(self._kv_sk)
        # pages popped off the free list whose scales still hold the last
        # owner's: zeroed before the next call reads them
        self._fresh_pages: List[int] = []
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
            if sp.draft_window is not None:
                raise ValueError("SpecConfig.draft_window is not ported "
                                 "yet: the draft attends its full context")
            self._draft_model = adapter.build_draft(sp)
            self._dr_k = torch.zeros(shape, dtype=torch.float32,
                                     device=self.device)
            self._dr_v = torch.zeros_like(self._dr_k)
        self._base_key = prng.PRNGKey(cfg.base_seed, device=self.device)
        # host-side slot boards (numpy; copied to the device per call)
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
                      "prefill_calls": 0,
                      "rejected": 0, "spec_drafted": 0, "spec_accepted": 0,
                      "spec_rejected": 0}

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
        if self._stop.is_set():
            raise RuntimeError("decode engine stopped")
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
        bucket (and, with speculation, one draft and both verify forms)
        on all-inactive rows before traffic: on CUDA this builds and
        loads the kernels and initializes the math libraries.  No row is
        active, so nothing is written to the page pools."""
        cfg = self.cfg
        S, B = cfg.slots, cfg.prefill_batch

        def idle(n):
            return _Sampling(np.zeros(n), np.zeros(n), np.zeros(n),
                             np.ones(n))

        zs, zb = np.zeros((S,), np.int32), np.zeros((B,), np.int32)
        for nb in cfg.len_buckets():
            self._step(nb, self._page_table, zs, zs, np.zeros((S,), bool),
                       idle(S))
            self._prefill(nb, np.zeros((B, cfg.pages_per_slot), np.int32),
                          np.zeros((B, cfg.prompt_chunk), np.int32), zb, zb,
                          np.zeros((B,), bool), idle(B))
            if self._spec is not None:
                with torch.no_grad(), self.adapter.weights():
                    d = self._draft(nb, zs, zs, np.zeros((S,), bool),
                                    idle(S))
                    for force_scan in (False, True):
                        self._verify(nb, zs, zs, d, np.zeros((S,), bool),
                                     idle(S), force_scan)
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

    def _gather_deq(self, kv, sc, pt):
        """:meth:`_gather` of an int8 pool: each page times its (layer,
        page) scale.  A fresh page has scale 0, so its stale payload
        reads as zeros."""
        g = kv[:, pt].float() * sc[:, pt][..., None, None, None]
        L, B, nb, h, page, hd = g.shape
        return g.permute(1, 0, 3, 2, 4, 5).reshape(B, L, h, nb * page, hd)

    def _use_flash(self) -> bool:
        if self.cfg.use_flash_decode is not None:
            return bool(self.cfg.use_flash_decode)
        return self.device.type == "cuda"

    def _sampling(self) -> _Sampling:
        return _Sampling(self._seeds, self._temps, self._top_ks,
                         self._top_ps)

    def _flush_fresh_scales(self) -> None:
        """Zero the scales of pages just popped off the free list (int8
        pages), before the next call reads them: a reused page would
        otherwise dequantize its last owner's payload under its last
        owner's scale."""
        if not self._fresh_pages:
            return
        fresh, self._fresh_pages = self._fresh_pages, []
        if self._quant_kv:
            idx = self._t(fresh, torch.long)
            self._kv_sk[:, idx] = 0.0
            self._kv_sv[:, idx] = 0.0

    def _write_chunk_pages(self, pool_k, pool_v, k_new, v_new, page_table,
                           start, active) -> None:
        """Write a chunk's fresh K/V, (B, L, h, C, hd) for positions
        ``start .. start+C-1`` of each row, into float32 pools in place:
        active rows and positions inside the cap only (padded prompt
        tails are written, as the JAX engine writes them)."""
        cfg = self.cfg
        C = k_new.shape[3]
        pos_c = np.asarray(start, np.int64)[:, None] + np.arange(C)[None, :]
        ok = np.asarray(active, bool)[:, None] & (pos_c < cfg.cap)
        b_idx, c_idx = np.nonzero(ok)
        if not len(b_idx):
            return
        pc = pos_c[b_idx, c_idx]
        pid = self._t(np.asarray(page_table)[b_idx, pc // cfg.page_size],
                      torch.long)
        off = self._t(pc % cfg.page_size, torch.long)
        bi, ci = self._t(b_idx, torch.long), self._t(c_idx, torch.long)
        # (L, P, h, page, hd)[:, pid, :, off] <- (n, L, h, hd)
        pool_k[:, pid, :, off] = k_new[bi, :, :, ci].to(pool_k.dtype)
        pool_v[:, pid, :, off] = v_new[bi, :, :, ci].to(pool_v.dtype)

    def _decode_body(self, n_blocks, pt_np, pt_full, lengths, tokens,
                     active):
        """One decode-step body: ``tokens`` (S, 1) int64 sit at the host
        positions ``lengths``.  Writes each active row's K/V at its
        position (inside the cap) into the pool, then attends; returns
        the logits (S, V).  With int8 pages the write is a
        read-modify-write of the one page it lands in: dequantize, insert
        the row, requantize under the page's monotone scale floor (the
        untouched positions requantize exactly)."""
        cfg = self.cfg
        page = cfg.page_size
        adapter = self.adapter
        pt = pt_full[:, :n_blocks]          # row-strided view
        lengths = np.asarray(lengths, np.int64)
        pos = self._t(lengths, torch.long)
        len32 = pos.int()
        r_np = np.flatnonzero(np.asarray(active, bool) & (lengths < cfg.cap))
        rows = self._t(r_np, torch.long)
        # write target of this step's K/V: the page holding the position
        wid = self._t(pt_np[r_np, lengths[r_np] // page], torch.long)
        off = self._t(lengths[r_np] % page, torch.long)
        use_flash = self._use_flash()
        if self._quant_kv:
            ar = torch.arange(len(r_np), device=self.device)

            def rmw(pool, scales, i, new):
                floor = scales[i, wid]
                pg = pool[i, wid].float() * floor[:, None, None, None]
                pg[ar, :, off] = new[rows, :, 0]
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

            return adapter.chunk_forward(tokens, pos, None, None,
                                         self_attend=self_attend)[0][:, 0]
        if use_flash:
            def self_attend(i, q, k_new, v_new):
                # write this layer's K/V into the pages FIRST, then run
                # the single-query kernel straight off the page pool
                kp, vp = self._kv_k[i], self._kv_v[i]
                kp[wid, :, off] = k_new[rows, :, 0]
                vp[wid, :, off] = v_new[rows, :, 0]
                out = paged_decode_attention(q[:, :, 0].contiguous(), kp, vp,
                                             pt, len32)
                return out[:, :, None]

            return adapter.chunk_forward(tokens, pos, None, None,
                                         self_attend=self_attend)[0][:, 0]
        pt64 = pt.long()
        kbuf = self._gather(self._kv_k, pt64)
        vbuf = self._gather(self._kv_v, pt64)
        logits, _, _, k_new, v_new = adapter.chunk_forward(tokens, pos, kbuf,
                                                           vbuf)
        self._kv_k[:, wid, :, off] = k_new[rows, :, :, 0]
        self._kv_v[:, wid, :, off] = v_new[rows, :, :, 0]
        return logits[:, 0]

    @torch.no_grad()
    def _step(self, n_blocks, page_table, lengths, last_tokens, active,
              sampling: _Sampling):
        """One decode step for every slot: write each active slot's new
        K/V at position ``lengths`` and select its next token.  Returns
        (tokens, logps) as numpy arrays over all slots."""
        tokens = self._t(last_tokens, torch.long)[:, None]
        with self.adapter.weights():
            logits = self._decode_body(
                n_blocks, np.asarray(page_table),
                self._t(page_table, torch.int32), lengths, tokens, active)
            tok, logp = sampling.select(
                logits, self._base_key, self._t(lengths, torch.long) + 1)
        return tok.cpu().numpy(), logp.cpu().numpy()

    @torch.no_grad()
    def _prefill(self, n_blocks, pt_rows, tokens, position, last_index,
                 active, sampling: _Sampling):
        """Prefill one chunk for up to ``prefill_batch`` rows in one
        call: attend over the pages written so far, write every active
        row's chunk K/V into its pages, and select the FIRST generated
        token at ``last_index`` (meaningful for rows on their final
        chunk).  With speculation the draft twin consumes the same chunk
        into its own pool.  Returns (tokens, logps) as numpy arrays."""
        cfg = self.cfg
        page, C = cfg.page_size, cfg.prompt_chunk
        a = self.adapter
        pt_rows = np.asarray(pt_rows)
        position = np.asarray(position, np.int64)
        active = np.asarray(active, bool)
        pt = self._t(pt_rows, torch.long)[:, :n_blocks]
        pos_t = self._t(position, torch.long)
        tok_t = self._t(tokens, torch.long)
        with self.adapter.weights():
            if self._quant_kv:
                kbuf = self._gather_deq(self._kv_k, self._kv_sk, pt)
                vbuf = self._gather_deq(self._kv_v, self._kv_sv, pt)
            else:
                kbuf = self._gather(self._kv_k, pt)
                vbuf = self._gather(self._kv_v, pt)
            logits, _, _, k_new, v_new = a.chunk_forward(tok_t, pos_t, kbuf,
                                                         vbuf)
            B = logits.shape[0]
            li = self._t(last_index, torch.long)
            last = logits[torch.arange(B, device=self.device), li]  # (B, V)
            tok, logp = sampling.select(last, self._base_key, pos_t + li + 1)
            if self._quant_kv:
                # requantize and write back whole pages, only those this
                # chunk touched: table rows past a slot's allocation may
                # name pages other slots own now.  Untouched positions of
                # a touched page came from the dequantized gather, so
                # under the monotone floor they requantize exactly
                pg0 = np.arange(n_blocks)[None, :] * page
                lim = np.minimum(position + C, cfg.cap)[:, None]
                touched = (active[:, None] & (pg0 < lim)
                           & (pg0 + page > position[:, None]))
                b_idx, j_idx = np.nonzero(touched)
                if len(b_idx):
                    bi = self._t(b_idx, torch.long)
                    ji = self._t(j_idx, torch.long)
                    pids = self._t(pt_rows[b_idx, j_idx], torch.long)
                    L, h, hd = a.num_layers, a.num_heads, a.head_dim
                    for buf, pool, scales in (
                            (kbuf, self._kv_k, self._kv_sk),
                            (vbuf, self._kv_v, self._kv_sv)):
                        pages = buf.reshape(B, L, h, n_blocks, page, hd)[
                            bi, :, :, ji].permute(1, 0, 2, 3, 4)
                        q, sc = quantize_pages(pages,
                                               floor_scales=scales[:, pids])
                        pool[:, pids] = q
                        scales[:, pids] = sc
            else:
                self._write_chunk_pages(self._kv_k, self._kv_v, k_new, v_new,
                                        pt_rows, position, active)
            if self._spec is not None:
                self._draft_prefill(pt, tok_t, pos_t, pt_rows, position,
                                    active)
        return tok.cpu().numpy(), logp.cpu().numpy()

    # -- speculative calls --------------------------------------------------
    def _draft_prefill(self, pt, tok_t, pos_t, pt_rows, position, active):
        """The draft twin consumes a prefill chunk, so its pool holds the
        prompt position for position before its first draft step (no
        token is selected: the first generated token is the target's)."""
        kbuf = self._gather(self._dr_k, pt)
        vbuf = self._gather(self._dr_v, pt)
        _, _, _, k_new, v_new = self.adapter.chunk_forward(
            tok_t, pos_t, kbuf, vbuf, model=self._draft_model)
        self._write_chunk_pages(self._dr_k, self._dr_v, k_new, v_new,
                                pt_rows, position, active)

    def _draft(self, n_blocks, lengths, last_tokens, active,
               sampling: _Sampling):
        """Draft ``k+1`` tokens per slot with the sparse twin: ``k+1``
        single-token steps over the gathered float32 draft cache (the
        extra step writes the draft K/V at ``lengths+k`` that a fully
        accepted chunk's bonus token needs next iteration), then the
        chunk's K/V go into the draft pool.  Selection uses the verify's
        keys and positions, so a close draft samples the target's token.
        Returns the drafted tokens (S, k+1) on the device."""
        pt = self._t(self._page_table, torch.long)[:, :n_blocks]
        kbuf = self._gather(self._dr_k, pt)
        vbuf = self._gather(self._dr_v, pt)
        pos = self._t(lengths, torch.long)
        last = self._t(last_tokens, torch.long)
        toks, k_news, v_news = [], [], []
        for _ in range(self._spec.k + 1):
            logits, kbuf, vbuf, k_new, v_new = self.adapter.chunk_forward(
                last[:, None], pos, kbuf, vbuf, model=self._draft_model)
            last, _ = sampling.select(logits[:, 0], self._base_key, pos + 1)
            toks.append(last)
            k_news.append(k_new)
            v_news.append(v_new)
            pos = pos + 1
        self._write_chunk_pages(self._dr_k, self._dr_v, torch.cat(k_news, 3),
                                torch.cat(v_news, 3), self._page_table,
                                lengths, active)
        return torch.stack(toks, 1)

    def _verify(self, n_blocks, lengths, last_tokens, d_toks, active,
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
        cfg = self.cfg
        C = self._spec.k + 1
        page = cfg.page_size
        impl = self._spec.verify_impl
        chunk_mode = (not self._quant_kv and not force_scan and (
            self._use_flash() if impl == "auto" else impl == "chunk"))
        tokens = torch.cat([self._t(last_tokens, torch.long)[:, None],
                            d_toks[:, :C - 1]], dim=1)
        lengths = np.asarray(lengths, np.int64)
        pt_full = self._t(self._page_table, torch.int32)
        if not chunk_mode:
            toks, logps = [], []
            for j in range(C):
                logits = self._decode_body(n_blocks, self._page_table,
                                           pt_full, lengths + j,
                                           tokens[:, j:j + 1], active)
                t, lp = sampling.select(logits, self._base_key,
                                        self._t(lengths + j + 1, torch.long))
                toks.append(t)
                logps.append(lp)
            return torch.stack(toks, 1), torch.stack(logps, 1)
        S = tokens.shape[0]
        pt = pt_full[:, :n_blocks]
        pos = self._t(lengths, torch.long)
        len32 = pos.int()
        pos_c = lengths[:, None] + np.arange(C)[None, :]
        b_idx, c_idx = np.nonzero(np.asarray(active, bool)[:, None]
                                  & (pos_c < cfg.cap))
        pc = pos_c[b_idx, c_idx]
        pid = self._t(self._page_table[b_idx, pc // page], torch.long)
        off = self._t(pc % page, torch.long)
        bi, ci = self._t(b_idx, torch.long), self._t(c_idx, torch.long)

        def self_attend(i, q, k_new, v_new):
            # the chunk's K/V into the pages first, then all C queries
            self._kv_k[i][pid, :, off] = k_new[bi, :, ci]
            self._kv_v[i][pid, :, off] = v_new[bi, :, ci]
            return paged_verify_attention(q.contiguous(), self._kv_k[i],
                                          self._kv_v[i], pt, len32)

        logits = self.adapter.chunk_forward(tokens, pos, None, None,
                                            self_attend=self_attend)[0]
        tok, logp = sampling.repeat(C).select(
            logits.reshape(S * C, -1), self._base_key,
            self._t((pos_c + 1).reshape(-1), torch.long))
        return tok.reshape(S, C), logp.reshape(S, C)

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
                    # one prefill call per token a decode iteration can
                    # emit: a speculative iteration advances a stream up
                    # to k+1 tokens, and prefilling slots keep pace
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
        the padded final prefill chunk or the full generation, capped.
        Under speculation an iteration writes up to k positions past the
        emitted length (draft lookahead and verify chunk), so the
        reservation grows by k."""
        cfg = self.cfg
        C = cfg.prompt_chunk
        spec_k = self._spec.k if self._spec is not None else 0
        padded_prompt = min(-(-prompt_len // C) * C, cfg.cap)
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
            self._seeds[s] = np.int32(req.seed)
            self._temps[s] = np.float32(req.temperature)
            self._top_ks[s] = np.int32(req.top_k)
            self._top_ps[s] = np.float32(req.top_p)
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
            if self._quant_kv:
                self._fresh_pages.append(pid)

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
        boards = [np.zeros((B,), np.int32), np.zeros((B,), np.float32),
                  np.zeros((B,), np.int32), np.ones((B,), np.float32)]
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
            for board, src in zip(boards, (self._seeds, self._temps,
                                           self._top_ks, self._top_ps)):
                board[b] = src[s]
            self._ensure_pages(s, min(p0 + C, cfg.cap))
            pt_rows[b] = self._page_table[s]
            rows.append((b, s, real, (p0 + real) >= len(seq.prompt)))
            max_need = max(max_need, min(p0 + C, cfg.cap))
        self._flush_fresh_scales()
        toks, logps = self._prefill(cfg.bucket_pages(max_need), pt_rows,
                                    tokens, position, last_index, active,
                                    _Sampling(*boards))
        now = time.time()
        self.stats["prefill_chunks"] += len(rows)
        self.stats["prefill_calls"] += 1
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
        for s in active:
            self._ensure_pages(s, int(self._lengths[s]) + 1)
        ref = active if active else occupied
        nb = cfg.bucket_pages(int(self._lengths[ref].max()) + 1)
        self._flush_fresh_scales()
        toks, logps = self._step(nb, self._page_table, self._lengths,
                                 self._last_tokens, self._active_mask,
                                 self._sampling())
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

    def _spec_step(self) -> bool:
        """One speculative iteration: draft k (+1 cache-filling) tokens
        with the sparse twin, verify the chunk with ONE target call
        enqueued behind the draft, then accept the longest agreeing
        prefix on the host.  Emitted tokens are ALWAYS the verify's
        target selections — the drafted token at index j only gates
        whether the selection conditioned on it is usable — so the
        stream is the spec-off stream; speculation changes how many
        tokens one iteration yields (1 to k+1)."""
        cfg = self.cfg
        k = self._spec.k
        active = [s for s in range(cfg.slots) if self._active_mask[s]]
        if not active:
            return False
        for s in active:
            self._ensure_pages(s, min(int(self._lengths[s]) + 1 + k,
                                      cfg.cap))
        nb = cfg.bucket_pages(
            min(int(self._lengths[active].max()) + 1 + k, cfg.cap))
        self._flush_fresh_scales()
        sampling = self._sampling()
        lengths = self._lengths.copy()
        last = self._last_tokens.copy()
        act = self._active_mask.copy()
        # any sampled slot routes the iteration to the scan verify: the
        # top-k/top-p thresholds are discontinuous in the chunk pass's
        # last-ulp logit drift
        sampled = bool(np.any(self._temps[active] > 0.0))
        with torch.no_grad(), self.adapter.weights():
            d_toks = self._draft(nb, lengths, last, act, sampling)
            g_toks, g_logps = self._verify(nb, lengths, last, d_toks, act,
                                           sampling, force_scan=sampled)
        d_host = d_toks.cpu().numpy()                      # (S, k+1)
        g_toks = g_toks.cpu().numpy()
        g_logps = g_logps.cpu().numpy()
        now = time.time()
        self.stats["steps"] += 1
        drafted = accepted = rejected = 0
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
            drafted += k
            accepted += min(max(emitted - 1, 0), k)
            rejected += 1 if mismatch else 0
            self.stats["tokens"] += emitted
        self.stats["spec_drafted"] += drafted
        self.stats["spec_accepted"] += accepted
        self.stats["spec_rejected"] += rejected
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
            prompt = self.adapter.prepare(req.tokens)
            max_new = min(req.max_new_tokens or self.cfg.max_new_tokens,
                          self.cfg.cap - len(prompt))
            with self.adapter.weights():
                out.append(self._static_one(req, prompt, max_new))
        return out

    @torch.no_grad()
    def _static_one(self, req: DecodeRequest, prompt: np.ndarray,
                    max_new: int) -> DecodeResult:
        cfg = self.cfg
        a = self.adapter
        B = 2                                  # duplicated row
        sampling = _Sampling([req.seed] * B, [req.temperature] * B,
                             [req.top_k] * B, [req.top_p] * B)
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
            tok, logp = sampling.select(
                logits[:, real - 1], self._base_key,
                self._t([p0 + real] * B, torch.long))
        gen = [int(tok[0])]
        total = np.float32(logp[0].item())
        reason = "eos" if gen[0] == cfg.eos_id else "length"
        pos = len(prompt)
        while reason != "eos" and len(gen) < max_new:
            logits, kbuf, vbuf, _, _ = a.chunk_forward(
                tok[:, None], self._t([pos, pos], torch.long), kbuf, vbuf)
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
