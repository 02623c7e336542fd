"""Seq2Seq decode service — the port of ``bigdl_tpu.serving.seq2seq``:
serving ``translate(src_batch)`` for a translation-mode Transformer.

Greedy and sampled requests run through the paged continuous decode
engine (:class:`~bigdl_tpu_torch.serving.decode_engine.DecodeEngine` over
a :class:`~bigdl_tpu_torch.serving.decode_engine.Seq2SeqAdapter`): the
encoder runs at admission, every decoder layer's self-attention goes
through the paged decode kernel on CUDA, and a short translation frees
its slot mid-flight.  ``continuous=False`` decodes each request alone
with the engine's ``static_generate`` (its own reference).  Beam search
(``beam_size > 1``) runs the whole batch through ``nn.attention.
transformer_decode``, bucketed: beams reorder the cache every step,
which the slot engine does not model."""

import itertools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.tensor.policy import apply_precision_policy


class Seq2SeqService:
    """Holds a translation-mode :class:`~bigdl_tpu_torch.nn.Transformer`
    on ``device`` (``cuda`` unless the caller asks for another, e.g.
    ``device="cpu"``) and serves ``translate(src_batch)``.

    ``beam_size`` 0 or 1 decodes greedily through the continuous engine;
    more is beam search with the GNMT length penalty; ``sample=True``
    samples (temperature, top-k, top-p) with a per-request seed, so the
    engine's output does not depend on the traffic it rides with."""

    BATCH_BUCKETS: Tuple[int, ...] = (1, 4, 16, 64)

    def __init__(self, model, bos_id: int, eos_id: int, max_len: int = 32,
                 beam_size: int = 0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 continuous: bool = True,
                 src_buckets: Sequence[int] = (8, 16, 32, 64),
                 decode_config=None, device=None):
        if sample and beam_size and beam_size > 1:
            raise ValueError("sample=True and beam_size>1 are exclusive")
        if getattr(model, "mode", None) != "translation":
            raise ValueError("Seq2SeqService needs a translation-mode "
                             "Transformer")
        self.device = resolve_device(device)
        apply_precision_policy()
        self.model = model.to(self.device).eval()
        self.bos_id, self.eos_id = bos_id, eos_id
        self.max_len = max_len
        self.beam_size = beam_size
        self.buckets = tuple(batch_buckets or self.BATCH_BUCKETS)
        self.sample = bool(sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.continuous = bool(continuous)
        self.src_buckets = tuple(sorted(src_buckets))
        self._seed_int = int(seed)
        # each request's seed; next() on a count is atomic under the GIL
        self._request_ids = itertools.count(1)
        self._decode_cfg = decode_config
        self.decode_engine = None       # built at the first translate
        self._engine_lock = threading.Lock()

    # -- engine plumbing ----------------------------------------------------
    def _engine(self):
        with self._engine_lock:
            if self.decode_engine is None:
                from bigdl_tpu_torch.serving.decode_engine import (
                    DecodeConfig, DecodeEngine, Seq2SeqAdapter)

                cfg = self._decode_cfg
                if cfg is None:
                    page = 8
                    cap = self.max_len + 1
                    cfg = DecodeConfig(
                        slots=8, page_size=page,
                        pages_per_slot=max(1, -(-cap // page)),
                        prompt_chunk=8, max_new_tokens=self.max_len,
                        eos_id=self.eos_id, base_seed=self._seed_int)
                adapter = Seq2SeqAdapter(self.model, cap=cfg.cap,
                                         bos_id=self.bos_id,
                                         src_buckets=self.src_buckets)
                self.decode_engine = DecodeEngine(adapter, cfg,
                                                  name="seq2seq")
            return self.decode_engine

    def _requests(self, src: np.ndarray):
        from bigdl_tpu_torch.serving.decode_engine import DecodeRequest

        temp = self.temperature if self.sample else 0.0
        return [DecodeRequest(
            tokens=row, max_new_tokens=self.max_len, temperature=temp,
            top_k=self.top_k, top_p=self.top_p,
            seed=next(self._request_ids)) for row in src]

    def _assemble(self, results) -> Tuple[np.ndarray, np.ndarray]:
        """Engine results as (tokens (n, max_len+1) with BOS first and
        EOS padding, summed log-probs (n,))."""
        n = len(results)
        tokens = np.full((n, self.max_len + 1), self.eos_id, np.int32)
        tokens[:, 0] = self.bos_id
        scores = np.zeros((n,), np.float32)
        for i, res in enumerate(results):
            gen = res.tokens[:self.max_len]
            tokens[i, 1:1 + len(gen)] = gen
            scores[i] = np.float32(res.logp)
        return tokens, scores

    # -- beam search --------------------------------------------------------
    def _translate_beam(self, src) -> Tuple[np.ndarray, np.ndarray]:
        from bigdl_tpu_torch.nn.attention import transformer_decode

        n = src.shape[0]
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:          # larger than the largest bucket
            big = self.buckets[-1]
            outs = [self._translate_beam(src[i:i + big])
                    for i in range(0, n, big)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        if bucket > n:
            src = np.concatenate(
                [src, np.repeat(src[-1:], bucket - n, axis=0)])
        toks, scores = transformer_decode(
            self.model, torch.from_numpy(src).to(self.device), self.bos_id,
            self.eos_id, max_len=self.max_len, beam_size=self.beam_size)
        # the best beam
        return (toks[:, 0].cpu().numpy()[:n].astype(np.int32),
                scores[:, 0].float().cpu().numpy()[:n])

    # -- public surface -----------------------------------------------------
    def translate(self, src) -> Tuple[np.ndarray, np.ndarray]:
        """``src`` (n, t_src) int tokens -> (tokens (n, max_len+1) with
        BOS, scores (n,)).  Greedy and sampled requests run through the
        continuous engine, queued together (or, with
        ``continuous=False``, each alone through its static reference);
        they may also be a list of n sources of different lengths, each
        encoded at its own source bucket.  Beam requests take the
        bucketed whole-batch path."""
        if self.beam_size and self.beam_size > 1:
            return self._translate_beam(np.asarray(src, np.int32))
        if isinstance(src, (list, tuple)):
            src = [np.asarray(row, np.int32).reshape(-1) for row in src]
        else:
            src = np.asarray(src, np.int32)
        engine = self._engine()
        reqs = self._requests(src)
        if self.continuous:
            engine.submit_many(reqs)
            results = [r.wait(timeout=300.0) for r in reqs]
        else:
            results = engine.static_generate(reqs)
        return self._assemble(results)

    def warmup(self) -> "Seq2SeqService":
        """The engine's closed program set (captured as CUDA graphs on
        the card) and the encoder at every source bucket, before
        traffic, inside ``obs.attr.expected_compile``."""
        from bigdl_tpu_torch.obs.attr import expected_compile

        if not (self.beam_size and self.beam_size > 1):
            with expected_compile():
                self._engine().warmup()
        return self

    def stop(self) -> None:
        if self.decode_engine is not None:
            self.decode_engine.stop()
