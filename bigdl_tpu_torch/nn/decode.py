"""Sequence decoding — the port of ``bigdl_tpu.nn.decode``: batched beam
search with the GNMT length penalty, greedy decode, and sampling with
temperature, top-k and top-p.

The caller gives ``step_fn(last_tokens, state) -> (logits, new_state)``
where ``last_tokens`` is (batch * beam,) and every tensor of ``state``
(a tensor, or nested tuples, lists and dicts of them) has that leading
dim.  Each decode is ``max_len`` steps of fixed shapes, as the JAX
package's one ``lax.scan``; beams are reordered by gathers.  Ties are
broken as JAX breaks them: top-k and the final order keep the lower
index first (stable sorts), argmax takes the first maximum.  The
sampled draw is ``jax.random.categorical`` on the port's threefry
(``utils.prng``): the argmax of the logits plus Gumbel noise
``-log(-log(u))``, ``u = uniform(key_t, (batch, vocab), tiny, 1)`` with
``key_t`` the t-th of ``prng.split(key, max_len)``, so a key draws the
JAX package's tokens."""

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils import prng

NEG_INF = -1.0e9


class DecodeResult(NamedTuple):
    tokens: torch.Tensor      # (batch, beam, max_len+1) with the leading BOS
    scores: torch.Tensor      # (batch, beam) length-normalized log prob
    log_probs: torch.Tensor   # (batch, beam) summed log prob
    lengths: torch.Tensor     # (batch, beam) tokens up to and with EOS


def tree_map(fn, tree):
    """``fn`` on every tensor of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _length_penalty(lengths, alpha: float):
    """GNMT: ((5 + len) / 6) ** alpha."""
    return ((5.0 + lengths.float()) / 6.0) ** alpha


def _lengths(tokens, eos_id: int, max_len: int):
    """Position of the first EOS after BOS (inclusive), else max_len."""
    is_eos = tokens[..., 1:] == eos_id
    first = torch.argmax(is_eos.int(), dim=-1) + 1
    return torch.where(is_eos.any(dim=-1), first,
                       torch.full_like(first, max_len))


def _top(x, k: int):
    """The ``k`` largest of the last dim and their indices, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(step_fn: Callable[[torch.Tensor, Any],
                                  Tuple[torch.Tensor, Any]],
                init_state: Any, batch_size: int, vocab_size: int,
                bos_id: int, eos_id: int, beam_size: int = 4,
                max_len: int = 32, length_penalty: float = 0.6,
                device=None) -> DecodeResult:
    """Batched beam search; ``init_state``'s tensors have leading dim
    ``batch_size`` and are tiled to batch x beam here.  Beams come back
    sorted by normalized score, best first."""
    B, K, V = batch_size, beam_size, vocab_size
    state = tree_map(lambda a: torch.repeat_interleave(a, K, dim=0),
                     init_state)
    tokens = torch.full((B, K, max_len + 1), bos_id, dtype=torch.int32,
                        device=device)
    # only beam 0 is live at first (identical beams would collapse top-k)
    logp = torch.full((B, K), NEG_INF, device=device)
    logp[:, 0] = 0.0
    finished = torch.zeros(B, K, dtype=torch.bool, device=device)
    eos_row = torch.full((V,), NEG_INF, device=device)
    eos_row[eos_id] = 0.0
    rows = torch.arange(B, device=device)[:, None] * K
    for t in range(max_len):
        lp, new_state = step_fn(tokens[:, :, t].reshape(B * K), state)
        lp = torch.log_softmax(lp.float(), dim=-1).reshape(B, K, V)
        # finished beams extend only with EOS, at no cost
        lp = torch.where(finished[:, :, None], eos_row, lp)
        cand = logp[:, :, None] + lp
        logp, top_idx = _top(cand.reshape(B, K * V), K)
        beam_idx = top_idx // V
        tok = (top_idx % V).to(torch.int32)
        tokens = torch.gather(tokens, 1, beam_idx[:, :, None].expand(
            -1, -1, max_len + 1)).clone()
        tokens[:, :, t + 1] = tok
        finished = torch.gather(finished, 1, beam_idx) | (tok == eos_id)
        flat_idx = (rows + beam_idx).reshape(-1)
        state = tree_map(lambda a: a[flat_idx], new_state)
    lengths = _lengths(tokens, eos_id, max_len)
    scores = logp / _length_penalty(lengths, length_penalty)
    order = torch.argsort(-scores, dim=1, stable=True)
    return DecodeResult(
        tokens=torch.gather(tokens, 1, order[:, :, None].expand(
            -1, -1, max_len + 1)),
        scores=torch.gather(scores, 1, order),
        log_probs=torch.gather(logp, 1, order),
        lengths=torch.gather(lengths, 1, order))


def greedy_decode(step_fn, init_state: Any, batch_size: int, bos_id: int,
                  eos_id: int, max_len: int = 32, device=None):
    """Argmax decode.  Returns (tokens (B, max_len+1), log_probs (B,),
    lengths (B,))."""
    return _decode(step_fn, init_state, batch_size, bos_id, eos_id,
                   max_len, device, lambda logits, lp, t: torch.argmax(
                       lp, dim=-1))


def sample_decode(step_fn, init_state: Any, batch_size: int, bos_id: int,
                  eos_id: int, key, max_len: int = 32,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, device=None):
    """Sampled decode: temperature, then top-k (below the k-th logit
    dropped), then top-p (a token whose sorted cumulative mass before
    it already reaches ``top_p`` dropped, so the token crossing the
    threshold stays), then one categorical draw a step from ``key``
    (``utils.prng``).  ``temperature <= 0`` is greedy.  The log-probs
    add the unfiltered log-likelihood of the drawn tokens.  Returns
    (tokens, log_probs, lengths) as :func:`greedy_decode`."""
    keys = prng.split(key, max_len)
    tiny = float(np.finfo(np.float32).tiny)

    def select(logits, lp, t):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        z = logits / temperature
        if top_k and top_k > 0:
            kth = _top(z, top_k)[0][:, -1:]
            z = torch.where(z < kth, -torch.inf, z)
        if top_p < 1.0:
            zs = torch.sort(z, dim=-1, descending=True).values
            ps = torch.softmax(zs, dim=-1)
            keep = (torch.cumsum(ps, dim=-1) - ps) < top_p
            minz = torch.where(keep, zs, torch.inf).amin(dim=-1,
                                                         keepdim=True)
            z = torch.where(z < minz, -torch.inf, z)
        u = prng.uniform(keys[t], tuple(z.shape), tiny, 1.0)
        return torch.argmax(z - torch.log(-torch.log(u)), dim=-1)

    return _decode(step_fn, init_state, batch_size, bos_id, eos_id,
                   max_len, device, select)


def _decode(step_fn, state, B, bos_id, eos_id, max_len, device, select):
    tokens = torch.full((B, max_len + 1), bos_id, dtype=torch.int32,
                        device=device)
    logp = torch.zeros(B, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    eos = torch.full((B,), eos_id, dtype=torch.int32, device=device)
    for t in range(max_len):
        logits, state = step_fn(tokens[:, t], state)
        logits = logits.float()
        lp = torch.log_softmax(logits, dim=-1)
        tok = torch.where(finished, eos,
                          select(logits, lp, t).to(torch.int32))
        step_lp = lp.gather(-1, tok.long()[:, None])[:, 0]
        logp = logp + torch.where(finished, torch.zeros_like(step_lp),
                                  step_lp)
        tokens[:, t + 1] = tok
        finished = finished | (tok == eos_id)
    return tokens, logp, _lengths(tokens, eos_id, max_len)
