"""The paged decode kernel's split walk (``paged_decode_attention.cu``),
modelled in plain torch and argued on the CPU before any card run.

The kernel cuts each slot's keys into chunks of whole pages
(``decode_chunks``: the grid comes from the page size and the table's
width alone, never from ``lengths``).  Each chunk writes a partial
(m, l, acc[head_dim]) of its keys; a chunk that starts past its slot's
inclusive length has no keys and writes l = 0.  A second pass merges a
(slot, head)'s non-empty partials in chunk order.  The model below does
the same in float32, an int8 page's scale applied to the score and to p
as the kernel applies it, and is held to the JAX ``paged_decode_attention``
(its Pallas kernel in interpret mode, with ``k_scales``/``v_scales`` for
int8 pages) and to the port's plain version within ``chip_smoke.py``'s
RTOL / ATOL, at lengths 0, page - 1 and page, chunk - 1 and chunk, a
length whose last chunks are all empty, the full table, and a table
width that is not a multiple of the chunk."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops.flash_attention import \
    paged_decode_attention as jax_paged_decode_attention
from bigdl_tpu_torch.ops.flash_attention import (DECODE_CHUNK_KEYS,
                                                 decode_chunks,
                                                 paged_decode_attention,
                                                 paged_decode_attention_ref)
from bigdl_tpu_torch.ops.quantized import quantize_pages

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
RTOL, ATOL = smoke.RTOL, smoke.ATOL


def _partials(q, kp, vp, pt, lengths, ks, vs, scale):
    """(m, l, acc) of every (slot, head, chunk), as the split kernel
    writes them: (S, h, n_chunks), (S, h, n_chunks), (S, h, n_chunks, d).
    An empty chunk's acc is NaN here: the merge must never read it."""
    S, h, d = q.shape
    page, nb = kp.shape[2], pt.shape[1]
    chunk_pages, n_chunks = decode_chunks(page, nb)
    ck = chunk_pages * page
    m = torch.full((S, h, n_chunks), float("-inf"))
    l = torch.zeros(S, h, n_chunks)
    acc = torch.full((S, h, n_chunks, d), float("nan"))
    for s in range(S):
        n_keys = min(int(lengths[s]) + 1, nb * page)
        for c in range(n_chunks):
            n_here = max(0, min(ck, n_keys - c * ck))
            if n_here == 0:
                continue
            keys = c * ck + torch.arange(n_here)
            pids = pt[s, keys // page].long()
            krow = kp[pids, :, keys % page].float()       # (n, h, d)
            vrow = vp[pids, :, keys % page].float()
            ksc = ks[pids][:, None] if ks is not None else 1.0
            vsc = vs[pids][:, None] if vs is not None else 1.0
            sc = torch.einsum("hd,nhd->nh", q[s], krow) * (scale * ksc)
            mc = sc.amax(0)
            p = torch.exp(sc - mc)
            m[s, :, c] = mc
            l[s, :, c] = p.sum(0)
            acc[s, :, c] = torch.einsum("nh,nhd->hd", p * vsc, vrow)
    return m, l, acc


def _merge(m, l, acc):
    """The merge kernel: chunks with l > 0 are 0 .. n_used - 1; their
    weights exp(m_c - max), the sums taken in chunk order."""
    S, h, n_chunks, d = acc.shape
    out = torch.zeros(S, h, d)
    for s in range(S):
        for hh in range(h):
            used = int((l[s, hh] > 0).sum())
            assert bool((l[s, hh, :used] > 0).all())   # no gap
            if used == 0:
                continue
            mx = m[s, hh, :used].max()
            num, den = torch.zeros(d), torch.zeros(())
            for c in range(used):
                e = torch.exp(m[s, hh, c] - mx)
                num = num + acc[s, hh, c] * e
                den = den + l[s, hh, c] * e
            out[s, hh] = num / (den if den != 0 else 1.0)
    return out


def _case(page, nb, int8, seed=0, h=2, d=16):
    chunk_pages, _ = decode_chunks(page, nb)
    ck, full = chunk_pages * page, nb * page - 1
    lengths = np.array([0, page - 1, page, ck - 1, ck,
                        ck // 2,             # later chunks all empty
                        full - 1, full], np.int32)
    S = len(lengths)
    rs = np.random.RandomState(seed)
    P = S * nb + 3
    q = rs.randn(S, h, d).astype(np.float32)
    kp = rs.randn(P, h, page, d).astype(np.float32)
    vp = rs.randn(P, h, page, d).astype(np.float32)
    pt = rs.permutation(P)[:S * nb].reshape(S, nb).astype(np.int32)
    scales = {}
    if int8:
        kq, ks = quantize_pages(torch.from_numpy(kp))
        vq, vs = quantize_pages(torch.from_numpy(vp))
        kp, vp = kq.numpy(), vq.numpy()
        scales = dict(k_scales=ks.numpy(), v_scales=vs.numpy())
    return q, kp, vp, pt, lengths, scales


def test_chunks_follow_the_table_width_alone():
    assert decode_chunks(16, 64) == (DECODE_CHUNK_KEYS // 16, 8)
    assert decode_chunks(16, 10) == (8, 2)       # not a whole chunk
    assert decode_chunks(32, 10) == (4, 3)
    assert decode_chunks(1, 5) == (128, 1)       # one table entry a thread
    assert decode_chunks(256, 3) == (1, 3)       # a page larger than a chunk


# pages of 16 (chunks of 8 pages) and of 8 (16 pages); 20-page tables,
# not a whole number of chunks
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page", [16, 8])
def test_split_walk_matches_jax_and_plain(int8, page):
    nb = 20
    q, kp, vp, pt, lengths, sc = _case(page, nb, int8)
    d = q.shape[2]
    scale = d ** -0.5
    jsc = {k: jnp.asarray(v) for k, v in sc.items()}
    want_jax = torch.from_numpy(np.array(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lengths), block_h=1, interpret=True, **jsc)))
    tsc = {k: torch.from_numpy(v) for k, v in sc.items()}
    args = [torch.from_numpy(x) for x in (q, kp, vp, pt, lengths)]
    plain = paged_decode_attention_ref(*args, **tsc)
    m, l, acc = _partials(*args[:4], args[4], tsc.get("k_scales"),
                          tsc.get("v_scales"), scale)
    # every slot's chunks past its length are empty, and only those
    _, n_chunks = decode_chunks(page, nb)
    ck = decode_chunks(page, nb)[0] * page
    for s, n in enumerate(lengths):
        used = -(-min(int(n) + 1, nb * page) // ck)
        assert bool((l[s, :, :used] > 0).all())
        assert bool((l[s, :, used:] == 0).all()) and used <= n_chunks
    got = _merge(m, l, acc)
    assert torch.isfinite(got).all()
    for want in (want_jax, plain):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version():
    q, kp, vp, pt, lengths, _ = _case(16, 10, False)
    args = [torch.from_numpy(x) for x in (q, kp, vp, pt, lengths)]
    assert torch.equal(paged_decode_attention(*args),
                       paged_decode_attention_ref(*args))
