"""The paged verify kernel's split walk (``paged_verify_attention.cu``),
modelled in plain torch and argued on the CPU before any card run.

The kernel takes the decode kernel's split (``decode_chunks``: chunks of
whole pages, a grid from the page size and the table's width alone,
never from ``positions``).  Each chunk writes one partial (m, l,
acc[head_dim]) per query of the slot: query ``c`` sees the chunk's keys
at positions ``<= positions[s] + c`` (the staircase), and a chunk that
holds none of them writes l = 0 for that query; a chunk that starts past
the slot's last visible key ``positions[s] + C - 1`` writes l = 0 for
every query.  A second pass merges each query's non-empty partials in
chunk order.  The model below does the same in float32, an int8 page's
scale applied to the score and to p as the kernel applies it, and is
held to the JAX ``paged_verify_attention`` (its Pallas kernel in
interpret mode, with ``k_scales``/``v_scales`` for int8 pages) and to the
port's plain version within ``chip_smoke.py``'s RTOL / ATOL, at C = 1, 5
and 9, at positions 0, page - 1 and page, at chunk edges, with the last
chunks empty, running off the table, and at a table width that is not a
multiple of the chunk."""

import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops.flash_attention import \
    paged_verify_attention as jax_paged_verify_attention
from bigdl_tpu_torch.ops.flash_attention import (decode_chunks,
                                                 paged_verify_attention,
                                                 paged_verify_attention_ref)
from bigdl_tpu_torch.ops.quantized import quantize_pages

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
RTOL, ATOL = smoke.RTOL, smoke.ATOL


def _partials(q, kp, vp, pt, positions, ks, vs, scale):
    """(m, l, acc) of every (slot, head, query, chunk), as the split
    kernel writes them: (S, h, C, n_chunks) twice and (S, h, C, n_chunks,
    d).  An empty partial's acc is NaN here: the merge must never read
    it."""
    S, h, C, d = q.shape
    page, nb = kp.shape[2], pt.shape[1]
    chunk_pages, n_chunks = decode_chunks(page, nb)
    ck = chunk_pages * page
    m = torch.full((S, h, C, n_chunks), float("-inf"))
    l = torch.zeros(S, h, C, n_chunks)
    acc = torch.full((S, h, C, n_chunks, d), float("nan"))
    for s in range(S):
        pos = int(positions[s])
        # the keys the block walks: up to the last query's, capped by the
        # table's width
        n_keys = min(pos + C, nb * page)
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
            for cq in range(C):
                vis = keys <= pos + cq                    # the staircase
                if not bool(vis.any()):
                    continue                              # l stays 0
                sc = torch.einsum("hd,nhd->nh", q[s, :, cq], krow) * (
                    scale * ksc)
                sc = sc[vis]
                mc = sc.amax(0)
                p = torch.exp(sc - mc)
                pv = p * (vsc[vis] if vs is not None else 1.0)
                m[s, :, cq, c] = mc
                l[s, :, cq, c] = p.sum(0)
                acc[s, :, cq, c] = torch.einsum("nh,nhd->hd", pv, vrow[vis])
    return m, l, acc


def _merge(m, l, acc):
    """The merge kernel, one row a (slot, head, query): chunks with l > 0
    are 0 .. n_used - 1; their weights exp(m_c - max), the sums taken in
    chunk order."""
    S, h, C, n_chunks, d = acc.shape
    out = torch.zeros(S, h, C, d)
    for idx in np.ndindex(S, h, C):
        used = int((l[idx] > 0).sum())
        assert bool((l[idx][:used] > 0).all())   # no gap
        if used == 0:
            continue
        mx = m[idx][:used].max()
        num, den = torch.zeros(d), torch.zeros(())
        for c in range(used):
            e = torch.exp(m[idx][c] - mx)
            num = num + acc[idx][c] * e
            den = den + l[idx][c] * e
        out[idx] = num / (den if den != 0 else 1.0)
    return out


def _case(page, nb, C, int8, seed=0, h=2, d=16):
    chunk_pages, _ = decode_chunks(page, nb)
    ck, full = chunk_pages * page, nb * page
    positions = np.array([0, page - 1, page,
                          ck - C,    # the last query on a chunk's last key
                          ck - 1,    # the queries straddle a chunk edge
                          ck,        # the first query starts a chunk
                          ck // 2,   # later chunks all empty
                          full - C,  # the last query on the table's last key
                          full - 1],  # the queries run off the table
                         np.int32)
    positions = np.maximum(positions, 0)
    S = len(positions)
    rs = np.random.RandomState(seed)
    P = S * nb + 3
    q = rs.randn(S, h, C, d).astype(np.float32)
    kp = rs.randn(P, h, page, d).astype(np.float32)
    vp = rs.randn(P, h, page, d).astype(np.float32)
    pt = rs.permutation(P)[:S * nb].reshape(S, nb).astype(np.int32)
    scales = {}
    if int8:
        kq, ks = quantize_pages(torch.from_numpy(kp))
        vq, vs = quantize_pages(torch.from_numpy(vp))
        kp, vp = kq.numpy(), vq.numpy()
        scales = dict(k_scales=ks.numpy(), v_scales=vs.numpy())
    return q, kp, vp, pt, positions, scales


def test_verify_takes_the_decode_split_of_the_table_alone():
    """The chunk plan is a function of (page size, table width): the same
    for every chunk of queries and every position."""
    assert decode_chunks(16, 64) == (8, 8)
    assert decode_chunks(16, 20) == (8, 3)       # not a whole chunk
    assert decode_chunks(8, 20) == (16, 2)
    assert list(inspect.signature(decode_chunks).parameters) == \
        ["page", "n_blocks"]


# pages of 16 (chunks of 8 pages) and of 8 (16 pages); 20-page tables,
# not a whole number of chunks; C = 1 (a decode step), 5 (k = 4) and 9
@pytest.mark.parametrize("C", [1, 5, 9])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page", [16, 8])
def test_split_walk_matches_jax_and_plain(int8, page, C):
    nb = 20
    q, kp, vp, pt, positions, sc = _case(page, nb, C, int8, seed=C)
    d = q.shape[3]
    scale = d ** -0.5
    jsc = {k: jnp.asarray(v) for k, v in sc.items()}
    want_jax = torch.from_numpy(np.array(jax_paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(positions), block_h=1, interpret=True, **jsc)))
    tsc = {k: torch.from_numpy(v) for k, v in sc.items()}
    args = [torch.from_numpy(x) for x in (q, kp, vp, pt, positions)]
    plain = paged_verify_attention_ref(*args, **tsc)
    m, l, acc = _partials(*args, tsc.get("k_scales"), tsc.get("v_scales"),
                          scale)
    # a (slot, query)'s chunks past its last visible key are empty, and
    # only those
    chunk_pages, n_chunks = decode_chunks(page, nb)
    ck = chunk_pages * page
    for s, pos in enumerate(positions):
        for cq in range(C):
            used = -(-min(int(pos) + cq + 1, nb * page) // ck)
            assert bool((l[s, :, cq, :used] > 0).all())
            assert bool((l[s, :, cq, used:] == 0).all()) and used <= n_chunks
    got = _merge(m, l, acc)
    assert torch.isfinite(got).all()
    for want in (want_jax, plain):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version():
    q, kp, vp, pt, positions, sc = _case(16, 10, 5, True)
    args = [torch.from_numpy(x) for x in (q, kp, vp, pt, positions)]
    tsc = {k: torch.from_numpy(v) for k, v in sc.items()}
    assert torch.equal(paged_verify_attention(*args, **tsc),
                       paged_verify_attention_ref(*args, **tsc))
