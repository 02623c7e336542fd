"""Port kernel layer (bigdl_tpu_torch.ops) against the JAX package.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version there).  Here the plain version — the path a
CPU tensor takes through the wrapper — is held against the JAX Pallas
kernel in interpret mode, and the wrapper's checks and device rules
are pinned."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops.flash_attention import \
    paged_decode_attention as jax_paged_decode_attention
from bigdl_tpu_torch.ops import (LAUNCHES, cdiv, paged_decode_attention,
                                 paged_decode_attention_ref, resolve_device,
                                 round_up)
from bigdl_tpu_torch.ops import _build


def _case(seed=0, S=4, h=4, page=4, hd=8, nb=4):
    rs = np.random.RandomState(seed)
    P = S * nb
    q = rs.randn(S, h, hd).astype(np.float32)
    kp = rs.randn(P, h, page, hd).astype(np.float32)
    vp = rs.randn(P, h, page, hd).astype(np.float32)
    pt = rs.permutation(P).reshape(S, nb).astype(np.int32)
    lengths = np.array([0, 3, 7, 14], np.int32)[:S]
    return q, kp, vp, pt, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("block_h", [1, 2, 4])
def test_plain_version_matches_jax_kernel(block_h):
    # lengths 0 / 3 / 7 / 14: empty-but-one, inside a page, a page edge
    # minus one, and the last page of the table
    q, kp, vp, pt, lengths = _case()
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lengths), block_h=block_h, interpret=True))
    got = paged_decode_attention_ref(*_torch(q, kp, vp, pt, lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_takes_plain_version_with_strided_table():
    """The engine passes ``page_table[:, :n_blocks]`` — a row-strided
    view; the wrapper accepts it and counts no kernel launch on the
    CPU."""
    q, kp, vp, pt, lengths = _case(seed=1)
    wide = np.concatenate([pt, np.zeros_like(pt)], axis=1)
    view = torch.from_numpy(wide)[:, :pt.shape[1]]
    assert not view.is_contiguous()
    before = dict(LAUNCHES)
    got = paged_decode_attention(*_torch(q, kp, vp), view,
                                 torch.from_numpy(lengths))
    want = paged_decode_attention_ref(*_torch(q, kp, vp, pt, lengths))
    assert torch.equal(got, want)
    assert dict(LAUNCHES) == before


def test_explicit_scale_matches_jax():
    q, kp, vp, pt, lengths = _case(seed=2)
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lengths), sm_scale=0.3, block_h=1, interpret=True))
    got = paged_decode_attention(*_torch(q, kp, vp, pt, lengths),
                                 sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_int8_pages_refused():
    q, kp, vp, pt, lengths = _torch(*_case())
    with pytest.raises(ValueError, match="int8"):
        paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8), pt,
                               lengths)


def test_shape_mismatch_refused():
    q, kp, vp, pt, lengths = _torch(*_case())
    with pytest.raises(ValueError, match="do not match"):
        paged_decode_attention(q[:, :2], kp, vp, pt, lengths)
    with pytest.raises(ValueError, match="slots"):
        paged_decode_attention(q, kp, vp, pt[:2], lengths)


def test_non_cpu_tensor_without_cuda_raises():
    """A tensor off the CPU never reaches the plain version: without a
    CUDA kernel for it, the call raises."""
    q, kp, vp, pt, lengths = (t.to("meta") for t in _torch(*_case()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_decode_attention(q, kp, vp, pt, lengths)


def test_mixed_devices_refused():
    q, kp, vp, pt, lengths = _torch(*_case())
    with pytest.raises(ValueError, match="one device"):
        paged_decode_attention(q, kp, vp, pt, lengths.to("meta"))


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cdiv_round_up():
    assert [cdiv(a, 4) for a in (0, 1, 4, 5)] == [0, 1, 1, 2]
    assert [round_up(a, 8) for a in (0, 1, 8, 9)] == [0, 8, 8, 16]


def test_build_targets_named_by_source_hash(tmp_path, monkeypatch):
    """Every csrc/*.cu maps to its own library under build/, named by a
    hash of the sources: an edited source never loads a stale build."""
    names = [s.stem for s in _build.sources()]
    assert "paged_decode_attention" in names
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target(src)
    src.write_text("// two\n")
    assert _build._target(src) != first
    assert first.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "bigdl_tpu_torch")


def test_ops_import_builds_nothing():
    """Importing the kernel layer runs no compiler and loads no library
    (the CPU tests import every module)."""
    code = ("import bigdl_tpu_torch.ops as o, bigdl_tpu_torch.ops._build as b;"
            "assert not b._libs and not b.BUILD_LOGS")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
