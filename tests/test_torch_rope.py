"""The port's qk-norm + RoPE pass against the JAX package's ``ops/rope.py``.

Inputs are drawn with numpy from a seed and handed to both packages, in
float32.  The plain version of kernel B7 (what ``rope_qk_norm_forward`` runs
on the CPU) is held to the JAX reference and to the JAX Pallas kernel in
interpret mode, and the autograd Function to ``jax.vjp``; the card holds B7
to the plain version in ``test_torch_kernels.py``.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import rope

jrope = importlib.import_module("skrample_tpu.ops.rope")

B, N, HEADS, D = 2, 256, 2, 128


def _inputs(seed: int, n: int = N) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, n, 3 * HEADS * D), dtype=np.float32) * np.float32(2)
    gq = np.float32(1) + rng.standard_normal(D, dtype=np.float32) * np.float32(0.2)
    gk = np.float32(1) + rng.standard_normal(D, dtype=np.float32) * np.float32(0.2)
    angles = rng.uniform(0, 40, (n, D // 2)).astype(np.float32)
    return qkv, gq, gk, np.cos(angles), np.sin(angles)


def _t(arrays: tuple[np.ndarray, ...]) -> list[torch.Tensor]:
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
def test_plain_rope_matches_jax(oracle: str) -> None:
    """B7's plain version vs the JAX reference and the Pallas kernel (interpret mode): f32,
    rtol 1e-5 (the sum of squares in another order); the v third bit-equal, untouched."""
    args = _inputs(0)
    jargs = [jnp.asarray(a) for a in args]
    if oracle == "reference":
        want = jrope.rope_qk_norm_reference(*jargs, HEADS)
    else:
        want = jrope.rope_qk_norm_forward(*jargs, HEADS, block_n=128, interpret=True)
    got = rope.rope_qk_norm_forward(*_t(args), HEADS)
    assert got.shape == args[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    v = slice(2 * HEADS * D, None)
    np.testing.assert_array_equal(got.numpy()[..., v], args[0][..., v])


def test_rope_tables_may_be_row_views() -> None:
    "A stream's rows of larger joint tables (a view, as the double blocks pass them) give the same result."
    qkv, gq, gk, cos, sin = _inputs(1)
    tall_cos = np.concatenate([np.ones((128, D // 2), np.float32), cos])
    tall_sin = np.concatenate([np.zeros((128, D // 2), np.float32), sin])
    want = rope.rope_qk_norm_reference(*_t((qkv, gq, gk, cos, sin)), HEADS)
    view = rope.rope_qk_norm_forward(
        *_t((qkv, gq, gk)), torch.from_numpy(tall_cos)[128:], torch.from_numpy(tall_sin)[128:], HEADS
    )
    assert torch.equal(view, want)


def test_fused_rope_grads_match_jax_vjp() -> None:
    """Autograd through ``fused_rope_qk_norm`` (B7 forward, the plain version's gradient backward)
    vs ``jax.vjp`` of the JAX ``fused_rope_qk_norm``: output rtol 1e-5; qkv and gain gradients rtol
    1e-4, with an atol of 1e-5 of each one's largest value (the gains' gradients sum over tokens)."""
    qkv, gq, gk, cos, sin = _inputs(2)
    g = np.random.default_rng(3).standard_normal(qkv.shape, dtype=np.float32)
    want, vjp = jax.vjp(
        lambda a, q, k: jrope.fused_rope_qk_norm(a, q, k, jnp.asarray(cos), jnp.asarray(sin), HEADS),
        jnp.asarray(qkv),
        jnp.asarray(gq),
        jnp.asarray(gk),
    )
    want_grads = vjp(jnp.asarray(g))

    inputs = [t.requires_grad_(True) for t in _t((qkv, gq, gk))]
    before = rope.rope_qk_norm_forward.launches
    out = rope.fused_rope_qk_norm(*inputs, *_t((cos, sin)), HEADS)
    assert type(out.grad_fn).__name__ == "_RopeQKNormBackward"
    out.backward(torch.from_numpy(g))
    assert rope.rope_qk_norm_forward.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for mine, ref in zip(inputs, want_grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.grad.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_fused_rope_dispatch() -> None:
    """Without a gradient the pass writes in place on the card (here: the plain version, no
    Function node); every N takes the same dispatch, N = 200 (not a multiple of 128) included:
    the JAX package's TPU tiling gate does not carry over."""
    args = _t(_inputs(4))
    with torch.no_grad():
        out = rope.fused_rope_qk_norm(*args, HEADS)
    assert out.grad_fn is None
    assert torch.equal(out, rope.rope_qk_norm_reference(*args, HEADS))
    ragged = _t(_inputs(5, n=200))
    with torch.no_grad():
        assert torch.equal(rope.fused_rope_qk_norm(*ragged, HEADS), rope.rope_qk_norm_reference(*ragged, HEADS))
    ragged[0].requires_grad_(True)
    out = rope.fused_rope_qk_norm(*ragged, HEADS)
    assert type(out.grad_fn).__name__ == "_RopeQKNormBackward"
    assert torch.equal(out.detach(), rope.rope_qk_norm_reference(*ragged, HEADS).detach())


def test_rope_wrapper_refuses_non_cpu_tensors_without_a_kernel() -> None:
    "A tensor on neither the CPU nor CUDA raises; nothing carries on quietly."
    args = [a.to("meta") for a in _t(_inputs(6))]
    with pytest.raises(ValueError, match="unsupported device"):
        rope.rope_qk_norm_forward(*args, HEADS)
