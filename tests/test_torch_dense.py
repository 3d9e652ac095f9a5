"""The port's dense layer against the JAX package's ``_dense``, in bf16.

The JAX ``_dense`` takes the product with a float32 result, adds the
float32 bias, rounds once to the compute dtype, and under ``jax.vjp`` sums
the bias cotangent in float32.  The port's ``_dense`` (an autograd Function)
must do the same: the bias gradient to rtol 1e-5, and the forward within
one bf16 ulp everywhere with at least 99% of the elements bit-equal (the
two products sum in another order).  Inputs are drawn with numpy from a
seed and handed to both packages.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from skrample_tpu.models import dit as jdit
from skrample_tpu_torch.models import dit as tdit

R, K, N = 96, 256, 384


def _inputs(seed: int) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, R // 2, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.float32(np.sqrt(K))
    b = rng.standard_normal(N, dtype=np.float32)
    g = rng.standard_normal((2, R // 2, N), dtype=np.float32)
    return x, w, b, g


def _bf16(a: np.ndarray) -> np.ndarray:
    "Round to bf16 and back, so both packages start from the same bf16 values."
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _layer(w: np.ndarray, b: np.ndarray) -> torch.nn.Linear:
    layer = torch.nn.Linear(K, N)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T.copy()))
        layer.bias.copy_(torch.from_numpy(b))
    return layer


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_dense_matches_jax(seed: int) -> None:
    """Forward within one bf16 ulp (>= 99% bit-equal), the bias gradient to rtol 1e-5:
    the product and the bias add in f32, one rounding, the bias cotangent summed in f32."""
    x, w, b, g = _inputs(seed)
    x, g = _bf16(x), _bf16(g)
    want, vjp = jax.vjp(
        lambda xx, p: jdit._dense(p, xx, jnp.bfloat16),
        jnp.asarray(x, jnp.bfloat16),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
    )
    want_dx, want_p = vjp(jnp.asarray(g, jnp.bfloat16))

    layer = _layer(w, b)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got = tdit._dense(layer, tx, torch.bfloat16)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert layer.bias.grad.dtype == torch.float32
    np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(want_p["b"]), rtol=1e-5, atol=0)
    assert got.dtype == torch.bfloat16 and type(got.grad_fn).__name__ == "_DenseBackward"

    got32, want32 = got.detach().float().numpy(), np.asarray(want, np.float32)
    # one bf16 ulp of each element; where the sum cancels below the f32 products' rounding noise
    # (1e-5 of the largest output: the two sum in another order) the ulp of that noise level
    floor = 1e-5 * np.abs(want32).max()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want32), floor))) - 7)
    assert np.all(np.abs(got32 - want32) <= ulp)
    assert np.mean(got32 == want32) >= 0.99
    # dx and dw are bf16 products of the same bf16 values in both packages: one bf16 rounding apart
    np.testing.assert_allclose(
        tx.grad.float().numpy(), np.asarray(want_dx, np.float32), rtol=2**-7, atol=2**-7 * np.abs(want_dx).max()
    )
    np.testing.assert_allclose(
        layer.weight.grad.numpy().T, np.asarray(want_p["w"]), rtol=2**-7, atol=2**-7 * np.abs(want_p["w"]).max()
    )


def test_dense_without_grad_takes_the_forward_alone() -> None:
    "No gradient wanted: no Function node, and the same bits as the Function's forward."
    x, w, b, _ = _inputs(2)
    layer = _layer(w, b)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        plain = tdit._dense(layer, tx, torch.bfloat16)
    assert plain.grad_fn is None
    assert torch.equal(plain, tdit._dense(layer, tx, torch.bfloat16).detach())


def test_dots_policy_keeps_the_dense_product() -> None:
    """``remat="dots"`` sees the dense layer's product (``aten.mm`` here, ``aten.mm.dtype`` on
    the card) and keeps it; the recomputed forward then gives the gradients of no remat exactly."""
    x, w, b, g = _inputs(3)
    layer = _layer(w, b)
    seen = []

    def recording(ctx, op, *args, **kwargs):
        policy = tdit._save_dense_outputs(ctx, op, *args, **kwargs)
        seen.append(policy)
        return policy

    grads = []
    for context in (None, functools.partial(create_selective_checkpoint_contexts, recording)):
        layer.zero_grad()
        tx = torch.from_numpy(x).requires_grad_(True)

        def fn(a: torch.Tensor) -> torch.Tensor:
            return torch.tanh(tdit._dense(layer, a, torch.float32))

        out = fn(tx) if context is None else checkpoint(fn, tx, use_reentrant=False, context_fn=context)
        out.backward(torch.from_numpy(g))
        grads.append([t.clone() for t in (tx.grad, layer.weight.grad, layer.bias.grad)])
    assert CheckpointPolicy.MUST_SAVE in seen
    for a, c in zip(*grads):
        assert torch.equal(a, c)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_serving_dense_on_the_cpu_is_unchanged(storage: torch.dtype) -> None:
    """Where no gradient is wanted the CPU keeps the two passes (the card's one-pass epilogue is a
    CUDA route): f32 masters with an f32 bias, and a bf16-built layer, give the bits of
    ``_dense_forward`` on the weight cast each call."""
    x, w, b, _ = _inputs(4)
    layer = _layer(w, b).to(storage).requires_grad_(False)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tdit._dense(layer, tx, torch.bfloat16)
    assert torch.equal(got, tdit._dense_forward(tx, layer.weight.to(torch.bfloat16), layer.bias))


def _small_dit(seed: int) -> tdit.DiT:
    config = tdit.DiTConfig(dim=64, depth=1, heads=1, compute_dtype=torch.bfloat16)
    return tdit.DiT(config, device="cpu").load_jax_params(tdit.random_param_tree(config, seed)).requires_grad_(False)


def test_cast_dense_weights_serves_the_same_bits() -> None:
    """``cast_dense_weights`` stores the dense weights in the compute dtype and keeps the f32 biases:
    the served output is the bits of the f32-master model, which casts each weight at every call."""
    xs, t = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(0)), torch.tensor(300.0)
    masters = _small_dit(0)
    cast = tdit.cast_dense_weights(_small_dit(0), torch.bfloat16)
    layers = [m for m in cast.modules() if isinstance(m, torch.nn.Linear)]
    assert {m.weight.dtype for m in layers} == {torch.bfloat16} and {m.bias.dtype for m in layers} == {torch.float32}
    assert not any(p.requires_grad for p in cast.parameters())
    with torch.no_grad():
        assert torch.equal(cast(xs, t), masters(xs, t))
    assert all(isinstance(m.weight, torch.nn.Parameter) for m in layers)


def test_cast_dense_weights_takes_in_place_updates() -> None:
    """``load_jax_params`` into a cast model lands in the weights its forward reads: it then serves what a
    model built from the new tree serves, and ``param_tree`` gives the new tree rounded to bf16."""
    xs, t = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(1)), torch.tensor(300.0)
    model = tdit.cast_dense_weights(_small_dit(0), torch.bfloat16)
    with torch.no_grad():
        model(xs, t)
        model.load_jax_params(_small_dit(1).param_tree())
        assert torch.equal(model(xs, t), _small_dit(1)(xs, t))
    tree = _small_dit(1).param_tree()
    got = model.param_tree()
    qkv, want = got["blocks"][0]["qkv"], tree["blocks"][0]["qkv"]
    assert np.array_equal(qkv["w"], torch.from_numpy(want["w"]).to(torch.bfloat16).float().numpy())
    assert np.array_equal(qkv["b"], want["b"])
