"""The port's LoRA adapters against the JAX package's ``models/lora.py``.

A small float32 DiT (dim 128, 1 block, 2 heads of 64, plain attention) with
every weight drawn from a numpy seed is carried into both packages.
Tolerances: the leaf order and the adapter paths exactly; the adapters
drawn from one key within 1e-5 relative (``prng.normal``'s erfinv is
PyTorch's, a few float32 ulps from XLA's and more in the tails; the bits under it are jax's); the
merged model at init equal to the base bit for bit; merged weights within
1e-6; the loss and the adapters' gradients against ``jax.value_and_grad``
at rtol 1e-4 (float32 sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import functional_call

from skrample_tpu.models import dit as jdit
from skrample_tpu.models import lora as jlora
from skrample_tpu_torch import prng
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.models.flux import Flux, FluxConfig
from skrample_tpu_torch.models.flux import random_param_tree as flux_tree
from skrample_tpu_torch.models.lora import (
    jax_leaves,
    lora_from_numpy,
    lora_init,
    lora_leaves,
    lora_merge,
    lora_param_count,
    lora_to_numpy,
)
from skrample_tpu_torch.training import flow_matching_loss
from test_torch_parallel import K_GRAD, assert_within, dense_grad_sums

SIZE = {"dim": 128, "depth": 1, "heads": 2}
LATENT = (2, 4, 16, 16)
RANK = 4


def _models(seed: int = 0):
    tree = random_param_tree(DiTConfig(**SIZE), seed)
    port = DiT(DiTConfig(**SIZE, compute_dtype=torch.float32, attention="full"), device="cpu").load_jax_params(tree)
    port.requires_grad_(False)
    ref = jdit.DiT(jdit.DiTConfig(**SIZE, compute_dtype=jnp.float32, attention="full"))
    return port, ref, jax.tree.map(jnp.asarray, tree)


def test_jax_leaves_follow_jax_flatten_order() -> None:
    "The DiT's and a Flux's leaves in jax's flatten order: the same keystr paths and values as the JAX tree."
    port, _, params = _models()
    flux_config = FluxConfig(dim=64, heads=1, rope_axes=(16, 24, 24), depth=1, single_depth=1, context_dim=16, pooled_dim=8)
    flux = Flux(flux_config, device="cpu").load_jax_params(flux_tree(flux_config, 1))
    for model, tree in ((port, params), (flux, flux.param_tree())):
        want = jax.tree_util.tree_leaves_with_path(tree)
        got = jax_leaves(model)
        assert [leaf.path for leaf in got] == [jax.tree_util.keystr(p) for p, _ in want]
        for leaf, (_, value) in zip(got, want):
            t = leaf.tensor.detach().T if leaf.transposed else leaf.tensor.detach()
            assert np.array_equal(t.numpy(), np.asarray(value))


def test_lora_init_draws_jax_adapters() -> None:
    "From one key: the same paths, ``a`` within 1e-5 relative of JAX's, ``b`` zero; the count and numpy round trip."
    port, _, params = _models()
    want = jax.jit(lambda key, p: jlora.lora_init(key, p, rank=RANK))(jax.random.PRNGKey(2), params)
    got = lora_init(prng.PRNGKey(2), port, rank=RANK)
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_allclose(got[path]["a"].detach().numpy(), np.asarray(want[path]["a"]), rtol=1e-5, atol=0)
        assert not got[path]["b"].any() and got[path]["b"].shape == want[path]["b"].shape
        assert got[path]["a"].requires_grad and got[path]["b"].requires_grad
    assert lora_param_count(got) == jlora.lora_param_count(want)
    assert [t.shape for t in lora_leaves(got)] == [x.shape for x in jax.tree.leaves(want)]
    back = lora_from_numpy(lora_to_numpy(got), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lora_leaves(back), lora_leaves(got)))


def test_merge_is_identity_at_init_and_matches_jax() -> None:
    """At init the merged model's forward equals the base's bit for bit; with non-zero ``b`` the merged
    weights are within 1e-6 (relative, and of the leaf's largest) of the JAX package's ``lora_merge``
    (the rank-4 product sums in another order)."""
    port, _, params = _models()
    adapters = lora_init(prng.PRNGKey(3), port, rank=RANK)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(LATENT, dtype=np.float32))
    t = torch.tensor([500.0, 20.0])
    assert torch.equal(functional_call(port, lora_merge(port, adapters), (x, t)), port(x, t))
    for ab in adapters.values():
        with torch.no_grad():
            ab["b"].copy_(torch.from_numpy(rng.standard_normal(tuple(ab["b"].shape), dtype=np.float32) * np.float32(0.1)))
    merged = lora_merge(port, adapters, scale=2.0)
    want = jax.jit(lambda p, ad: jlora.lora_merge(p, ad, scale=2.0))(params, jax.tree.map(jnp.asarray, lora_to_numpy(adapters)))
    flat = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(want))
    by_name = {leaf.name: leaf.path for leaf in jax_leaves(port)}
    for name, w in merged.items():
        want_w = np.asarray(flat[by_name[name]])
        np.testing.assert_allclose(w.detach().numpy().T, want_w, rtol=1e-6, atol=1e-6 * np.abs(want_w).max())


def test_adapter_gradients_match_jax_and_reach_only_the_adapters() -> None:
    """The flow-matching loss through the merged model and its gradients on ``a`` and ``b`` against
    ``jax.value_and_grad`` over the JAX adapters (rtol 1e-4; atol per element ``K_GRAD * eps32 * S``
    from a float64 oracle, ``_adapter_oracle``, which the port's gradients also meet: t_mlp1's sums
    over the batch cancel); the frozen base gets none."""
    port, ref, params = _models(5)
    adapters = lora_init(prng.PRNGKey(6), port, rank=RANK)
    rng = np.random.default_rng(7)
    for ab in adapters.values():
        with torch.no_grad():
            ab["b"].copy_(torch.from_numpy(rng.standard_normal(tuple(ab["b"].shape), dtype=np.float32) * np.float32(0.05)))
    x0, noise = (rng.standard_normal(LATENT, dtype=np.float32) for _ in range(2))
    sigma = rng.uniform(1e-3, 1.0, LATENT[0]).astype(np.float32)

    def jloss(ad):
        tree = jlora.lora_merge(params, ad)
        s = jnp.asarray(sigma)[:, None, None, None]
        xt = (1 - s) * x0 + s * noise
        pred = ref.apply(tree, xt, jnp.asarray(sigma) * 1000.0)
        return jnp.mean((pred - (noise - x0)) ** 2)

    jad = jax.tree.map(jnp.asarray, lora_to_numpy(adapters))
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jad)

    class Merged(torch.nn.Module):
        def forward(self, xt, t):
            return functional_call(port, lora_merge(port, adapters), (xt, t))

    loss = flow_matching_loss(Merged(), *(torch.from_numpy(a) for a in (x0, noise, sigma)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    oracle, sums = _adapter_oracle(adapters, x0, noise, sigma)
    eps32 = np.finfo(np.float32).eps
    for path, ab in adapters.items():
        for k in ("a", "b"):
            want = np.asarray(want_grads[path][k])
            bound = K_GRAD * eps32 * sums[path][k]
            assert_within(ab[k].grad.numpy(), oracle[path][k], 0, bound, f"{path} {k} against the oracle")
            assert_within(ab[k].grad.numpy(), want, 1e-4, bound, f"{path} {k} against JAX")
    assert all(p.grad is None for p in port.parameters())


def _adapter_oracle(adapters: dict, x0: np.ndarray, noise: np.ndarray, sigma: np.ndarray) -> tuple[dict, dict]:
    """The same loss through the port's code in float64 (the oracle): its adapter gradients, and
    each one's per-element summation sums from ``dense_grad_sums`` over the merged weight ``W' = W +
    (1 / rank) (A B)ᵀ``: ``S_A = S_W' |B|ᵀ / rank`` and ``S_B = |A|ᵀ S_W' / rank`` (``S_W'`` in the
    JAX ``(in, out)`` layout, at least ``|dW'|`` element for element)."""
    port64 = DiT(DiTConfig(**SIZE, compute_dtype=torch.float64, attention="full"), device="cpu")
    port64.load_jax_params(random_param_tree(DiTConfig(**SIZE), 5)).double().requires_grad_(False)
    ad64 = {p: {k: v.detach().double().requires_grad_(True) for k, v in ab.items()} for p, ab in adapters.items()}
    merged = lora_merge(port64, ad64)

    class Merged(torch.nn.Module):
        def forward(self, xt, t):
            return functional_call(port64, merged, (xt, t))

    args = [torch.from_numpy(a).double() for a in (x0, noise, sigma)]
    w_sums = dense_grad_sums(lambda: flow_matching_loss(Merged(), *args).backward())
    names = {leaf.path: leaf.name for leaf in jax_leaves(port64)}
    grads, sums = {}, {}
    for path, ab in ad64.items():
        s_w = w_sums[merged[names[path]].data_ptr()][0].numpy().T / RANK
        a, b = (ab[k].detach().abs().numpy() for k in ("a", "b"))
        grads[path] = {k: ab[k].grad.numpy() for k in ("a", "b")}
        sums[path] = {"a": s_w @ b.T, "b": a.T @ s_w}
    return grads, sums
