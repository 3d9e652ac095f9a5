"""The port's text-to-image trainer against the JAX package's example, on the CPU.

``prng.randint``/``prng.bernoulli`` against ``jax.random`` bit for bit; the
trainer's four draws of a step against the example's ``train_step`` draws;
the joint loss and every gradient of both models (a ``TextEncoder`` of dim
32 and an ``MMDiT`` of dim 32 over 2 heads, 128 context tokens, 8x8
latents, ``"full"`` attention, float32) against ``jax.value_and_grad`` of
the example's ``loss_fn`` on the same weights (every leaf random from a
numpy seed) and the same inputs; and three joint steps against the
example's ``lax.scan`` epoch.  The JAX side is the example's code, written
out here: the example is a script whose ``loss_fn`` lives inside ``main``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skrample_tpu.models import mmdit as jmmdit
from skrample_tpu.models import text_encoder as jtext
from skrample_tpu_torch import prng
from skrample_tpu_torch.models import _tree
from skrample_tpu_torch.models import mmdit as tmmdit
from skrample_tpu_torch.models import text_encoder as ttext
from skrample_tpu_torch.train_text_to_image import (
    PROMPTS,
    hermetic_data,
    t2i_draws,
    t2i_loss,
    t2i_optimizer,
    t2i_train_step,
)

DIM, SIZE, BATCH, DROPOUT = 32, 8, 4, 0.5  # a dropout of 0.5 puts null rows in every small batch
CASES = {"full": {}, "qk-norm dual": {"qk_norm": True, "dual_attention_layers": (0,)}}


# ---- the draws ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
@pytest.mark.parametrize("shape", [(7,), (3, 5), (1000,)])
def test_randint_bit_exact(seed: int, shape: tuple[int, ...]) -> None:
    "int32 draws over small, large, negative, empty (max <= min) and the full int32 ranges: jax's, bit for bit."
    ranges = ((0, 32), (-5, 17), (0, 1), (3, 3), (10, 2), (0, 100_000), (7, 2**30 + 12345), (-(2**31), 2**31 - 1))
    for lo, hi in ranges:
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
        got = prng.randint(prng.PRNGKey(seed), shape, lo, hi, device="cpu")
        assert got.dtype == torch.int32 and want.dtype == np.int32
        assert np.array_equal(got.numpy(), want), (lo, hi)


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
@pytest.mark.parametrize("shape", [(7,), (3, 5), (1000,)])
def test_bernoulli_bit_exact(seed: int, shape: tuple[int, ...]) -> None:
    "``uniform < p`` in float32 at p 0, 0.1, 0.5, 0.999 and 1: jax's booleans."
    for p in (0.0, 0.1, 0.5, 0.999, 1.0):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))
        got = prng.bernoulli(prng.PRNGKey(seed), p, shape, device="cpu")
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), p


def _jax_draws(key, batch: int, size: int, dropout: float):
    "The example's ``train_step`` draws, as written there."
    kb, kn, kt, kd = jax.random.split(key, 4)
    idx = jax.random.randint(kb, (batch,), 0, len(PROMPTS))
    noise = jax.random.normal(kn, (batch, 4, size, size), jnp.float32)
    sigma = jax.random.uniform(kt, (batch,), minval=1e-3, maxval=1.0)
    drop = jax.random.bernoulli(kd, dropout, (batch,))
    return idx, noise, sigma, drop


# ---- the loss, the gradients and three steps --------------------------------------------


def _configs(case: str):
    enc_kw = {"dim": DIM, "depth": 2, "heads": 2, "max_tokens": 128}
    mm_kw = {"dim": DIM, "depth": 2, "heads": 2, "context_dim": DIM, "context_tokens": 128, "attention": "full"}
    mm_kw.update(CASES[case])
    return enc_kw, mm_kw


def _pair(case: str, seed: int = 0):
    "The port's two models and the JAX package's, with their tree, on the same random weights."
    enc_kw, mm_kw = _configs(case)
    tenc = ttext.TextEncoder(ttext.TextEncoderConfig(**enc_kw, compute_dtype=torch.float32), device="cpu")
    tmm = tmmdit.MMDiT(tmmdit.MMDiTConfig(**mm_kw, compute_dtype=torch.float32), device="cpu")
    tree = {
        "enc": ttext.random_param_tree(tenc.config, seed),
        "mmdit": tmmdit.random_param_tree(tmm.config, seed + 1),
    }
    tenc.load_jax_params(tree["enc"])
    tmm.load_jax_params(tree["mmdit"])
    jenc = jtext.TextEncoder(jtext.TextEncoderConfig(**enc_kw, compute_dtype=jnp.float32))
    jmm = jmmdit.MMDiT(jmmdit.MMDiTConfig(**mm_kw, compute_dtype=jnp.float32))
    return tenc, tmm, jenc, jmm, jax.tree.map(jnp.asarray, tree)


def _jax_loss_fn(jenc, jmm, ids, images):
    "The example's ``loss_fn``."

    def loss_fn(p, idx, noise, sigma, drop):
        feats = jenc.apply(p["enc"], ids[idx])
        ctx = jmm.embed_context(p["mmdit"], feats, idx.shape[0])
        null = jmm.embed_context(p["mmdit"], None, idx.shape[0])
        ctx = jnp.where(drop[:, None, None], null, ctx)
        x0 = images[idx]
        s = sigma[:, None, None, None]
        xt = (1 - s) * x0 + s * noise
        pred = jmm.apply(p["mmdit"], xt, sigma * 1000.0, ctx)
        return jnp.mean((pred - (noise - x0)) ** 2)

    return loss_fn


def _data():
    ids, images = hermetic_data(SIZE, device="cpu")
    return ids, images, jnp.asarray(ids.numpy().astype(np.int32)), jnp.asarray(images.numpy())


def _grads_close(models, jgrads: dict, rtol: float) -> None:
    "Every port gradient (``None``: zero) against the JAX tree's, at ``rtol`` and ``atol = rtol * max |want|``."
    for model, sub in zip(models, ("enc", "mmdit")):
        flat = dict(_tree._flatten(jgrads[sub]))
        leaves = list(_tree.leaves(model))
        assert {path for path, *_ in leaves} == set(flat)
        for path, param, transposed in leaves:
            want = np.asarray(flat[path])
            got = np.zeros(tuple(param.shape), np.float32) if param.grad is None else param.grad.numpy()
            got = got.T if transposed else got
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=f"{sub}.{path}")


EPOCH_SEED = 3  # the "full" pair's weights: its gradients are the epoch's first step's


@functools.cache
def _jax_epoch() -> dict:
    """The example's jitted ``lax.scan`` epoch of three steps over ``split(PRNGKey(2), 3)`` (batch 4,
    CFG dropout 0.5) from the "full" pair's weights, with ``optax.adamw(1e-4)``: the parameters
    after it, and each step's loss, gradients (the first step's is ``jax.value_and_grad`` of the
    example's ``loss_fn`` at the initial weights) and draws; beside it, in the same compile, the
    example's image latents ``normal(PRNGKey(42), (32, 4, 8, 8))``."""
    _tenc, _tmm, jenc, jmm, jtree = _pair("full", seed=EPOCH_SEED)
    _ids, _images, jids, jimages = _data()
    loss_fn = _jax_loss_fn(jenc, jmm, jids, jimages)
    jopt = optax.adamw(1e-4)

    def train_step(carry, key):
        p, o = carry
        draws = _jax_draws(key, BATCH, SIZE, DROPOUT)
        loss, grads = jax.value_and_grad(loss_fn)(p, *draws)
        updates, o = jopt.update(grads, o, p)
        return (optax.apply_updates(p, updates), o), (loss, grads, draws)

    @jax.jit
    def epoch(p, o, key):
        (params, _), (losses, grads, draws) = jax.lax.scan(train_step, (p, o), jax.random.split(key, 3))
        images = jax.random.normal(jax.random.PRNGKey(42), (len(PROMPTS), 4, SIZE, SIZE), jnp.float32)
        return {"params": params, "losses": losses, "grads": grads, "draws": draws, "images": images}

    return jax.tree.map(np.asarray, epoch(jtree, jopt.init(jtree), jax.random.PRNGKey(2)))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_value_and_grad(case: str) -> None:
    """``t2i_loss`` and the gradient of every leaf of both models against ``jax.value_and_grad`` of the
    example's ``loss_fn``, on one step's draws with both conditioned and null rows: rtol 1e-4
    (``atol`` 1e-4 of each leaf's largest magnitude).  "full" is held to the first step of the JAX
    epoch (one compile for this test and the next); "qk-norm dual" to its own ``value_and_grad``.
    The encoder's ``text_proj`` gets no gradient in either (the loss does not reach it)."""
    ids, images, jids, jimages = _data()
    if case == "full":
        tenc, tmm, *_ = _pair(case, seed=EPOCH_SEED)
        draws = t2i_draws(prng.split(prng.PRNGKey(2), 3)[0], BATCH, SIZE, DROPOUT, device="cpu")
        epoch = _jax_epoch()
        want_loss, jgrads = epoch["losses"][0], jax.tree.map(lambda g: g[0], epoch["grads"])
    else:
        tenc, tmm, jenc, jmm, jtree = _pair(case)
        draws = t2i_draws(prng.PRNGKey(9), BATCH, SIZE, DROPOUT, device="cpu")
        jargs = [jnp.asarray(d.numpy()) for d in draws]
        want_loss, jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(jenc, jmm, jids, jimages)))(jtree, *jargs)
    assert draws[3].any() and not draws[3].all()  # both the conditioned and the null rows
    loss = t2i_loss(tenc, tmm, ids, images, *draws)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    assert tenc.text_proj.weight.grad is None and not np.asarray(jgrads["enc"]["text_proj"]["w"]).any()
    _grads_close((tenc, tmm), jgrads, 1e-4)


def test_three_steps_match_the_jax_epoch() -> None:
    """Three joint steps (keys ``split(PRNGKey(2), 3)``, batch 4, CFG dropout 0.5) through
    ``t2i_train_step`` and ``optax.adamw(1e-4)``'s counterpart, against the example's jitted ``lax.scan``
    epoch: the three losses at rtol 1e-4, and every parameter of both models at rtol 1e-4 (atol
    1e-6) wherever its gradient was at least 1e-6 at every step.  Elsewhere AdamW's step ``lr * m /
    (sqrt(v) + eps)`` magnifies rounding (the key biases' gradient is 0 up to rounding: softmax
    ignores a per-row constant), and the check there is the most three steps can move a weight, 3 x
    2.1 lr, as ``tests/test_torch_training.py`` bounds one step."""
    tenc, tmm, *_ = _pair("full", seed=EPOCH_SEED)
    ids, images, *_ = _data()
    opt = t2i_optimizer(tenc, tmm)
    losses = [
        float(t2i_train_step(tenc, tmm, opt, ids, images, t2i_draws(key, BATCH, SIZE, DROPOUT, device="cpu")))
        for key in prng.split(prng.PRNGKey(2), 3)
    ]
    epoch = _jax_epoch()
    np.testing.assert_allclose(losses, epoch["losses"], rtol=1e-4)
    for model, sub in ((tenc, "enc"), (tmm, "mmdit")):
        flat, grads = dict(_tree._flatten(epoch["params"][sub])), dict(_tree._flatten(epoch["grads"][sub]))
        for path, param, transposed in _tree.leaves(model):
            got = param.detach().numpy()
            got, want = (got.T if transposed else got), flat[path]
            steady = (np.abs(grads[path]) >= 1e-6).all(axis=0)
            np.testing.assert_allclose(got[steady], want[steady], rtol=1e-4, atol=1e-6, err_msg=f"{sub}.{path}")
            assert np.abs(got - want).max() <= 3 * 2.1e-4, f"{sub}.{path}"


def test_draws_and_data_match_the_example() -> None:
    """The three steps of ``split(PRNGKey(2), 3)`` as the JAX epoch drew them (batch 4, CFG dropout
    0.5): the prompt rows, sigmas and dropout rows bit for bit, the noise within 1e-4 (PyTorch's
    erfinv against XLA's, tests/test_torch_prng.py); the byte ids equal and the image latents
    within 1e-4 of ``normal(PRNGKey(42), ...)``."""
    from skrample_tpu.models import ByteTokenizer

    epoch = _jax_epoch()
    for step, key in enumerate(prng.split(prng.PRNGKey(2), 3)):
        got = t2i_draws(key, BATCH, SIZE, DROPOUT, device="cpu")
        want = [d[step] for d in epoch["draws"]]
        assert np.array_equal(got[0].numpy(), want[0])
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-4, atol=1e-4)
        assert np.array_equal(got[2].numpy(), want[2])
        assert np.array_equal(got[3].numpy(), want[3])
    ids, images = hermetic_data(SIZE, device="cpu")
    assert np.array_equal(ids.numpy(), ByteTokenizer().batch(PROMPTS, 128))
    np.testing.assert_allclose(images.numpy(), epoch["images"], rtol=1e-4, atol=1e-4)
