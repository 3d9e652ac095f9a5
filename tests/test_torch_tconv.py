"""B13's plain version (``ops/fused_conv.py``: the causal temporal conv with GroupNorm+SiLU on its
input read) against the JAX package's ``tconv_causal_gn_silu`` (its Pallas kernel in interpret mode),
on the CPU.

All three forms the video VAE's fused decode uses, in float32: with the norm and the statistics
chain (a temporal resblock's first conv), with the norm and a residual (its second), and the
un-normed frame-repeat upsample (``repeat_in=2``): rtol/atol 1e-5, the same float32 arithmetic
summed in another order.  The autograd Function's gradients against ``jax.vjp`` (rtol 1e-4).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import fused_conv as tfc

jfc = importlib.import_module("skrample_tpu.ops.fused_conv")

B, T, S, C, CO, K = 2, 4, 64, 16, 24, 3  # S a multiple of 64: the JAX dispatch takes its kernel


def _inputs(seed: int, mode: str):
    rng = np.random.default_rng(seed)
    co = C if mode == "residual" else CO
    x = (rng.standard_normal((B, T, S, C), dtype=np.float32) * 1.5 + 0.3).astype(np.float32)
    w = (rng.standard_normal((K, C, co), dtype=np.float32) / np.sqrt(K * C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32)
    stats = residual = None
    if mode != "repeat":
        raw = np.asarray(jfc.channel_stats(jnp.asarray(x), sample_dims=2))
        stats = np.asarray(jfc.finalize_group_stats(jnp.asarray(raw), 4, S))
    if mode == "residual":
        residual = rng.standard_normal((B, T, S, co), dtype=np.float32)
    return x, w, b, stats, residual, 2 if mode == "repeat" else 1


def _torch(a):
    return None if a is None else torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("mode", ["stats", "residual", "repeat"])
def test_plain_b13_matches_the_pallas_kernel(mode: str) -> None:
    "Output and its per-(item, frame) statistics: rtol/atol 1e-5 against the interpret-mode kernel."
    x, w, b, stats, residual, rep = _inputs(1, mode)
    jargs = [None if a is None else jnp.asarray(a) for a in (x, w, b, stats, residual)]
    want, want_raw = jfc.tconv_causal_gn_silu(*jargs, repeat_in=rep, interpret=True)
    got, raw = tfc.tconv_causal_gn_silu_forward(*(_torch(a) for a in (x, w, b, stats, residual)), repeat_in=rep)
    assert got.shape == (B, T * rep, S, w.shape[-1]) and raw.shape == (B, T * rep, 2, w.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), rtol=1e-5, atol=1e-4)
    ref, ref_raw = jfc.tconv_causal_ref(*jargs[:4], jargs[4], mode != "repeat", rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_b13_is_causal_and_batch_invariant() -> None:
    "Frame t reads frames <= t only (a prefix gives the prefix); an item alone gives its packed bits."
    x, w, b, stats, residual, _ = _inputs(2, "residual")
    full, full_raw = tfc.tconv_causal_ref(*(_torch(a) for a in (x, w, b, stats, residual)))
    head = (x[:, :2], w, b, stats[:, :2], residual[:, :2])
    prefix, prefix_raw = tfc.tconv_causal_ref(*(_torch(a) for a in head))
    assert torch.equal(prefix, full[:, :2]) and torch.equal(prefix_raw, full_raw[:, :2])
    item = (x[1:], w, b, stats[1:], residual[1:])
    alone, alone_raw = tfc.tconv_causal_ref(*(_torch(a) for a in item))
    assert torch.equal(alone, full[1:]) and torch.equal(alone_raw, full_raw[1:])


@pytest.mark.parametrize("mode", ["stats", "residual", "repeat"])
def test_the_function_gradients_match_jax_vjp(mode: str) -> None:
    """``tconv_causal_gn_silu`` under autograd: every input's gradient through the output and its
    statistics against ``jax.vjp`` of the JAX package's ``tconv_causal_ref`` (rtol 1e-4)."""
    x, w, b, stats, residual, rep = _inputs(3, mode)
    rng = np.random.default_rng(4)
    co = w.shape[-1]
    g = rng.standard_normal((B, T * rep, S, co), dtype=np.float32)
    g_raw = rng.standard_normal((B, T * rep, 2, co), dtype=np.float32) * 1e-3
    names = [n for n, a in zip(("x", "w", "b", "stats", "residual"), (x, w, b, stats, residual)) if a is not None]
    present = [a for a in (x, w, b, stats, residual) if a is not None]

    def ref(*args):
        full = dict(zip(names, args))
        return jfc.tconv_causal_ref(
            full["x"], full["w"], full["b"], full.get("stats"), full.get("residual"), stats is not None, rep
        )

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in present))
    want = vjp((jnp.asarray(g), jnp.asarray(g_raw)))
    inputs = {n: _torch(a).requires_grad_(True) for n, a in zip(names, present)}
    out, raw = tfc.tconv_causal_gn_silu(
        inputs["x"], inputs["w"], inputs["b"], inputs.get("stats"), inputs.get("residual"), repeat_in=rep
    )
    torch.autograd.backward([out, raw], [torch.from_numpy(g), torch.from_numpy(g_raw)])
    for name, expected in zip(names, want):
        got = inputs[name].grad.numpy()
        scale = np.abs(np.asarray(expected)).max()
        np.testing.assert_allclose(got, np.asarray(expected), rtol=1e-4, atol=1e-5 * max(scale, 1.0), err_msg=name)


def test_launch_geometry_and_contract() -> None:
    """The statistics scratch has one [sum, sumsq] row per (item, output frame) and 128-site tile of
    B13's grid; ``repeat_in=2`` with statistics is refused, as in the JAX package."""
    assert tfc.tconv_partials_shape(1, 16, 262144, 64) == (16, 2048, 2, 64)
    assert tfc.tconv_partials_shape(1, 8, 65536, 128) == (8, 512, 2, 128)
    assert tfc.tconv_partials_shape(2, 4, 4097, 256) == (8, 33, 2, 256)
    x, w, b, stats, _, _ = _inputs(5, "stats")
    with pytest.raises(ValueError, match="stats must be None"):
        tfc.tconv_causal_gn_silu(_torch(x), _torch(w), _torch(b), _torch(stats), repeat_in=2)
