"""The port's int8 serving path against the JAX package's ``ops/quant.py``.

Inputs are drawn with numpy from a seed and handed to both packages.  The
plain version of kernel B6 (``quantize_activation``, what ``quantize_rows``
runs on the CPU) is held to the JAX function bit for bit, and to the JAX
Pallas kernel in interpret mode; the card holds B6 to the plain version in
``test_torch_kernels.py``.  Everything else is float32.
"""

from __future__ import annotations

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.models import dit as jdit
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.ops import quant
from skrample_tpu_torch.ops.quant import Int8Dense

jquant = importlib.import_module("skrample_tpu.ops.quant")

SMALL = {"dim": 256, "depth": 2, "heads": 2}


def _rows(seed: int, shape: tuple[int, int]) -> np.ndarray:
    "Normal rows with an all-zero row and a row of exact .5 ties (max 127, so the scale is exactly 1)."
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * np.float32(3)
    x[1] = 0.0
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[2, 8:] = np.float32(-3.5)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_quantize_rows_is_jax_quantize_activation_bit_for_bit(dtype: str) -> None:
    "B6's plain version vs the JAX ``quantize_activation``: q and s bit-equal, ties to even, zero rows scale 1."
    x = _rows(0, (40, 200))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want_q, want_s = jquant.quantize_activation(jx)
    q, s = quant.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (40, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert s[1].item() == 1.0 and not q[1].any()
    assert q[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]  # round half to even


def test_plain_quantize_rows_matches_the_pallas_kernel() -> None:
    "vs ``quantize_rows(interpret=True)``: within 1 lsb of q and rtol 1e-6 of s, the JAX test's own bound."
    x = _rows(1, (64, 256))
    want_q, want_s = jquant.quantize_rows(jnp.asarray(x), block_r=32, interpret=True)
    q, s = quant.quantize_rows(torch.from_numpy(x))
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(want_q, np.int32)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6)


def test_quantize_weight_matches_jax() -> None:
    "Per-output-channel weights: q and s bit-equal, an all-zero column gets scale 1; q is column-major."
    w = np.random.default_rng(2).standard_normal((96, 40), dtype=np.float32)
    w[:, 3] = 0.0
    want = jquant.quantize_weight(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["s"][3].item() == 1.0 and got["q"].t().is_contiguous()


def test_dense_int8_matches_jax() -> None:
    "``dense_int8`` on the same quantized weight and input: f32, rtol 1e-5 (int32 sums are exact)."
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 128), dtype=np.float32)
    params = {"w": rng.standard_normal((128, 72), dtype=np.float32), "b": rng.standard_normal(72, dtype=np.float32)}
    want = jquant.dense_int8(jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_size=1), jnp.asarray(x), jnp.float32)
    got = quant.dense_int8(quant.quantize_params(params, min_size=1), torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 24, 72) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_quantize_params_tree_shape_matches_jax() -> None:
    """The DiT tree under both ``quantize_params``: the same entries quantized (block qkv/proj/mlp),
    the same left alone (``ada`` excluded; the small patch/final/timestep layers), q and s bit-equal."""
    config = DiTConfig(**SMALL, compute_dtype=torch.float32)
    tree = random_param_tree(config, 4)
    exclude = frozenset({"ada", "final_mod", "t_mlp1", "t_mlp2"})
    want = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), exclude=exclude)
    got = quant.quantize_params(tree, exclude=exclude)
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == jax.tree.structure(jax.tree.map(np.asarray, want))
    block = got["blocks"][0]
    for name in ("qkv", "proj", "mlp_in", "mlp_out"):
        assert set(block[name]) == {"w_q", "b"} and block[name]["w_q"]["q"].dtype == torch.int8
    for name in ("patch_in", "final_mod", "final_out", "t_mlp1", "t_mlp2"):
        assert set(got[name]) == {"w", "b"}
    assert set(block["ada"]) == {"w", "b"}
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _jax_int8_inputs(run) -> list[tuple[dict, np.ndarray]]:
    "The (params, input) of every int8 product in one JAX forward ``run()``, in call order."
    seen = []
    real = jquant.dense_int8

    def record(params, xx, dtype):
        seen.append((jax.tree.map(np.asarray, params), np.array(xx)))  # a writable copy
        return real(params, xx, dtype)

    jquant.dense_int8 = record
    try:
        run()
    finally:
        jquant.dense_int8 = real
    return seen


def _fed_jax_activations(seen: list[tuple[dict, np.ndarray]]):
    """Patch the port's B6 dispatch to return, call by call, the JAX forward's quantized
    activations (``quantize_activation`` is bit-equal to JAX's).  Each call's own input must be the
    JAX one to rtol 1e-4, so the pairing is checked; what is left between the two int8 forwards is
    f32 rounding outside the products, with no activation flipping by one lsb."""
    calls = iter(seen)

    def fed(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _, xx = next(calls)
        xx = xx.reshape(x2.shape)
        np.testing.assert_allclose(x2.numpy(), xx, rtol=1e-4, atol=1e-5 * np.abs(xx).max())
        return quant.quantize_activation(torch.from_numpy(xx))

    return mock.patch.object(quant, "quantize_rows", fed)


def test_dit_int8_forward_matches_jax() -> None:
    """``DiT.quantize_params()`` vs the JAX int8 tree, f32, on the same random weights.

    The int8 layers are those of the JAX tree, with the same q and s bit for bit, and each
    one, fed the input the JAX forward gave it, returns the JAX product to rtol 1e-5.  The
    whole forward, fed the JAX forward's quantized activations (the two f32 forwards differ by
    a few ulps before each activation rounds to int8, which would move a few values by one
    lsb), agrees to rtol 1e-4 with an atol of 1e-5 of the largest output; the int8 model,
    quantizing its own activations, stays within cosine 0.99 of the f32 one."""
    config = DiTConfig(**SMALL, compute_dtype=torch.float32, attention="flash")
    tree = random_param_tree(config, 5)
    port = DiT(config, device="cpu").load_jax_params(tree)
    port.requires_grad_(False)
    int8 = port.quantize_params()
    ref = jdit.DiT(jdit.DiTConfig(**SMALL, compute_dtype=jnp.float32, attention="flash"))
    qtree = ref.quantize_params(jax.tree.map(jnp.asarray, tree))

    layers = [(n, m) for n, m in int8.named_modules() if isinstance(m, Int8Dense)]
    assert [n for n, _ in layers] == [f"blocks.{i}.{k}" for i in range(2) for k in ("qkv", "proj", "mlp_in", "mlp_out")]
    assert int8.blocks[0].ada.weight is port.blocks[0].ada.weight  # excluded layers are shared, not copied
    for name, layer in layers:
        _, i, key = name.split(".")
        np.testing.assert_array_equal(layer.q.t().numpy(), np.asarray(qtree["blocks"][int(i)][key]["w_q"]["q"]))
        np.testing.assert_array_equal(layer.s.numpy(), np.asarray(qtree["blocks"][int(i)][key]["w_q"]["s"]))

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 32, 32), dtype=np.float32)
    t = np.array([640.0, 75.0], dtype=np.float32)
    seen = _jax_int8_inputs(lambda: ref.apply(qtree, jnp.asarray(x), jnp.asarray(t)))
    for (params, xx), (_, layer) in zip(seen, layers, strict=True):
        want = np.asarray(jquant.dense_int8(jax.tree.map(jnp.asarray, params), jnp.asarray(xx), jnp.float32))
        got = quant.dense_int8(layer.params(), torch.from_numpy(xx), torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    want = np.asarray(ref.apply(qtree, jnp.asarray(x), jnp.asarray(t)))
    with _fed_jax_activations(seen):
        fed = int8(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(fed, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    got = int8(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    f32 = port(torch.from_numpy(x), torch.from_numpy(t)).numpy().ravel()
    assert float(f32 @ got.ravel() / (np.linalg.norm(f32) * np.linalg.norm(got))) > 0.99


def test_int8_model_is_for_serving_only() -> None:
    "An int8 tree does not load (quantize after loading), and int8 layers carry no parameters."
    config = DiTConfig(dim=128, depth=1, heads=1, compute_dtype=torch.float32)
    model = DiT(config, device="cpu")
    qtree = quant.quantize_params(random_param_tree(config, 7))
    with pytest.raises(NotImplementedError, match="quantize_params"):
        model.load_jax_params(qtree)
    int8 = model.quantize_params()
    assert sum(p.numel() for p in int8.parameters()) < sum(p.numel() for p in model.parameters())
    assert all(b.dtype in (torch.int8, torch.float32) for b in int8.buffers())


def test_quantize_rows_refuses_non_cpu_tensors_without_a_kernel() -> None:
    "A tensor on neither the CPU nor CUDA raises; nothing carries on quietly."
    with pytest.raises(ValueError, match="unsupported device"):
        quant.quantize_rows(torch.zeros(4, 8, device="meta"))
