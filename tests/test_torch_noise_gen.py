"""The port's noise generators (``skrample_tpu_torch.noise``) against the JAX package's, on the CPU.

Both draw from threefry2x32 keys (the port's ``prng`` computes jax.random's
bits exactly), so each generator gives the same noise from the same seed:
float32 normals within 1e-4 (PyTorch's erfinv against XLA's, a few ulps,
as ``test_torch_prng.py`` holds them; the shaped families add their FFTs'
and resizes' rounding) and bfloat16 normals equal.  The Brownian tree's
increments must also add up exactly as the tree says, and Pyramid must draw
levels of the same shapes.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import noise as jnoise
from skrample_tpu.common import Step as JStep
from skrample_tpu_torch import noise as tnoise
from skrample_tpu_torch import prng
from skrample_tpu_torch.common import Step

SHAPE = (1, 4, 8, 8)
STEPS = 10
TOL = 1e-4
FAMILIES = ("Random", "Offset", "Pyramid", "Brownian", "Colored")


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=0, atol=tol)


def _props(name: str, pkg):
    return {
        "Offset": pkg.OffsetProps(dims=(0, 1), strength=0.5),
        "Pyramid": pkg.PyramidProps(strength=0.4, depth=3),
        "Brownian": pkg.BrownianProps(max_steps=100),
        "Colored": pkg.ColoredProps(energy=1.5, color_curve=1.0),
    }.get(name)


@pytest.mark.parametrize("props", [False, True], ids=["default", "props"])
@pytest.mark.parametrize("name", FAMILIES)
def test_generator_matches_jax(name: str, props: bool) -> None:
    "Each family at steps 0 and 9 of 10 (and without a step), from an int seed (defaults) or a key (props)."
    seed = 2024 if props else 3
    jgen = getattr(jnoise, name).from_inputs(SHAPE, seed, _props(name, jnoise) if props else None)
    key = prng.PRNGKey(seed) if props else seed
    tgen = getattr(tnoise, name).from_inputs(SHAPE, key, _props(name, tnoise) if props else None, device="cpu")
    for n in (0, 9):
        got = tgen.generate(n, Step.from_int(n, STEPS))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got, jgen.generate(n, JStep.from_int(n, STEPS)))
    _close(tgen.generate(2, None), jgen.generate(2, None))


@pytest.mark.parametrize("static", [False, True])
def test_static_offset_and_pyramid(static: bool) -> None:
    "The static components come from one salted key stream, the same at every step."
    for name, props in (("Offset", "OffsetProps"), ("Pyramid", "PyramidProps")):
        jgen = getattr(jnoise, name).from_inputs(SHAPE, 7, getattr(jnoise, props)(static=static))
        tgen = getattr(tnoise, name).from_inputs(SHAPE, 7, getattr(tnoise, props)(static=static), device="cpu")
        for n in (1,):
            _close(tgen.generate(n, Step.from_int(n, STEPS)), jgen.generate(n, JStep.from_int(n, STEPS)))


def test_random_bfloat16_equals_jax() -> None:
    "bfloat16 normals: equal once rounded, as the port's prng draws them."
    jgen = jnoise.Random.from_inputs(SHAPE, 11, dtype=jnp.bfloat16)
    tgen = tnoise.Random.from_inputs(SHAPE, 11, dtype=torch.bfloat16, device="cpu")
    for n in (0, 3):
        got, want = tgen.generate(n, None), jgen.generate(n, None)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_pyramid_level_shapes_equal_jax() -> None:
    "Pyramid's levels have the JAX shapes: the shrink factor drawn as a host float, sized by Python's int()."
    for shape, dims in (((1, 4, 64, 64), (-1, -2)), ((1, 4, 37, 50), (-1, -2)), ((2, 3, 9, 40), (0, -1))):
        tgen = tnoise.Pyramid.from_inputs(shape, 5, tnoise.PyramidProps(dims=dims), device="cpu")
        got = []  # every level passes through the resize (the first one unchanged)
        with mock.patch.object(tnoise, "bilinear_resize", lambda x, to: got.append(tuple(x.shape)) or x.new_zeros(to)):
            tgen.generate(0, None)
        want = []
        jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 0), 1)
        running = list(shape)
        mask = [n in [len(shape) + d if d < 0 else d for d in dims] for n in range(len(shape))]
        for i in range(99):  # the JAX loop's sizing, read off the JAX keys
            r_key, _, jkey = jax.random.split(jax.random.fold_in(jkey, i), 3)
            r = float(jax.random.uniform(r_key)) * 2 + 2
            running = [max(1, int(s / (r**i))) if m else s for m, s in zip(mask, running)]
            want.append(tuple(running))
            if any(s <= 1 for m, s in zip(mask, running) if m):
                break
        assert got == want and len(got) >= 2


@pytest.mark.parametrize(("size_in", "size_out"), [((3, 5), (16, 16)), ((7, 16), (64, 16)), ((16, 9), (5, 4))])
def test_bilinear_resize_equals_jax_image_resize(size_in: tuple, size_out: tuple) -> None:
    "The separable triangle-kernel resize against jax.image.resize(..., 'bilinear'), up and down."
    x = np.random.default_rng(sum(size_in)).standard_normal((2, 3, *size_in), dtype=np.float32)
    want = np.asarray(jax.image.resize(x, (2, 3, *size_out), "bilinear"))
    got = tnoise.bilinear_resize(torch.from_numpy(x), (2, 3, *size_out))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_brownian_tree_matches_jax_and_adds_up() -> None:
    """``brownian_at`` and ``brownian_increment`` against the JAX tree (depth 8), and additivity:
    W(b) - W(a) == (W(m) - W(a)) + (W(b) - W(m)) within 1e-5."""
    depth = 8
    jkey, key = jax.random.PRNGKey(13), prng.PRNGKey(13)
    for t in (0.0, 0.25, 0.3, 0.61, 1.0):
        _close(tnoise.brownian_at(key, t, depth, SHAPE, device="cpu"), jnoise.brownian_at(jkey, t, depth, SHAPE))
    for t0, t1 in ((0.1, 0.35), (0.5, 0.5), (0.99, 1.0), (0.0, 1.0)):
        _close(
            tnoise.brownian_increment(key, t0, t1, depth, SHAPE, device="cpu"),
            jnoise.brownian_increment(jkey, t0, t1, depth, SHAPE),
        )

    def w(t: float) -> torch.Tensor:
        return tnoise.brownian_at(key, t, depth, SHAPE, device="cpu").double()

    for a, m, b in ((0.1, 0.3, 0.7), (0.0, 0.5, 1.0), (0.2, 0.21, 0.9)):
        whole = w(b) - w(a)
        assert (whole - ((w(m) - w(a)) + (w(b) - w(m)))).abs().max().item() <= 1e-5
        scale = 2**depth
        g_a, g_b = round(a * scale), round(b * scale)
        inc = tnoise.brownian_increment(key, a, b, depth, SHAPE, device="cpu").double()
        np.testing.assert_allclose(inc.numpy(), (whole / ((g_b - g_a) / scale) ** 0.5).numpy(), rtol=0, atol=1e-5)


def test_batch_noise_and_stack_noise_match_jax() -> None:
    "BatchNoise's per-item fan-out (Random, and Colored with props) and stack_noise's (steps, *shape) buffer."
    jbatch = jnoise.BatchNoise.from_batch_inputs(jnoise.Random, SHAPE[1:], [1, 2, 3])
    tbatch = tnoise.BatchNoise.from_batch_inputs(tnoise.Random, SHAPE[1:], [1, 2, 3], device="cpu")
    _close(tnoise.stack_noise(tbatch, 3), jnoise.stack_noise(jbatch, 3))
    props = jnoise.ColoredProps(energy=0.5), tnoise.ColoredProps(energy=0.5)
    jbatch = jnoise.BatchNoise.from_batch_inputs(jnoise.Colored, SHAPE[1:], [5, 6], props[0])
    tbatch = tnoise.BatchNoise.from_batch_inputs(tnoise.Colored, SHAPE[1:], [5, 6], props[1], device="cpu")
    _close(tbatch.generate(4, Step.from_int(4, STEPS)), jbatch.generate(4, JStep.from_int(4, STEPS)))


def test_colorize_paths_and_names() -> None:
    "colorize's exponent-0 fast paths, the generator ABC's JAX name, and the card default refusing the CPU."
    white = np.random.default_rng(3).standard_normal((4, 16, 16), dtype=np.float32)
    for exponent, energy in ((0.0, None), (0.0, 2.0), (1.5, None), (-1.0, 0.7)):
        _close(
            tnoise.Colored.colorize(torch.from_numpy(white), exponent, energy),
            jnoise.Colored.colorize(jnp.asarray(white), exponent, energy),
        )
    assert tnoise.JaxNoise is tnoise.TorchNoise and issubclass(tnoise.Random, tnoise.TorchNoise)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnoise.Random.from_inputs(SHAPE, 0)
