"""The port's threefry2x32 (``skrample_tpu_torch/prng.py``) against ``jax.random``, and the
serving engine's draws against the JAX engine's ``_prepare``, on the CPU.

Bits, keys and uniforms must be equal; float32 normals agree within 1e-4 (PyTorch's erfinv
against XLA's: a few f32 ulps) and bfloat16 normals are equal once rounded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch import prng, scheduling
from skrample_tpu_torch.sampling import models, structured
from skrample_tpu_torch.serving import ServingEngine

from skrample_tpu import scheduling as jsched
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu.serving import ServingEngine as JaxEngine

SEEDS = [int(s) for s in np.random.default_rng(2024).integers(0, 2**31 - 1, size=3)]
SHAPE = (3, 5, 7)


def _key_data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key)


@pytest.mark.parametrize("seed", [0, 1, *SEEDS, -5])
def test_prng_key_and_split_and_fold_in(seed: int) -> None:
    "PRNGKey, split (2 and 5 ways) and fold_in give jax's key words."
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert np.array_equal(key.numpy(), _key_data(jkey).astype(np.int64))
    for n in (2, 5):
        assert np.array_equal(prng.split(key, n).numpy(), _key_data(jax.random.split(jkey, n)).astype(np.int64))
    for data in (0, 7, 123456):
        assert np.array_equal(prng.fold_in(key, data).numpy(), _key_data(jax.random.fold_in(jkey, data)))


def test_prng_key_of_a_64_bit_seed() -> None:
    "A seed past 32 bits keeps its high word, as jax's 64-bit seeds do."
    seed = 2**40 + 3
    with jax.enable_x64(True):
        want = _key_data(jax.random.PRNGKey(seed)).astype(np.int64)
    assert np.array_equal(prng.PRNGKey(seed).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [8, 16, 32])
def test_random_bits_equal_jax(seed: int, width: int) -> None:
    "32-bit bits are x0 ^ x1 over the flat counter; 8 and 16 bits are their low bits."
    got = prng.random_bits(prng.PRNGKey(seed), SHAPE, width, device="cpu").numpy()
    dtype = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[width]
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), SHAPE, dtype))
    assert np.array_equal(got, want.astype(np.int64))


def _f16_rules(key: torch.Tensor, shape: tuple[int, ...], minval: float, maxval: float) -> dict[str, np.ndarray]:
    """The two roundings XLA may give ``jax.random.uniform`` in float16, in numpy from the same bits:
    ``"per-op"``, each operation of the JAX source (``floats * (hi - lo) + lo``) rounded to float16,
    and ``"one rounding"``, the scale and offset in float64 rounded once (what an XLA that widens
    float16 to float32 around a fused multiply-add gives).  Which one a host's XLA takes depends on
    its CPU."""
    bits = prng.random_bits(key, shape, 16, device="cpu").numpy().astype(np.uint16)
    floats = ((bits >> 6) | np.uint16(0x3C00)).view(np.float16) - np.float16(1)
    lo, hi = np.float16(minval), np.float16(maxval)
    wide = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return {
        "per-op": np.maximum(lo, floats * (hi - lo) + lo),
        "one rounding": np.maximum(lo, wide.astype(np.float16)),
    }


def _check_f16_uniform(got: np.ndarray, want: np.ndarray, rules: dict[str, np.ndarray]) -> str:
    """The port's float16 uniforms equal the per-op rule bit for bit, JAX's equal one of the two rules
    bit for bit, and the port equals JAX wherever JAX took the per-op rule; returns the rule JAX took."""
    assert np.array_equal(got, rules["per-op"])
    taken = [name for name, value in rules.items() if np.array_equal(want, value)]
    assert taken, "jax.random.uniform(float16) follows neither rounding rule"
    if "per-op" in taken:
        assert np.array_equal(got, want)
    return taken[0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_uniform_and_normal_equal_jax(seed: int, dtype: str) -> None:
    """Uniforms bit for bit in float32 and bfloat16; in float16 bit for bit the JAX source's per-op
    rounding, and JAX wherever this host's XLA takes that rule (``_f16_rules``: on a CPU without AVX2
    it does, with it XLA may round once).  Normals 1e-4 in float32 and float16, equal in bfloat16;
    in float16 the normal's own uniform follows the per-op rule bit for bit."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    shape = (4, 1000)
    u = prng.uniform(key, shape, tdt, -0.5, 2.0, device="cpu")
    ju = jax.random.uniform(jkey, shape, jdt, -0.5, 2.0)
    if dtype == "float16":
        rule = _check_f16_uniform(u.numpy(), np.asarray(ju), _f16_rules(key, shape, -0.5, 2.0))
        print(f"jax.random.uniform(float16) on this host: {rule}")
        lo = -(1.0 - float(np.finfo(np.float16).eps) / 2)
        inner = prng.uniform(key, shape, tdt, lo, 1.0, device="cpu").numpy()
        assert np.array_equal(inner, _f16_rules(key, shape, lo, 1.0)["per-op"])
    else:
        assert np.array_equal(u.float().numpy(), np.asarray(ju.astype(jnp.float32)))
    z = prng.normal(key, shape, tdt, device="cpu").float().numpy()
    jz = np.asarray(jax.random.normal(jkey, shape, jdt).astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.array_equal(z, jz)
    else:
        np.testing.assert_allclose(z, jz, rtol=0, atol=1e-4 * (1 if dtype == "float32" else 40))
    assert abs(float(z.mean())) < 0.1 and 0.9 < float(z.std()) < 1.1


def test_normal_agrees_over_many_draws() -> None:
    "1e5 float32 normals: max |diff| below 1e-4."
    key, jkey = prng.PRNGKey(17), jax.random.PRNGKey(17)
    z = prng.normal(key, (100_000,), device="cpu").numpy()
    jz = np.asarray(jax.random.normal(jkey, (100_000,), jnp.float32))
    assert np.abs(z - jz).max() < 1e-4


def _engines(sampler: str, steps: int = 4):
    "A port and a JAX engine with the same sampler, schedule and item shape; the model is never run."
    item = (2, 6, 6)
    stochastic = sampler.endswith("SDE")
    port = ServingEngine(
        lambda x, t, s, a: x,
        item,
        sampler=structured.DPM(order=2, stochasticity=1.0 if stochastic else 0.0),
        schedule=scheduling.FlowShift(scheduling.Linear()),
        model_transform=models.FlowModel(),
        steps=steps,
        buckets=(1,),
        device="cpu",
    )
    ref = JaxEngine(
        lambda x, t, s, a: x,
        item,
        sampler=jstruct.DPM(order=2, stochasticity=1.0 if stochastic else 0.0),
        schedule=jsched.FlowShift(jsched.Linear()),
        model_transform=jmodels.FlowModel(),
        steps=steps,
        buckets=(1,),
    )
    return port, ref, item


@pytest.mark.parametrize("sampler", ["DPM2", "DPM2-SDE"])
@pytest.mark.parametrize("img2img", [False, True])
def test_prepare_matches_the_jax_engine(sampler: str, img2img: bool) -> None:
    """``ServingEngine.prepare(seed)`` == the JAX ``_prepare([PRNGKey(seed)])``: x0 (txt2img, and
    img2img's noised initial at its entry point) and, for a stochastic sampler, the step noise."""
    port, ref, item = _engines(sampler)
    initial = np.random.default_rng(3).standard_normal(item, dtype=np.float32)
    start = 2 if img2img else 0
    with port, ref:
        x0, noises = port.prepare(42, torch.from_numpy(initial) if img2img else None, start)
        jx0, jnoises = ref._prepare([jax.random.PRNGKey(42)], jnp.asarray(initial)[None] if img2img else None, start)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0)[0], rtol=0, atol=1e-4)
    if sampler.endswith("SDE"):
        assert noises is not None and noises.shape == (4, *item)
        np.testing.assert_allclose(noises.numpy(), np.asarray(jnoises)[:, 0], rtol=0, atol=1e-4)
    else:
        assert noises is None and jnoises is None
