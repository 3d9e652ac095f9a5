"""The port's mixture-of-experts FFN against the JAX package's, in one process.

The JAX package's ``init_moe_ffn(PRNGKey(11), dim=16, hidden=32,
experts=4)`` tree, as numpy, and its tokens ``normal(PRNGKey(12), (2, 24,
16))`` go through both packages: tests/test_parallel.py:439-489's cases
(capacity dispatch at full capacity against dense routing, overflow giving
exactly zero, the capacity helper).  The ep-sharded cases run on the spawned
gloo worlds of ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from skrample_tpu_torch.parallel import experts as texperts

RTOL, ATOL = 1e-5, 1e-6  # tests/test_parallel.py's tolerances for these cases


@functools.cache
def _setup() -> tuple[dict, dict, np.ndarray, np.ndarray]:
    "The JAX tree and tokens (numpy), the port's copies of them, and the JAX dense output."
    import jax

    from skrample_tpu.parallel import init_moe_ffn, moe_ffn

    params = init_moe_ffn(jax.random.PRNGKey(11), dim=16, hidden=32, experts=4)
    tokens = jax.random.normal(jax.random.PRNGKey(12), (2, 24, 16))
    jax_params = {k: np.asarray(v) for k, v in params.items()}
    mine = {k: torch.from_numpy(v.copy()) for k, v in jax_params.items()}
    return jax_params, mine, np.array(tokens), np.asarray(jax.jit(moe_ffn)(params, tokens))


def _jax_capacity(jax_params: dict, tokens: np.ndarray, capacity: int, method: str) -> np.ndarray:
    "The JAX package's ``moe_ffn_capacity`` (jitted: one compile, not one an op)."
    import jax

    from skrample_tpu.parallel import moe_ffn_capacity

    fn = jax.jit(functools.partial(moe_ffn_capacity, capacity=capacity, method=method))
    return np.asarray(fn(jax_params, tokens))


def test_dense_matches_jax() -> None:
    "Dense top-1 routing, every expert on every token: the JAX ``moe_ffn``'s output."
    _jax_params, params, tokens, dense = _setup()
    got = texperts.moe_ffn(params, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, dense, rtol=RTOL, atol=ATOL)
    assert np.abs(dense).max() > 0.1


@pytest.mark.parametrize("method", ["gather", "onehot"])
def test_capacity_matches_dense_at_full_capacity(method: str) -> None:
    """capacity >= the token count: nothing overflows, the capacity dispatch equals the port's dense
    routing and the JAX package's ``moe_ffn_capacity``."""
    jax_params, params, tokens, dense = _setup()
    got = texperts.moe_ffn_capacity(params, torch.from_numpy(tokens), capacity=2 * 24, method=method).numpy()
    np.testing.assert_allclose(got, dense, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax_capacity(jax_params, tokens, 48, method), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["gather", "onehot"])
def test_overflow_drops_to_zero(method: str) -> None:
    """One slot fewer than the busiest expert's queue: in token order, each expert's first ``cap`` tokens
    match dense routing and the rest are exactly zero, and the whole output is the JAX package's."""
    jax_params, params, tokens, dense = _setup()
    choice = (tokens.reshape(-1, 16) @ jax_params["gate"]).argmax(-1)
    cap = int(np.bincount(choice, minlength=4).max()) - 1
    assert cap >= 1
    got = texperts.moe_ffn_capacity(params, torch.from_numpy(tokens), capacity=cap, method=method).numpy()
    flat, dense_flat = got.reshape(-1, 16), dense.reshape(-1, 16)
    seen = dict.fromkeys(range(4), 0)
    for i, e in enumerate(choice):
        if seen[e] < cap:
            np.testing.assert_allclose(flat[i], dense_flat[i], rtol=RTOL, atol=ATOL)
        else:
            assert np.array_equal(flat[i], np.zeros(16, np.float32))
        seen[e] += 1
    np.testing.assert_allclose(got, _jax_capacity(jax_params, tokens, cap, method), rtol=RTOL, atol=ATOL)


def test_expert_capacity_and_init() -> None:
    """``expert_capacity`` as the JAX helper; ``init_moe_ffn`` draws the JAX tree's shapes and scales from a
    ``torch.Generator``, the same tree from the same seed; the specs split the experts over ``ep``; an
    unknown dispatch method is refused."""
    from skrample_tpu.parallel import expert_capacity

    for tokens, experts, factor in ((64, 4, 1.25), (3, 8, 1.25), (100, 7, 2.0)):
        assert texperts.expert_capacity(tokens, experts, factor) == expert_capacity(tokens, experts, factor)
    assert texperts.expert_capacity(64, 4) == 20
    a, b = (texperts.init_moe_ffn(torch.Generator().manual_seed(3), 64, 256, 8) for _ in range(2))
    assert {k: tuple(v.shape) for k, v in a.items()} == {"gate": (64, 8), "w_in": (8, 64, 256), "w_out": (8, 256, 64)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["w_in"].std()) * 8 - 1) < 0.05 and abs(float(a["w_out"].std()) * 16 - 1) < 0.05
    assert texperts.moe_ffn_spec() == {"gate": (), "w_in": ("ep",), "w_out": ("ep",)}
    _jax_params, params, tokens, _dense = _setup()
    with pytest.raises(ValueError, match="unknown dispatch method"):
        texperts.moe_ffn_capacity(params, torch.from_numpy(tokens), method="scatter")
