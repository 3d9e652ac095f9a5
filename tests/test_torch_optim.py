"""The port's 8-bit AdamW and bf16 stochastic rounding against the JAX package's ``optim.py``.

The same float32 parameters and gradients, drawn from numpy seeds, go
through ``skrample_tpu.optim.adamw8bit`` and the port's functional pair and
optimizer class on the CPU.  Tolerances, each stated where it is used: a
small (float32-moment) leaf within 1 float32 ulp of JAX's; a quantized
leaf's codes equal except where ``127 * cbrt`` lies on a rounding boundary
(PyTorch has no ``cbrt``: the port takes it in float64), its scales and
updates within a few ulps, its dequantized moments within one code step;
stochastic rounding bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import optim as joptim
from skrample_tpu_torch import optim, prng

SHAPES = {"bias": (96,), "w": (80, 70), "w_tail": (4099,)}  # one small leaf, two quantized (one ragged block)


def _tree(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s, dtype=np.float32) * np.float32(scale)) for k, s in SHAPES.items()}


def _order(tree: dict) -> list[str]:
    "jax's flatten order of a flat dict: its sorted keys."
    return [jax.tree_util.keystr(p[0])[2:-2] for p in jax.tree_util.tree_leaves_with_path(tree)]


def _run_jax(steps: int, lr=1e-3):
    opt = joptim.adamw8bit(lr)
    params = jax.tree.map(jnp.asarray, _tree(0))
    state = opt.init(params)
    out = []
    for i in range(steps):
        grads = jax.tree.map(jnp.asarray, _tree(10 + i, 0.01))
        updates, state = opt.update(grads, state, params)  # eager: op for op, as the port computes
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        out.append((updates, state))
    return params, out


def _run_port(steps: int, lr=1e-3):
    names = _order(_tree(0))
    params = [torch.from_numpy(_tree(0)[k]) for k in names]
    state = optim.adamw8bit_init(params)
    out = []
    for i in range(steps):
        grads = [torch.from_numpy(_tree(10 + i, 0.01)[k]) for k in names]
        updates, state = optim.adamw8bit_update(grads, state, params, lr)
        params = [p + u for p, u in zip(params, updates)]
        out.append((updates, state))
    return names, params, out


K_UPDATE = 4  # roundings a side in the update's bound (see the test below)


def _update_oracle(m_prev: np.ndarray, v_prev: np.ndarray, g: np.ndarray, p: np.ndarray, count: int, lr=1e-3):
    """The small leaf's AdamW update in float64 from float32 inputs, with the float32 constants and the
    float32 bias corrections both packages compute (``1 - power(float32(b), count)``, equal here):
    ``(update, S)``, where ``S = |lr| * (|step| * (1 + (|b1 m_prev| + |(1 - b1) g|) / |m|) + wd |p|)``
    sums the magnitudes of the terms whose float32 roundings the update carries, the first moment's
    cancellation (``/ |m|``) included."""
    f = lambda a: float(np.float32(a))  # noqa: E731
    one, cf = torch.ones(()), torch.tensor(float(count))
    c1, c2 = (float(one - torch.pow(one * b, cf)) for b in (0.9, 0.999))
    m_terms = (f(0.9) * m_prev.astype(np.float64), f(1 - 0.9) * g.astype(np.float64))
    m = m_terms[0] + m_terms[1]
    v = f(0.999) * v_prev.astype(np.float64) + f(1 - 0.999) * np.square(g.astype(np.float64))
    step = (m / c1) / (np.sqrt(v / c2) + 1e-8)
    update = -f(lr) * (step + f(1e-4) * p.astype(np.float64))
    cancel = (np.abs(m_terms[0]) + np.abs(m_terms[1])) / np.abs(m)
    return update, f(lr) * (np.abs(step) * (1 + cancel) + f(1e-4) * np.abs(p))


def test_adamw8bit_small_leaf_matches_jax_to_one_ulp() -> None:
    """Three steps: the float32-moment leaf's m, v and parameter within 1 f32 ulp of JAX's.  The
    update: the port, JAX and the two against each other within ``K_UPDATE * eps32 * S`` of a float64
    oracle, element by element (``_update_oracle``; both sides differ from it alike, by up to ~2
    roundings of ``S``, so two packages' last-bit differences in ``sqrt`` and the divisions reach 2-3
    ulps of the update on some hosts)."""
    jparams, jout = _run_jax(3)
    names, params, out = _run_port(3)
    i = names.index("bias")
    eps32 = float(np.finfo(np.float32).eps)
    p = _tree(0)["bias"]
    m_prev = v_prev = np.zeros_like(p)
    for step, ((jupd, jstate), (upd, state)) in enumerate(zip(jout, out)):
        mom = state.moments[i]
        assert isinstance(mom, optim.MomentF32)
        np.testing.assert_array_max_ulp(mom.m.numpy(), np.asarray(jstate.moments["bias"].m), maxulp=1)
        np.testing.assert_array_max_ulp(mom.v.numpy(), np.asarray(jstate.moments["bias"].v), maxulp=1)
        g = _tree(10 + step, 0.01)["bias"]
        oracle, S = _update_oracle(m_prev, v_prev, g, p, step + 1)
        bound = K_UPDATE * eps32 * S
        mine, theirs = upd[i].numpy().astype(np.float64), np.asarray(jupd["bias"]).astype(np.float64)
        for name, a, b in (("port", mine, oracle), ("jax", theirs, oracle), ("port vs jax", mine, theirs)):
            excess = np.abs(a - b) / bound
            assert excess.max() <= 1, f"step {step}: {name} {excess.max():.3f} of the bound"
        assert int(state.count) == int(jstate.count)
        m_prev, v_prev, p = mom.m.numpy(), mom.v.numpy(), p + upd[i].numpy()
    np.testing.assert_array_max_ulp(params[i].numpy(), np.asarray(jparams["bias"]), maxulp=1)


def test_adamw8bit_quantized_leaves_match_jax() -> None:
    """Three steps: the quantized leaves' codes equal JAX's except at rounding ties (fewer than 0.1%
    of the codes, each one code apart), the scales within 4 f32 ulps, the dequantized moments within
    one code step of JAX's, the updates within 1e-5 relative of the largest (a tie moves a moment by
    one code)."""
    _, jout = _run_jax(3)
    names, _, out = _run_port(3)
    ties = total = 0
    for (jupd, jstate), (upd, state) in zip(jout, out):
        for name in ("w", "w_tail"):
            i = names.index(name)
            mom, jmom = state.moments[i], jstate.moments[name]
            assert isinstance(mom, optim.Moment8) and mom.mq.dtype == torch.int8 and mom.ms.shape == jmom.ms.shape
            for q, jq in ((mom.mq, jmom.mq), (mom.vq, jmom.vq)):
                diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
                assert diff.max() <= 1
                ties += int((diff > 0).sum())
                total += diff.size
            for s, js in ((mom.ms, jmom.ms), (mom.vs, jmom.vs)):
                np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=4)
            m = optim._dequant_signed(mom.mq, mom.ms).numpy()
            jm = np.asarray(joptim._dequant_signed(jmom.mq, jmom.ms))
            step = np.asarray(jmom.ms) * (3 / 127)  # the widest code step of the cube code: d(t^3) <= 3 dt
            assert (np.abs(m - jm) <= step + 1e-12).all()
            want = np.asarray(jupd[name])
            np.testing.assert_allclose(upd[i].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert ties < 1e-3 * total, f"{ties} of {total} codes differ"


def test_adamw8bit_class_is_the_functional_pair_and_counts_state_bytes() -> None:
    """``AdamW8bit.step`` updates parameters exactly as the functional pair does (a callable
    learning rate of the count included), keeps the count and the moments in its state, round-trips
    its ``state_dict``, and holds about 2.03 bytes a parameter against AdamW's 8."""
    names = _order(_tree(0))
    lr = lambda count: 1e-3 / count.float()  # noqa: E731
    params = [torch.nn.Parameter(torch.from_numpy(_tree(0)[k].copy())) for k in names]
    opt = optim.AdamW8bit(params, lr=lr)
    ref = [torch.from_numpy(_tree(0)[k]) for k in names]
    state = optim.adamw8bit_init(ref)
    for i in range(2):
        grads = [torch.from_numpy(_tree(10 + i, 0.01)[k]) for k in names]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        updates, state = optim.adamw8bit_update(grads, state, ref, lr)
        ref = [p + u for p, u in zip(ref, updates)]
    for p, r in zip(params, ref):
        assert torch.equal(p.detach(), r)
    assert int(opt.state["count"]) == 2
    saved = opt.state_dict()
    fresh = optim.AdamW8bit([torch.nn.Parameter(p.detach().clone()) for p in params], lr=lr)
    fresh.load_state_dict(saved)
    for p, q in zip(params, fresh._params()):
        for name, value in opt.state[p].items():
            assert torch.equal(fresh.state[q][name], value)
    assert optim.optimizer_state_bytes(saved) == optim.optimizer_state_bytes(state)  # the same tensors
    big = [torch.zeros(1 << 20)]
    per_param = optim.optimizer_state_bytes(optim.adamw8bit_init(big)) / big[0].numel()
    assert abs(per_param - (2 + 8 / 256)) < 1e-3  # 2 int8 codes + 2 f32 scales a 256-block; the count's 4 bytes aside
    adamw = torch.optim.AdamW(big, lr=1e-3)
    big[0].grad = torch.ones_like(big[0])
    adamw.step()
    assert optim.optimizer_state_bytes(adamw.state_dict()) >= 8 * big[0].numel()


def test_stochastic_round_bf16_is_jax_bit_for_bit() -> None:
    "The SR of float32 values (non-finite ones included) to bfloat16: the same 16-bit words as JAX's."
    x = np.random.default_rng(3).standard_normal((33, 17), dtype=np.float32) * np.float32(5)
    x[0, :4] = [np.inf, -np.inf, np.nan, 3.3895314e38]  # the last rounds up to inf at times
    key = prng.PRNGKey(5)
    got = optim.stochastic_round_bf16(key, torch.from_numpy(x))
    want = joptim.stochastic_round_bf16(jax.random.PRNGKey(5), jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), np.asarray(want).view(np.uint16))
    # unbiased: the mean of many roundings of one value is the value
    one = torch.full((1 << 16,), 1.0 + 2**-10)
    mean = optim.stochastic_round_bf16(prng.PRNGKey(9), one).float().mean().item()
    assert abs(mean - (1.0 + 2**-10)) < 2**-12


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_apply_updates_sr_is_jax_bit_for_bit(dtype: str) -> None:
    """``apply_updates_sr`` over a tree of bfloat16 leaves (and one float32 leaf): a stream a leaf
    folded from the key by its index in jax's flatten order; the same words as JAX's."""
    rng = np.random.default_rng(4)
    tree = {"b": rng.standard_normal((7, 9), dtype=np.float32), "a": rng.standard_normal(40, dtype=np.float32),
            "c": rng.standard_normal((3, 5), dtype=np.float32)}
    upd = {k: rng.standard_normal(v.shape, dtype=np.float32) * np.float32(1e-3) for k, v in tree.items()}
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    jparams = {k: jnp.asarray(v).astype(jdt if k != "c" else jnp.float32) for k, v in tree.items()}
    want = joptim.apply_updates_sr(jparams, jax.tree.map(jnp.asarray, upd), jax.random.PRNGKey(11))
    names = _order(tree)
    params = [torch.from_numpy(np.array(jparams[k].astype(jnp.float32))).to(getattr(torch, dtype) if k != "c" else torch.float32)
              for k in names]
    got = optim.apply_updates_sr(params, [torch.from_numpy(upd[k]) for k in names], prng.PRNGKey(11))
    for k, g in zip(names, got):
        w = np.asarray(want[k])
        assert str(g.dtype).endswith(str(w.dtype))
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16)), k
        else:
            assert np.array_equal(g.numpy(), w), k
