"""The port's training slice against the JAX package's, on the CPU.

The same inputs, made from numpy seeds, go through both packages: the
logsumexp forward and the flash backward (the JAX side's Pallas kernels in
interpret mode, the port's plain versions of K4 and K5), the adaLN backward
(K6's plain version), the two autograd Functions against ``jax.vjp``, a
small DiT's loss and every parameter gradient against ``jax.value_and_grad``,
AdamW against ``optax.adamw(1e-4)``, the EMA, ``.npz`` checkpoints in both
directions, one whole training step, and remat.  Everything computes in
float32 unless a test says otherwise.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from skrample_tpu.models import checkpoint as jckpt
from skrample_tpu.models import dit as jdit
from skrample_tpu.models import ema as jema
from skrample_tpu_torch import training
from skrample_tpu_torch.models import checkpoint as tckpt
from skrample_tpu_torch.models import ema as tema
from skrample_tpu_torch.models.dit import _DOTS_CONTEXT, DiT, DiTConfig, _dense, random_param_tree
from skrample_tpu_torch.ops import adaln, flash_attention

# the JAX package's ops re-exports functions named like its modules: reach the modules themselves
jflash = importlib.import_module("skrample_tpu.ops.flash_attention")
jadaln = importlib.import_module("skrample_tpu.ops.adaln")

B, N, HEADS, D_HEAD = 2, 256, 2, 128
# dim 256 / heads 2 -> head_dim 128 (the fused-qkv path); (2, 4, 32, 32) latents at patch 2 -> N = 256
SMALL = {"dim": 256, "depth": 2, "heads": 2}
TINY = {"dim": 128, "depth": 2, "heads": 1}  # the optimizer, EMA and remat tests: fewer, smaller leaves
LATENT = (2, 4, 32, 32)


def _normal(seed: int, shape: tuple[int, ...], scale: float = 1.0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _counters() -> tuple[int, ...]:
    return (
        flash_attention.flash_attention_qkv_forward.launches,
        flash_attention.flash_attention_qkv_forward_lse.launches,
        flash_attention.flash_attention_qkv_backward.launches,
        adaln.adaln_forward.launches,
        adaln.adaln_backward.launches,
    )


# ---- K4 and K5: the plain versions against the JAX package's Pallas kernels ------------


def test_lse_forward_matches_jax() -> None:
    "K4's plain version vs the JAX Pallas kernel (interpret mode): o atol 2e-5, lse atol 1e-4, as tests/test_ops.py."
    qkv = _normal(0, (B, N, 3 * HEADS * D_HEAD))
    want_o, want_lse = jflash.flash_attention_qkv_forward_lse(jnp.asarray(qkv), HEADS, interpret=True)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(torch.from_numpy(qkv), HEADS)
    assert lse.shape == (B, HEADS, N, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-4)


def test_backward_matches_jax() -> None:
    "K5's plain version vs the JAX Pallas backward on the same (qkv, o, lse, g): atol 2e-4, as tests/test_ops.py."
    qkv = jnp.asarray(_normal(1, (B, N, 3 * HEADS * D_HEAD)))
    g = _normal(2, (B, N, HEADS * D_HEAD))
    o, lse = jflash.flash_attention_qkv_forward_lse(qkv, HEADS, interpret=True)
    want = jflash.flash_attention_qkv_backward(qkv, o, lse, jnp.asarray(g), HEADS, interpret=True)
    got = flash_attention.flash_attention_qkv_backward(
        *(torch.from_numpy(np.array(a)) for a in (qkv, o, lse, g)), HEADS
    )
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaln_backward_matches_jax(dtype: str) -> None:
    """K6's plain version vs the JAX Pallas backward (interpret mode); tolerances as
    tests/test_ops.py's adaLN sweep: atol 1e-5 (f32) or 5e-2 (bf16), times 10 for dx and
    times N for the sums over tokens."""
    b, n, d = 2, 64, 256
    x = _normal(3, (b, n, d), 2.0) + np.float32(0.1)
    g = _normal(4, (b, n, d))
    mods = _normal(5, (b, 3 * d))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = mods[:, 2 * d :]
    want = jadaln.adaln_backward(
        jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt), jnp.asarray(scale).astype(jdt), interpret=True
    )
    # scale as a column chunk of the modulation matrix, as the DiT hands it over
    tmods = torch.from_numpy(mods).to(tdt)
    got = adaln.adaln_backward(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), tmods[:, 2 * d :])
    atol = 1e-5 if dtype == "float32" else 5e-2
    for name, mine, ref, tol in zip(("dx", "dshift", "dscale"), got, want, (atol * 10, atol * n, atol * n)):
        assert mine.dtype == (tdt if name == "dx" else torch.float32)
        np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=tol, err_msg=name)


# ---- the autograd Functions against jax.vjp -------------------------------------------


def test_flash_attention_grad_matches_jax_vjp() -> None:
    """Autograd through ``flash_attention_qkv`` (the K4/K5 Function, plain versions on the CPU)
    vs ``jax.vjp`` of the JAX public function: outputs atol 2e-5, gradients atol 2e-4."""
    qkv = _normal(6, (B, N, 3 * HEADS * D_HEAD))
    g = _normal(7, (B, N, HEADS * D_HEAD))
    want, vjp = jax.vjp(lambda a: jflash.flash_attention_qkv(a, HEADS), jnp.asarray(qkv))
    (want_grad,) = vjp(jnp.asarray(g))

    t = torch.from_numpy(qkv).requires_grad_(True)
    before = _counters()
    out = flash_attention.flash_attention_qkv(t, HEADS)
    assert type(out.grad_fn).__name__ == "_FlashQKVBackward"
    out.backward(torch.from_numpy(g))
    assert _counters() == before  # CPU tensors take the plain versions: no kernel launches
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=0, atol=2e-4)


def test_flash_attention_without_grad_takes_the_forward_only_path() -> None:
    "No gradient wanted: no Function node, nothing saved (on the card this is K2, not K4)."
    qkv = torch.from_numpy(_normal(8, (1, 128, 3 * 128)))
    assert flash_attention.flash_attention_qkv(qkv, 1).grad_fn is None
    with torch.no_grad():
        assert flash_attention.flash_attention_qkv(qkv.requires_grad_(True), 1).grad_fn is None


def test_adaln_grad_matches_jax_vjp() -> None:
    """Autograd through ``adaln_modulate`` (the K3/K6 Function) vs ``jax.vjp`` of the JAX
    public function, shift and scale as column chunks: atol 1e-5 on the output, 1e-4 on dx,
    1e-5 * N on dshift and dscale."""
    b, n, d = 2, 64, 256
    x = _normal(9, (b, n, d), 2.0)
    mods = _normal(10, (b, 3 * d))
    g = _normal(11, (b, n, d))
    jm = jnp.asarray(mods)
    want, vjp = jax.vjp(lambda xx, m: jadaln.adaln_modulate(xx, m[:, :d], m[:, 2 * d :]), jnp.asarray(x), jm)
    want_dx, want_dm = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_(True)
    tm = torch.from_numpy(mods).requires_grad_(True)
    out = adaln.adaln_modulate(tx, tm[:, :d], tm[:, 2 * d :])
    assert type(out.grad_fn).__name__ == "_AdaLNBackward"
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(want_dm), rtol=0, atol=1e-5 * n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_bias_add_is_safe_under_autograd(dtype: torch.dtype) -> None:
    """``_dense``'s float32 bias add writes a new tensor, never into the product that
    ``remat="dots"`` keeps: under a "dots" checkpoint the output and the input, weight and
    bias gradients equal those without, exactly.  The bias gradient is the float32 sum of the
    output gradient over rows in both dtypes, as JAX sums its float32 cotangent (ROADMAP C4,
    repaired; ``tests/test_torch_dense.py`` holds it to the JAX ``_dense``)."""
    layer = torch.nn.Linear(64, 96)
    torch.nn.init.normal_(layer.bias)
    x = torch.from_numpy(_normal(12, (2, 8, 64))).to(dtype)
    g = torch.from_numpy(_normal(13, (2, 8, 96))).to(dtype)
    results = []
    for remat in (False, "dots"):
        layer.zero_grad()
        xx = x.clone().requires_grad_(True)

        def fn(a: torch.Tensor) -> torch.Tensor:
            return torch.tanh(_dense(layer, a, dtype))

        y = checkpoint(fn, xx, use_reentrant=False, context_fn=_DOTS_CONTEXT) if remat else fn(xx)
        y.backward(g)
        results.append((y.detach(), xx.grad, layer.weight.grad.clone(), layer.bias.grad.clone()))
    (y0, dx0, dw0, db0), (y1, dx1, dw1, db1) = results
    for a, b in ((y0, y1), (dx0, dx1), (dw0, dw1), (db0, db1)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert db0.dtype == torch.float32
    dz = (g.float() * (1 - y0.float() ** 2)).to(dtype)  # tanh's backward, as autograd rounds it
    torch.testing.assert_close(db0, dz.float().reshape(-1, 96).sum(0), rtol=1e-5, atol=1e-5)


# ---- the model: loss and every gradient against jax.value_and_grad ---------------------


def _jax_loss(model: jdit.DiT):
    def loss_fn(params, x0, noise, sigma):
        s = sigma[:, None, None, None]
        xt = (1 - s) * x0 + s * noise
        pred = model.apply(params, xt, sigma * 1000.0)
        return jnp.mean((pred - (noise - x0)) ** 2)

    return loss_fn


def _batch(seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(LATENT, dtype=np.float32)
    noise = rng.standard_normal(LATENT, dtype=np.float32)
    sigma = rng.uniform(1e-3, 1.0, LATENT[0]).astype(np.float32)
    return x0, noise, sigma


def _port(tree: dict, size: dict = SMALL, **kwargs) -> DiT:
    config = DiTConfig(**size, compute_dtype=torch.float32, attention="flash", **kwargs)
    return DiT(config, device="cpu").load_jax_params(tree)


def _jax_model() -> jdit.DiT:
    return jdit.DiT(jdit.DiTConfig(**SMALL, compute_dtype=jnp.float32, attention="flash"))


def _as_tree(config: DiTConfig, by_name: dict[str, torch.Tensor]) -> dict:
    "Tensors keyed like ``named_parameters`` (grads, an EMA shadow) -> the JAX tree layout."
    holder = DiT(config, device="cpu")
    holder.load_state_dict(by_name)
    return holder.param_tree()


def _assert_trees_close(got: dict, want, rtol: float, rel_atol: float, atol: float = 0.0) -> None:
    "Leaf by leaf: rtol, and an atol of ``atol`` plus ``rel_atol`` times the leaf's largest magnitude."
    flat_got, flat_want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for path, a, b in zip(jax.tree_util.tree_leaves_with_path(want), flat_got, flat_want):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol + rel_atol * float(np.abs(b).max()), err_msg=jax.tree_util.keystr(path[0])
        )


def test_dit_loss_and_grads_match_jax() -> None:
    """The flow-matching loss and every parameter's gradient of a random-weight DiT
    (dim 256, depth 2, heads 2, N 256, f32) vs ``jax.value_and_grad``: loss rtol 1e-4;
    grads rtol 1e-4 with an atol of 1e-5 of each leaf's largest gradient (matmuls and
    reductions sum in another order)."""
    tree = random_param_tree(DiTConfig(**SMALL), seed=0)
    x0, noise, sigma = _batch(1)
    want_loss, want_grads = jax.value_and_grad(_jax_loss(_jax_model()))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(sigma)
    )

    model = _port(tree)
    loss = training.flow_matching_loss(model, *(torch.from_numpy(a) for a in (x0, noise, sigma)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    grads = _as_tree(model.config, {name: p.grad for name, p in model.named_parameters()})
    _assert_trees_close(grads, want_grads, rtol=1e-4, rel_atol=1e-5)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_grads_of_no_remat(remat: bool | str) -> None:
    "Per-block recompute (the whole block, or all but the matmul outputs): the same loss and grads, atol 1e-6."
    tree = random_param_tree(DiTConfig(**TINY), seed=2)
    batch = [torch.from_numpy(a) for a in _batch(3)]
    grads = []
    for mode in (False, remat):
        model = _port(tree, TINY, remat=mode)
        loss = training.flow_matching_loss(model, *batch)
        loss.backward()
        grads.append((loss.item(), [p.grad for p in model.parameters()]))
    assert grads[0][0] == pytest.approx(grads[1][0], abs=1e-6)
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def test_remat_rejects_an_unknown_policy() -> None:
    with pytest.raises(ValueError, match="remat"):
        DiT(DiTConfig(**SMALL, remat="everything"), device="cpu")


# ---- optimizer and EMA ------------------------------------------------------------------


def test_adamw_matches_optax() -> None:
    """``make_optimizer`` vs ``optax.adamw(1e-4)`` over 3 steps fed identical gradients: rtol
    1e-6 and an atol of 1e-6 of each leaf's largest magnitude (a last-ulp difference in an
    element near 0)."""
    model = _port(random_param_tree(DiTConfig(**TINY), seed=4), TINY)
    params = jax.tree.map(jnp.asarray, model.param_tree())
    opt, jopt = training.make_optimizer(model), optax.adamw(1e-4)
    state = jopt.init(params)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for step in range(3):
        grad_tree = jax.tree.map(
            lambda leaf, s=step: _normal(100 + s + leaf.size % 97, leaf.shape, 1e-2), model.param_tree()
        )
        params, state = jax_step(jax.tree.map(jnp.asarray, grad_tree), state, params)
        holder = DiT(model.config, device="cpu").load_jax_params(grad_tree)
        for p, g in zip(model.parameters(), holder.parameters()):
            p.grad = g.detach()
        opt.step()
    _assert_trees_close(model.param_tree(), params, rtol=1e-6, rel_atol=1e-6)


@pytest.mark.parametrize("step", [0, 5, None])
def test_ema_matches_jax(step: int | None) -> None:
    "``ema_update`` vs the JAX package's at a warm-up step, later, and without a step: f32, tolerances as AdamW's."
    config = DiTConfig(**TINY)
    old, new = random_param_tree(config, 5), random_param_tree(config, 6)
    want = jema.ema_update(jax.tree.map(jnp.asarray, old), jax.tree.map(jnp.asarray, new), decay=0.999, step=step)
    ema = tema.ema_init(_port(old, TINY))
    tema.ema_update(ema, _port(new, TINY), decay=0.999, step=step)
    _assert_trees_close(_as_tree(DiTConfig(**TINY, compute_dtype=torch.float32), ema), want, rtol=1e-6, rel_atol=1e-6)
    for s in (0, 3, 10_000):
        assert tema.ema_decay_schedule(s, 0.999) == np.float32(jema.ema_decay_schedule(s, 0.999))


# ---- checkpoints in both directions -----------------------------------------------------


def test_npz_checkpoints_cross_both_ways(tmp_path) -> None:
    "The port reads the JAX package's files and the JAX package the port's: the same keys, bit-identical leaves."
    model = _port(random_param_tree(DiTConfig(**SMALL), seed=7))
    tree = {**model.param_tree(), "extra": [None, {"step": np.int32(3)}]}
    tckpt.save_params(tmp_path / "port.npz", tree)
    jckpt.save_params(tmp_path / "jax.npz", jax.tree.map(jnp.asarray, tree))
    for path in ("port.npz", "jax.npz"):
        for load in (tckpt.load_params, jckpt.load_params):
            back = load(tmp_path / path)
            assert back["extra"][0] is None and int(back["extra"][1]["step"]) == 3
            assert jax.tree.structure(back) == jax.tree.structure(tree)
            for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    # a torch tensor leaf is saved as its numpy array
    tckpt.save_params(tmp_path / "t.npz", {"w": torch.arange(4.0)})
    np.testing.assert_array_equal(tckpt.load_params(tmp_path / "t.npz")["w"], np.arange(4.0, dtype=np.float32))


def test_param_tree_inverts_load_jax_params() -> None:
    tree = random_param_tree(DiTConfig(**SMALL), seed=8)
    back = _port(tree).param_tree()
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


# ---- one whole training step --------------------------------------------------------------


def test_train_step_matches_jax() -> None:
    """``training.train_step`` vs the JAX example's step (value_and_grad, optax.adamw(1e-4),
    ema_update at step 0) on the same params, x0, noise and sigma.

    Loss rtol 1e-4.  AdamW's first step moves each weight by lr * g / (|g| + eps): where
    |g| >= 1e-6 (a hundred times eps) that is insensitive to the gradients' f32 differences,
    and params and EMA agree to rtol 1e-5, atol 1e-7; where |g| is near eps it magnifies
    them, and the check there is the most one step can move a weight, 2.1 * lr.  (The key
    bias's gradient is 0 up to rounding: softmax ignores a per-row constant.)"""
    tree = random_param_tree(DiTConfig(**SMALL), seed=9)
    x0, noise, sigma = _batch(10)
    params = jax.tree.map(jnp.asarray, tree)
    jopt = optax.adamw(1e-4)
    loss, grads = jax.value_and_grad(_jax_loss(_jax_model()))(
        params, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(sigma)
    )
    updates, _ = jopt.update(grads, jopt.init(params), params)
    new_params = optax.apply_updates(params, updates)
    new_ema = jema.ema_update(params, new_params, decay=0.9999, step=0)

    model = _port(tree)
    opt = training.make_optimizer(model)
    ema = tema.ema_init(model)
    got = training.train_step(model, opt, ema, *(torch.from_numpy(a) for a in (x0, noise, sigma)), step=0)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    for mine, want in ((model.param_tree(), new_params), (_as_tree(model.config, ema), new_ema)):
        leaves = (jax.tree.leaves(t) for t in (mine, want, grads))
        for path, a, b, g in zip(jax.tree_util.tree_leaves_with_path(want), *leaves):
            b, g = np.asarray(b), np.asarray(g)
            steady = np.abs(g) >= 1e-6
            where = jax.tree_util.keystr(path[0])
            np.testing.assert_allclose(a[steady], b[steady], rtol=1e-5, atol=1e-7, err_msg=where)
            assert np.abs(a - b).max() <= 2.1e-4, where


def test_training_cli_on_cpu(tmp_path, capsys) -> None:
    "``python -m skrample_tpu_torch.training --device cpu``: finite losses, and a checkpoint the JAX package loads."
    path = tmp_path / "dit.npz"
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--dim", "128", "--heads", "1", "--depth", "1"]
    argv += ["--checkpoint", str(path)]
    assert training.main(argv) == 0
    tree = jckpt.load_params(path)
    assert len(tree["blocks"]) == 1 and tree["blocks"][0]["qkv"]["w"].shape == (128, 384)
    assert training.main(argv) == 0  # resumes from the file
    out = capsys.readouterr().out
    assert "resumed from" in out and "loss" in out


def test_training_needs_cuda_unless_told_cpu(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.main(["--steps", "1"])


# ---- the example's other flags: --host-loader, the refusals ---------------------------------


def test_host_loader_step_matches_jax() -> None:
    """Step 0 of ``--host-loader`` mode against the JAX example's host-loader step: the data set
    ``normal(PRNGKey(42))``, the loader (``PRNGKey(7)``), the step's ``fold_in(PRNGKey(1), n)`` draws,
    then the step, on the same parameters (a DiT of head dim 64 with plain attention on both sides).
    The batch is the JAX loader's bit for bit in its indices and within the normals' few ulps in
    value; loss, parameters and EMA at ``test_train_step_matches_jax``'s tolerances."""
    from skrample_tpu import data as jdata
    from skrample_tpu_torch import data as tdata
    from skrample_tpu_torch import prng

    size, batch = {"dim": 64, "depth": 1, "heads": 1}, 4
    tree = random_param_tree(DiTConfig(**size), seed=21)

    @jax.jit
    def draws():  # the JAX example's draws, compiled once
        _kb, kn, kt = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0), 3)
        jset = jax.random.normal(jax.random.PRNGKey(42), (64, 4, 8, 8), jnp.float32)
        return jset, jax.random.normal(kn, (batch, 4, 8, 8), jnp.float32), jax.random.uniform(kt, (batch,), minval=1e-3, maxval=1.0)

    jset, jnoise, jsigma = draws()
    jx0 = jdata.EpochLoader({"x0": np.asarray(jset)}, batch, jax.random.PRNGKey(7)).batch_at(0)["x0"]
    params = jax.tree.map(jnp.asarray, tree)
    jmodel = jdit.DiT(jdit.DiTConfig(**size, compute_dtype=jnp.float32, attention="full"))
    jopt = optax.adamw(1e-4)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel)))(params, jnp.asarray(jx0), jnoise, jsigma)
    new_params = jax.jit(lambda p, g: optax.apply_updates(p, jopt.update(g, jopt.init(p), p)[0]))(params, grads)
    new_ema = jax.jit(lambda p, q: jema.ema_update(p, q, decay=0.9999, step=0))(params, new_params)

    host = training.host_dataset(8)
    np.testing.assert_allclose(host.numpy(), np.asarray(jset), rtol=1e-5, atol=0)
    first = tdata.EpochLoader({"x0": host}, batch, prng.PRNGKey(7)).batch_at(0)
    x0, noise, sigma = training.host_loader_batch(first, 0, torch.device("cpu"))
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-5, atol=0)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jnoise), rtol=1e-5, atol=0)
    assert np.array_equal(sigma.numpy(), np.asarray(jsigma))
    model = DiT(DiTConfig(**size, compute_dtype=torch.float32, attention="full"), device="cpu").load_jax_params(tree)
    opt = training.make_optimizer(model)
    ema = tema.ema_init(model)
    got = training.train_step(model, opt, ema, x0, noise, sigma, step=0)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    for mine, want in ((model.param_tree(), new_params), (_as_tree(model.config, ema), new_ema)):
        leaves = (jax.tree.leaves(t) for t in (mine, want, grads))
        for path, a, b, g in zip(jax.tree_util.tree_leaves_with_path(want), *leaves):
            b, g = np.asarray(b), np.asarray(g)
            steady = np.abs(g) >= 1e-6
            where = jax.tree_util.keystr(path[0])
            np.testing.assert_allclose(a[steady], b[steady], rtol=1e-5, atol=1e-7, err_msg=where)
            assert np.abs(a - b).max() <= 2.1e-4, where


@pytest.mark.parametrize(
    ("argv", "message"),
    [
        (["--until", "1"], "already holds step 2: pass --resume"),
        (["--resume", "--until", "1"], "--until 1 is before the restored step 2"),
        (["--resume", "--save-every", "1"], "need --host-loader and --orbax"),
        (["--host-loader", "--abort-after-step", "0", "--no-orbax"], "need --host-loader and --orbax"),
        (["--graph"], "needs --device cuda"),
        (["--fsdp"], "--fsdp shards over the dp axis; pass --dp > 1"),
    ],
)
def test_training_flags_refuse_as_the_example_does(tmp_path, capsys, argv: list[str], message: str) -> None:
    """The example's rules: an existing checkpoint without --resume, --until before the restored step,
    --save-every/--abort-after-step without --host-loader and --orbax, --graph without a card, --fsdp
    without --dp > 1."""
    base = ["--device", "cpu", "--batch", "2", "--dim", "64", "--heads", "1", "--depth", "1", "--size", "8"]
    ckpt = ["--orbax", str(tmp_path / "ck")]
    assert training.main([*base, *ckpt, "--steps", "2"]) == 0
    if "--no-orbax" in argv:
        argv, ckpt = [a for a in argv if a != "--no-orbax"], []
    with pytest.raises(SystemExit):
        training.main([*base, *ckpt, *argv])
    assert message in capsys.readouterr().err
