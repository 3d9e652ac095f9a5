"""The port's MMDiT against the JAX package's, on the same random weights.

Every weight, bias, RMS gain, null context and position table is drawn at
random from a numpy seed (``random_param_tree``) and carried into both
packages; the adaLN-zero initialisation would make both output exactly 0.
A small configuration in float32: dim 128 over 2 heads of 64 (SD3's head
dim: B10's route on the card, its plain version here), depth 3 with a dual
attention at block 0 and a pre-only last text stream, context width 96,
16x16 latents (64 image tokens) beside 128 text tokens, in both
conditioning wirings, with and without SD3.5's qk-norm and the cropped
position table.  The JAX side reaches its Pallas adaLN as its own tests do
on the CPU.  Every case shares the token counts, so the JAX side compiles
each primitive once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.models import mmdit as jmmdit
from skrample_tpu_torch.models.conditioning import guided_mix
from skrample_tpu_torch.models.mmdit import MMDiT, MMDiTConfig, mmdit_forward_flops, random_param_tree
from skrample_tpu_torch.ops.quant import Int8Dense

SMALL = {
    "dim": 128, "heads": 2, "depth": 3, "channels": 4, "context_dim": 96, "context_tokens": 128,
    "dual_attention_layers": (0,), "final_txt_pre_only": True,
}
CASES = {
    "native": {},
    "native qk-norm pos-embed": {"qk_norm": True, "pos_embed_max": 12},
    "sd3": {"pooled_dim": 24},
    "sd3 qk-norm pos-embed": {"pooled_dim": 24, "qk_norm": True, "pos_embed_max": 12},
}
LATENT, POOLED = (2, 4, 16, 16), 24


def _pair(case: str, seed: int = 0, **extra):
    kw = {**SMALL, **CASES[case], **extra}
    config = MMDiTConfig(**kw, compute_dtype=torch.float32)
    tree = random_param_tree(config, seed)
    port = MMDiT(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jmmdit.MMDiT(jmmdit.MMDiTConfig(**kw, compute_dtype=jnp.float32))
    return port, ref, jax.tree.map(jnp.asarray, tree)


def _inputs(case: str, seed: int = 1) -> tuple:
    "x, t, context (40 tokens natively: the null pads them to 128; 128 under the SD3 wiring), pooled or None."
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(LATENT, dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    sd3 = "sd3" in case
    ctx = rng.standard_normal((LATENT[0], 128 if sd3 else 40, SMALL["context_dim"]), dtype=np.float32)
    pooled = rng.standard_normal((LATENT[0], POOLED), dtype=np.float32) if sd3 else None
    return x, t, ctx, pooled


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got: torch.Tensor, want, rtol: float = 1e-4) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case: str) -> None:
    "Both wirings, with and without qk-norm and the cropped position table: rtol 1e-4."
    port, ref, tree = _pair(case)
    x, t, ctx, pooled = _inputs(case)
    want = jax.jit(ref.apply)(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), _j(pooled))
    got = port(_t(x), _t(t), _t(ctx), _t(pooled))
    assert got.shape == LATENT and got.dtype == torch.float32
    _close(got, want)


def test_embed_context_follows_the_jax_rules() -> None:
    "Native: pad with the learned null, truncate, all null for None, exactly as JAX; SD3: pass through, None raises."
    port, ref, tree = _pair("native")
    rng = np.random.default_rng(2)
    for tokens in (40, 128, 160):
        ctx = rng.standard_normal((2, tokens, SMALL["context_dim"]), dtype=np.float32)
        got = port.embed_context(torch.from_numpy(ctx), 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.embed_context(tree, jnp.asarray(ctx), 2)))
        assert got.shape == (2, 128, SMALL["context_dim"])
    np.testing.assert_array_equal(port.embed_context(None, 3).numpy(), np.asarray(ref.embed_context(tree, None, 3)))
    sd3, ref3, tree3 = _pair("sd3")
    ctx = torch.ones((1, 77, SMALL["context_dim"]))
    assert sd3.embed_context(ctx, 1) is ctx
    for fn in (lambda: sd3.embed_context(None, 1), lambda: ref3.embed_context(tree3, None, 1)):
        with pytest.raises(ValueError, match="no learned null"):
            fn()
    with pytest.raises(ValueError, match="pooled="):
        port(torch.zeros(LATENT), 1.0, ctx, pooled=torch.zeros((1, POOLED)))
    with pytest.raises(ValueError, match="pooled="):
        sd3(torch.zeros(LATENT), 1.0, ctx)


@pytest.mark.parametrize("case", ["native", "sd3 qk-norm pos-embed"])
def test_cfg_batched_equals_two_pass(case: str) -> None:
    """``as_sampleable`` with guidance runs both branches in one doubled forward: the two single
    forwards, mixed, give the same result (a scalar timestep broadcast to the batch)."""
    port, _, _ = _pair(case)
    x, _, ctx, pooled = _inputs(case, seed=3)
    x, ctx, pooled = _t(x), _t(ctx[:1]), _t(None if pooled is None else pooled[:1])
    uncond = (torch.zeros_like(ctx), torch.zeros_like(pooled)) if pooled is not None else (None, None)
    guided = port.as_sampleable(ctx, 3.0, pooled=pooled, uncond_context=uncond[0], uncond_pooled=uncond[1])
    got = guided(x, torch.tensor(500.0), None, None)
    B = x.shape[0]
    expand = (lambda a, r: None if a is None else a.expand(B, *a.shape[1:]))
    cond = port(x, 500.0, expand(ctx, 2), expand(pooled, 1))
    unc = port(x, 500.0, expand(uncond[0], 2), expand(uncond[1], 1))
    torch.testing.assert_close(got, guided_mix(cond, unc, 3.0), rtol=1e-5, atol=1e-5 * cond.abs().max().item())
    if pooled is not None:
        with pytest.raises(ValueError, match="uncond_context"):
            port.as_sampleable(ctx, 3.0, pooled=pooled)


def test_per_request_scale_serves_each_item_its_own_guidance() -> None:
    "``as_served(per_request_scale=True)``: each item mixes with its own scale; equal scales == the fixed scale."
    port, _, _ = _pair("native")
    x, t, ctx, _ = _inputs("native", seed=4)
    x, t, ctx = _t(x), _t(t), _t(ctx)
    served = port.as_served(per_request_scale=True)
    got = served(x, t, None, None, (ctx, torch.tensor([1.5, 6.0])))
    cond, unc = port(x, t, ctx), port(x, t, None)
    for i, s in enumerate((1.5, 6.0)):
        want = unc[i] + s * (cond[i] - unc[i])
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    same = served(x, t, None, None, (ctx, torch.tensor([4.0, 4.0])))
    torch.testing.assert_close(same, port.as_served(4.0)(x, t, None, None, ctx), rtol=0, atol=0)
    with pytest.raises(ValueError, match="per_request_scale"):
        served(x, t, None, None, None)


@pytest.mark.parametrize("case", ["native", "sd3 qk-norm pos-embed"])
def test_int8_tree_close_to_f32(case: str) -> None:
    "``quantize_params``: the JAX recipe's layers become int8 (the conditioning pathway stays); cosine > 0.99."
    port, _, _ = _pair(case)
    int8 = port.quantize_params()
    assert isinstance(int8.blocks[0].img.qkv, Int8Dense) and isinstance(int8.blocks[1].txt.mlp_out, Int8Dense)
    assert not isinstance(int8.blocks[0].img.ada, Int8Dense) and not isinstance(int8.ctx_in, Int8Dense)
    assert int8.t_mlp1.weight is port.t_mlp1.weight  # shared, not copied
    x, t, ctx, pooled = _inputs(case, seed=5)
    ref = port(_t(x), _t(t), _t(ctx), _t(pooled)).numpy().ravel()
    got = int8(_t(x), _t(t), _t(ctx), _t(pooled)).numpy().ravel()
    cos = float(np.dot(ref, got) / (np.linalg.norm(ref) * np.linalg.norm(got) + 1e-12))
    assert cos > 0.99, cos


@pytest.mark.parametrize("case", list(CASES))
def test_flops_match_jax(case: str) -> None:
    kw = {**SMALL, **CASES[case]}
    for batch, h, w in ((1, 16, 16), (2, 128, 96)):
        assert mmdit_forward_flops(MMDiTConfig(**kw), batch, h, w) == jmmdit.mmdit_forward_flops(
            jmmdit.MMDiTConfig(**kw), batch, h, w
        )


def test_param_tree_round_trips_and_checks() -> None:
    "load_jax_params/param_tree are inverses; a missing key, a wrong shape and an int8 tree are refused."
    port, _, _ = _pair("sd3 qk-norm pos-embed", seed=6)
    tree = random_param_tree(port.config, 6)
    back = port.param_tree()
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(node, leaf)
    broken = port.param_tree()
    del broken["blocks"][0]["img"]["q_norm2"]
    with pytest.raises(ValueError, match="missing"):
        port.load_jax_params(broken)
    broken = port.param_tree()
    broken["ctx_in"]["w"] = broken["ctx_in"]["w"][:-1]
    with pytest.raises(ValueError, match="shape"):
        port.load_jax_params(broken)
    broken = port.param_tree()
    broken["blocks"][0]["img"]["qkv"] = {"w_q": {"q": 0, "s": 0}, "b": 0}
    with pytest.raises(NotImplementedError, match="int8"):
        port.load_jax_params(broken)


def test_contracts() -> None:
    """"flash" takes head dims 64 and 128 and names "full" otherwise; sequence parallelism without a mesh
    and the pipelined apply over blocks of two structures raise, as in the JAX package; the tensor-parallel specs are the JAX package's; a fresh model is adaLN-zero (outputs 0) and builds
    in bf16."""
    with pytest.raises(NotImplementedError, match="attention='full'"):
        MMDiT(MMDiTConfig(dim=96, heads=3, depth=1), device="cpu")
    MMDiT(MMDiTConfig(dim=96, heads=3, depth=1, attention="full"), device="cpu")
    for kind in ("ring", "ulysses"):  # without a mesh, the JAX package's ValueError (with one: test_torch_parallel.py)
        with pytest.raises(ValueError, match=r"needs MMDiT\(config, mesh=\.\.\.\)"):
            MMDiT(MMDiTConfig(dim=128, heads=2, depth=1, attention=kind), device="cpu")
        with pytest.raises(ValueError, match=r"needs MMDiT\(config, mesh=\.\.\.\)"):
            jmmdit.MMDiT(jmmdit.MMDiTConfig(dim=128, heads=2, depth=1, attention=kind))
    with pytest.raises(ValueError, match="multiple of 128"):
        MMDiT(MMDiTConfig(dim=128, heads=2, depth=1, context_tokens=77), device="cpu")
    fresh = MMDiT(MMDiTConfig(**SMALL, compute_dtype=torch.float32), device="cpu")
    assert fresh.param_spec()["blocks"][0]["img"]["qkv"]["w"] == (None, "tp")  # every spec: test_torch_tensor_parallel.py
    x, t, ctx, _ = _inputs("native")
    assert not fresh(_t(x), _t(t), _t(ctx)).any()
    # SMALL's dual attention and txt-pre-only last block cannot stack as stages: the JAX package's refusal,
    # before any mesh is read (the pipelined apply itself: test_torch_parallel.py)
    with pytest.raises(ValueError, match="uniform blocks"):
        fresh.apply_pipelined(_t(x), _t(t), None, microbatch=1)
    with pytest.raises(ValueError, match="uniform blocks"):
        jmmdit.MMDiT(jmmdit.MMDiTConfig(**SMALL)).apply_pipelined({}, x, t, None, microbatch=1)
    bf16 = MMDiT(MMDiTConfig(**SMALL, **CASES["sd3 qk-norm pos-embed"]), device="cpu", dtype=torch.bfloat16)
    assert bf16.blocks[0].img.qkv.weight.dtype == torch.bfloat16 and bf16.blocks[0].img.q_norm.dtype == torch.float32
    assert bf16.pos_embed.dtype == torch.float32


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_grads_of_no_remat(remat: bool | str) -> None:
    "Per-block recompute in the backward: the same loss gradients as storing every activation."
    grads = []
    for r in (False, remat):
        port, _, _ = _pair("sd3 qk-norm pos-embed", seed=7, remat=r)
        port.requires_grad_(True)
        x, t, ctx, pooled = _inputs("sd3 qk-norm pos-embed", seed=7)
        port(_t(x), _t(t), _t(ctx), _t(pooled)).square().mean().backward()
        grads.append([p.grad.clone() for p in port.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
