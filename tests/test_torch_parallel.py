"""The port's sequence-parallel slice against the JAX package, on the CPU.

B11's plain version and ``softmax_merge`` against the JAX functions in one
process; then every case of ``skrample_tpu_torch.parallel.dryrun`` on a
spawned gloo world of 2 ranks and one of 4 (each rank a process of its own,
``torch.set_num_threads(1)``, a ``FileStore`` under the test's temporary
directory, a 60 s group timeout so a hang fails fast), each case held
against the JAX package on the conftest's 8-device virtual mesh.  Inputs
and weights come from numpy seeds.

Only torch and the port are imported at module level: JAX is imported in
the test bodies.  The ranks are started with ``spawn``, never ``fork``
(this process holds XLA's threads).
"""

from __future__ import annotations

import functools
import importlib
import math
import os
import shutil
import tempfile
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from skrample_tpu_torch import prng
from skrample_tpu_torch.models import mmdit as tmmdit
from skrample_tpu_torch.models import text_encoder as ttext
from skrample_tpu_torch.models import video_dit as tvdit
from skrample_tpu_torch.models.dit import DiTConfig, random_param_tree
from skrample_tpu_torch.ops import flash_attention as tfa
from skrample_tpu_torch.parallel import batch_keys
from skrample_tpu_torch.parallel.dryrun import spawn_cli, spawn_sp

WORLDS = (2, 4)
DIT = {"dim": 64, "depth": 2, "heads": 4}  # head dim 16; 16x16 latents at patch 2: 64 tokens
B, H, D = 2, 4, 16  # the raw attention cases: 16 tokens a rank
# the data-parallel cases: a one-block DiT on 8x8 latents, 4 stochastic DPM++2M steps, 5 requests
SERVE_DIT = {"dim": 32, "depth": 1, "heads": 2}
SERVE = {"item": (4, 8, 8), "steps": 4, "seeds": (3, 14, 15, 92, 65)}
MMDIT = {
    "dim": 64, "depth": 2, "heads": 4, "channels": 4, "context_dim": 32, "context_tokens": 128,
    "qk_norm": True, "dual_attention_layers": (0,),
}  # the native wiring; 8x8 latents: 16 image tokens beside 128 text tokens
VIDEO = {"dim": 64, "depth": 1, "heads": 4, "channels": 4, "attention": "full"}  # 4 frames of 16 sites
T2I_ENC = {"dim": 32, "depth": 1, "heads": 2, "max_tokens": 128}
T2I_MMDIT = {"dim": 32, "depth": 1, "heads": 2, "context_dim": 32, "context_tokens": 128, "attention": "full"}
# the tensor-parallel cases: every head count divides 2 and 4; each model's own small test sizes otherwise
TP_FLUX = {"dim": 256, "heads": 4, "rope_axes": (16, 24, 24), "depth": 1, "single_depth": 1, "context_dim": 32,
           "pooled_dim": 24, "guidance": False, "attention": "full"}
TP_CLIP = {"vocab_size": 300, "dim": 64, "depth": 2, "heads": 4, "max_tokens": 16, "ln_affine": True,
           "act": "quick_gelu", "eos_id": 299, "ln_eps": 1e-5}
TP_T5 = {"vocab_size": 120, "dim": 64, "head_dim": 16, "heads": 4, "ff_dim": 96, "depth": 2, "rel_buckets": 8,
         "rel_max_distance": 20}
TP_UNET = {"widths": (64, 128), "heads": (1, 4), "transformer_layers": (0, 1), "layers_per_block": 1,
           "context_dim": 48, "pooled_dim": 0}
TP_VIDEO = {**VIDEO, "context_dim": 24}  # the cross attention's q_x, kv_c and proj_x too
TP_MMDIT_SAMPLE = {"dim": 128, "depth": 2, "heads": 2, "context_dim": 96, "context_tokens": 128}
FSDP_DIT = {"patch": 2, "channels": 4, "dim": 128, "depth": 2, "heads": 8}  # tests/test_fsdp.py's model
FSDP_STEPS = {"adamw": 3, "adamw8bit": 2}  # as tests/test_fsdp.py runs them, batch 8 of 4x8x8, lr 1e-3
TRAIN_CLI_TP = [  # the DiT trainer's CLI over tp 2: two heads, every option --tp composes with
    "--device", "cpu", "--steps", "1", "--batch", "4", "--dim", "64", "--depth", "1", "--heads", "2", "--size", "8",
    "--opt8", "--lora", "2", "--remat",
]
TINY_TRAIN = ["--device", "cpu", "--batch", "4", "--dim", "64", "--depth", "1", "--heads", "1", "--size", "8", "--host-loader"]
RESUME = [*TINY_TRAIN, "--dp", "2", "--fsdp", "--opt8"]  # the DiT trainer's FSDP kill-and-resume, 8-bit moments
# C17: a dp 1 train state (2 steps) of each optimizer that each world resumes at dp = the world with --fsdp
LAYOUT_ARGV = {"adamw": TINY_TRAIN, "opt8": [*TINY_TRAIN, "--opt8"]}
LAYOUT_DIRS = {opt: os.path.join(tempfile.gettempdir(), f"layout-{uuid.uuid4().hex}-{opt}") for opt in LAYOUT_ARGV}
TRAIN_CLI = [  # the DiT trainer's CLI, 1 step of batch 4 with every option --dp composes with
    "--device", "cpu", "--steps", "1", "--batch", "4", "--dim", "64", "--depth", "1", "--heads", "1", "--size", "8",
    "--opt8", "--lora", "2", "--remat",
]


def _jfa():
    "The JAX flash-attention module (``skrample_tpu.ops`` re-exports a function of that name)."
    return importlib.import_module("skrample_tpu.ops.flash_attention")


# ---- the float64 oracle's summation bounds of dense gradients ----------------------


# float32 roundings a summand may carry in a gradient's per-element bound (dense_grad_sums): the
# float64 oracle puts the port within 98 eps32 * S of itself and JAX within 772 (XLA's CPU
# approximations of exp and tanh carry through the backward into sums that cancel)
K_GRAD = 1024


def dense_grad_sums(run) -> dict[int, tuple[torch.Tensor, torch.Tensor]]:
    """Call ``run()`` (a forward and backward through the port's dense layers, in float64: the
    oracle) and return, by the ``data_ptr`` of each dense weight, the sums of the magnitudes of the
    products that its gradients add up: ``(|g|ᵀ |x|, Σ_rows |g|)`` in ``nn.Linear``'s ``(out, in)``
    layout and the bias's, from the ``x`` and the output gradient ``g`` the layer's backward sees.
    ``K_GRAD * eps32`` times these is the float32 summation bound of each element of the weight and
    bias gradients, cancellation included, that a per-element comparison uses in place of a fixed
    atol."""
    from unittest import mock

    from skrample_tpu_torch.models import dit as tdit

    sums: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    backward = tdit._Dense.backward

    def recording(ctx, g):
        x2, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).abs()
        terms = (g2.t() @ x2.abs(), g2.sum(0))
        old = sums.get(w.data_ptr())
        sums[w.data_ptr()] = terms if old is None else (old[0] + terms[0], old[1] + terms[1])
        return backward(ctx, g)

    with mock.patch.object(tdit._Dense, "backward", staticmethod(recording)):
        run()
    return sums


def grad_sums_by_path(module: torch.nn.Module, sums: dict) -> dict[str, np.ndarray]:
    """``dense_grad_sums``' sums of ``module``'s dense layers by tree path, in the JAX layout
    (``.w`` as ``(in, out)``, ``.b``), as float64 numpy."""
    out = {}
    for name, layer in module.named_modules():
        if isinstance(layer, torch.nn.Linear) and layer.weight.data_ptr() in sums:
            w_sum, b_sum = sums[layer.weight.data_ptr()]
            out[f"{name}.w"] = w_sum.double().numpy().T
            out[f"{name}.b"] = b_sum.double().numpy()
    return out


def assert_within(actual: np.ndarray, desired: np.ndarray, rtol: float, bound: np.ndarray, what: str) -> None:
    "``|actual - desired| <= rtol |desired| + bound`` element for element (``bound`` an array)."
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, what
    excess = np.abs(actual - desired) - rtol * np.abs(desired) - bound
    bad = int((excess > 0).sum())
    assert bad == 0, f"{what}: {bad} of {excess.size} elements outside the bound (worst by {excess.max():.3e})"


# ---- B11's plain version and the merge, one process ---------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_stats_plain_matches_pallas_interpret(dtype: str) -> None:
    """The plain B11 against the JAX ``flash_attention_block_stats`` in interpret mode at a tiled
    shape (1, 2, 256, 64), ``block_q=128``: f32 rtol/atol 1e-5 on o, m and l; bf16 o within 1e-2
    (the same roundings, sums in another order), m and l 1e-5."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 2, 256, 64), dtype=np.float32) for _ in range(3))
    jdt = getattr(jnp, dtype)
    want = _jfa().flash_attention_block_stats(*(jnp.asarray(a, jdt) for a in (q, k, v)), block_q=128, interpret=True)
    got = tfa.flash_attention_block_stats(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == got[2].dtype == torch.float32
    assert got[1].shape == got[2].shape == (1, 2, 256) and got[1].is_contiguous() and got[2].is_contiguous()
    o_tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)), rtol=o_tol, atol=o_tol)
    for mine, theirs in zip(got[1:], want[1:]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def test_block_stats_plain_matches_einsum_branch_ragged() -> None:
    "Ragged ``Nq != Nk`` (2, 3, 40 queries vs 24 keys, d 16): the JAX einsum branch, f32 rtol/atol 1e-5."
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 3, 40, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 3, 24, 16), dtype=np.float32) for _ in range(2))
    want = _jfa().flash_attention_block_stats(*(jnp.asarray(a) for a in (q, k, v)))
    got = tfa.flash_attention_block_stats(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got[0].shape == (2, 3, 40, 16) and got[1].shape == (2, 3, 40)
    for mine, theirs in zip(got, want):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def test_softmax_merge_matches_jax() -> None:
    """One fold of a block into a running state, f32: rtol 1e-6 (the same elementwise float32
    ops), and atol of one float32 ulp at 1 (2**-23): XLA's ``exp`` and PyTorch's differ in the
    last bit here and there."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    acc = rng.standard_normal((2, 3, 8, 16), dtype=np.float32)
    peak, total = rng.standard_normal((2, 3, 8), dtype=np.float32), rng.uniform(1, 5, (2, 3, 8)).astype(np.float32)
    block = (
        rng.standard_normal((2, 3, 8, 16), dtype=np.float32),
        rng.standard_normal((2, 3, 8), dtype=np.float32),
        rng.uniform(1, 5, (2, 3, 8)).astype(np.float32),
    )
    want = _jfa().softmax_merge(tuple(map(jnp.asarray, (acc, peak, total))), tuple(map(jnp.asarray, block)))
    got = tfa.softmax_merge(tuple(map(torch.from_numpy, (acc, peak, total))), tuple(map(torch.from_numpy, block)))
    for mine, theirs in zip(got, want):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6, atol=2**-23)


def test_block_fold_equals_full_attention() -> None:
    """128 queries against three 128-key blocks of a 384-key sequence, folded with
    ``softmax_merge``: full softmax attention (float64 numpy) within 5e-5, as the JAX package's
    own test of its merge."""
    rng = np.random.default_rng(14)
    q = rng.standard_normal((1, 2, 128, 64), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, 384, 64), dtype=np.float32) for _ in range(2))
    acc = torch.zeros(q.shape)
    peak, total = torch.full(q.shape[:-1], -math.inf), torch.zeros(q.shape[:-1])
    for blk in range(3):
        keys = slice(128 * blk, 128 * (blk + 1))
        block = tfa.flash_attention_block_stats(*(torch.from_numpy(a) for a in (q, k[:, :, keys], v[:, :, keys])))
        acc, peak, total = tfa.softmax_merge((acc, peak, total), block)
    merged = (acc / total[..., None]).numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / math.sqrt(64)
    p = np.exp(s - s.max(-1, keepdims=True))
    full = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(merged, full, rtol=5e-5, atol=5e-5)


def test_batch_keys_bit_exact() -> None:
    "``batch_keys`` against the JAX package's ``jax.vmap(fold_in)``: equal words, bit for bit."
    import jax

    from skrample_tpu.parallel import batch_keys as jbatch_keys

    for seed in (0, 7, 2**31 - 1):
        want = np.asarray(jbatch_keys(jax.random.PRNGKey(seed), 5)).astype(np.int64)
        assert np.array_equal(batch_keys(prng.PRNGKey(seed), 5).numpy(), want)


# ---- the dry run's cases on 2 and 4 gloo ranks ----------------------------------------


@functools.cache
def _cases(world: int) -> dict[str, dict]:
    "Every case of the dry run at ``world`` ranks, by name, inputs from numpy seeds."
    rng = np.random.default_rng(100 + world)
    n = 16 * world
    q, k, v = (rng.standard_normal((B, H, n, D), dtype=np.float32) for _ in range(3))
    qkv_a = rng.standard_normal((B, 12 * world, 3 * 64), dtype=np.float32)  # two streams of different lengths
    qkv_b = rng.standard_normal((B, 4 * world, 3 * 64), dtype=np.float32)
    tree = random_param_tree(DiTConfig(**DIT), seed=world)
    x = rng.standard_normal((2, 4, 16, 16), dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    cases: dict[str, dict] = {}
    for op in ("flash", "einsum"):
        cases[f"ring-{op}"] = {"kind": "ring", "q": q, "k": k, "v": v, "block_op": op}
        cases[f"ulysses-{op}"] = {"kind": "ulysses", "q": q, "k": k, "v": v, "heads_op": op}
    for scheme in ("ring", "ulysses"):
        cases[f"joint_sp-{scheme}"] = {"kind": "joint_sp", "qkv_a": qkv_a, "qkv_b": qkv_b, "heads": 4, "scheme": scheme}
    for attention in ("ring", "ulysses"):
        config = {**DIT, "compute_dtype": "float32", "attention": attention}
        cases[f"dit-{attention}"] = {"kind": "dit", "config": config, "tree": tree, "x": x, "t": t}
        cases[f"sample-{attention}"] = {"kind": "sample", "config": config, "tree": tree, "x0": x, "steps": 8}
    for what in ("heads", "tokens", "no_mesh", "dp", "flash_mesh"):
        cases[f"raises-{what}"] = {"kind": "raises", "what": what}
    cases.update(_parallel_cases(world))
    cases.update(_tp_cases(world))
    cases.update(_fsdp_cases(world))
    cases.update(_pipeline_cases(world))
    cases.update(_grad_cases(world))
    if world == 4:  # a dp x sp mesh needs 4 ranks
        cases.update(_tp_dp_cases())
        for attention in ("ring", "ulysses"):  # tp 2 x sp 2: two heads a rank, its tokens' half
            tp_case = _tp_cases(4)["tp-dit"]
            config = {**tp_case["config"], "attention": attention}
            cases[f"tp_sp-{attention}"] = {**tp_case, "config": config, "mesh": [1, 2, 2]}
        for attention in ("ring", "ulysses"):
            config = {**DIT, "compute_dtype": "float32", "attention": attention}
            case = {"kind": "dit", "config": config, "tree": tree, "x": x, "t": t, "mesh": [2, 2]}
            cases[f"dit_dp-{attention}"] = case
    return cases


def _parallel_cases(world: int) -> dict[str, dict]:
    """The data-parallel engines, pipeline and training steps, the sequence-parallel MMDiT and
    VideoDiT, and their refusals.  Inputs do not depend on ``world`` (every batch divides by 2 and
    4), so a reference made without a mesh serves both worlds."""
    rng = np.random.default_rng(300)
    serve_tree = random_param_tree(DiTConfig(**SERVE_DIT), seed=30)
    serve_config = {**SERVE_DIT, "compute_dtype": "float32"}
    cases: dict[str, dict] = {
        "serve-batch": {"kind": "serve", "engine": "batch", "buckets": (world, 2 * world)},
        "serve-continuous": {"kind": "serve", "engine": "continuous", "slots": world},
    }
    for case in cases.values():
        case.update(SERVE, config=serve_config, tree=serve_tree)
    for engine in ("batch", "continuous"):  # the last rank's model raises at its first call
        cases[f"serve_fault-{engine}"] = {**cases[f"serve-{engine}"], "fault": world - 1, "seeds": SERVE["seeds"][:2]}
    for engine in ("batch", "continuous"):  # a DiT cut over tp 2 under the dp engine (dp = world / 2)
        tp_case = {**cases[f"serve-{engine}"], "tp": 2}
        tp_case.update(buckets=(world // 2, world)) if engine == "batch" else tp_case.update(slots=world // 2)
        cases[f"serve_tp-{engine}"] = tp_case
    cases["pipeline"] = {
        "kind": "pipeline", "config": serve_config, "tree": serve_tree, "shape": (4, 4, 8, 8), "steps": 4, "seed": 7
    }
    mm_tree = tmmdit.random_param_tree(tmmdit.MMDiTConfig(**MMDIT), seed=31)
    x = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    context = rng.standard_normal((2, 40, MMDIT["context_dim"]), dtype=np.float32)
    for attention in ("ring", "ulysses"):
        config = {**MMDIT, "compute_dtype": "float32", "attention": attention}
        case = {"kind": "mmdit", "config": config, "tree": mm_tree, "x": x, "t": t, "context": context}
        cases[f"mmdit-{attention}"] = case
    video_tree = tvdit.random_param_tree(tvdit.VideoDiTConfig(**VIDEO), seed=32)
    video_x = rng.standard_normal((1, 4, 4, 8, 8), dtype=np.float32)
    cases["video"] = {
        "kind": "video", "config": {**VIDEO, "compute_dtype": "float32"}, "tree": video_tree, "x": video_x,
        "t": np.array([500.0], dtype=np.float32),
    }
    dit_tree = random_param_tree(DiTConfig(**DIT), seed=33)
    cases["train_dit"] = {
        "kind": "train_dit", "config": {**DIT, "compute_dtype": "float32"}, "tree": dit_tree,
        "x0": rng.standard_normal((4, 4, 8, 8), dtype=np.float32),
        "noise": rng.standard_normal((4, 4, 8, 8), dtype=np.float32),
        "sigma": rng.uniform(1e-3, 1.0, 4).astype(np.float32),
    }
    from skrample_tpu_torch.train_text_to_image import t2i_draws

    draws = [d.numpy() for d in t2i_draws(prng.PRNGKey(9), 4, 8, 0.5, device="cpu")]
    cases["train_t2i"] = {
        "kind": "train_t2i", "enc": {**T2I_ENC, "compute_dtype": "float32"},
        "mmdit": {**T2I_MMDIT, "compute_dtype": "float32"}, "size": 8, "draws": draws,
        "trees": {
            "enc": ttext.random_param_tree(ttext.TextEncoderConfig(**T2I_ENC), 34),
            "mmdit": tmmdit.random_param_tree(tmmdit.MMDiTConfig(**T2I_MMDIT), 35),
        },
    }
    for kind in ("train_dit", "train_t2i"):  # the same steps with the models cut over tp 2
        cases[f"{kind}_tp"] = {**cases[kind], "tp": 2}
    path = os.path.join(tempfile.gettempdir(), f"dp-cli-{uuid.uuid4().hex}-{world}.npz")
    cases["train_cli"] = {"kind": "train_cli", "argv": [*TRAIN_CLI, "--checkpoint", path]}
    tp_path = os.path.join(tempfile.gettempdir(), f"tp-cli-{uuid.uuid4().hex}-{world}.npz")
    cases["train_cli_tp"] = {"kind": "train_cli", "argv": [*TRAIN_CLI_TP, "--checkpoint", tp_path], "tp": 2}
    for what in ("slots", "stream_tokens", "tp", "dp_graph", "dp_orbax"):
        cases[f"raises-{what}"] = {"kind": "raises", "what": what}
    for opt, directory in LAYOUT_DIRS.items():
        cases[f"resume_layout-{opt}"] = {"kind": "resume_layout", "argv": LAYOUT_ARGV[opt], "dir": directory}
    return cases


def _tp_cases(world: int) -> dict[str, dict]:
    """One forward of each model with its layers cut over ``tp`` = the world (``(1, 1, world)``), inputs
    and weights from numpy seeds that do not depend on ``world``; the int8 DiT, MMDiT and Flux against
    their own forwards without a mesh (``meshless``), and the int8 Flux once more with its weights drawn
    by its own initialisation on every rank (each layer drawn whole, each rank's part kept)."""
    from skrample_tpu_torch.models import flux as tflux
    from skrample_tpu_torch.models import t5_encoder as tt5
    from skrample_tpu_torch.models import unet_cond as tuc

    rng = np.random.default_rng(400)
    t2 = np.array([730.0, 41.5], dtype=np.float32)
    x = rng.standard_normal((2, 4, 16, 16), dtype=np.float32)
    mm_ctx = rng.standard_normal((2, 40, MMDIT["context_dim"]), dtype=np.float32)
    flux_x = rng.standard_normal((2, 16, 8, 8), dtype=np.float32)
    flux_ctx = rng.standard_normal((2, 12, TP_FLUX["context_dim"]), dtype=np.float32)
    pooled = rng.standard_normal((2, TP_FLUX["pooled_dim"]), dtype=np.float32)
    ids = rng.integers(0, TP_CLIP["vocab_size"] - 1, (2, 16)).astype(np.int64)
    ids[0, 9] = ids[1, 15] = TP_CLIP["eos_id"]
    unet_ctx = rng.standard_normal((2, 10, TP_UNET["context_dim"]), dtype=np.float32)
    video_ctx = rng.standard_normal((1, 6, TP_VIDEO["context_dim"]), dtype=np.float32)
    mesh = [1, 1, world]
    f32 = {"compute_dtype": "float32"}
    specs = {
        "dit": ({**DIT, **f32, "attention": "full"}, random_param_tree(DiTConfig(**DIT), 41), {"x": x, "t": t2}),
        "mmdit": ({**MMDIT, **f32, "attention": "full"}, tmmdit.random_param_tree(tmmdit.MMDiTConfig(**MMDIT), 42),
                  {"x": x[:, :, :8, :8], "t": t2, "context": mm_ctx}),
        "flux": ({**TP_FLUX, **f32}, tflux.random_param_tree(tflux.FluxConfig(**TP_FLUX), 43),
                 {"x": flux_x, "t": np.array([0.7, 0.2], np.float32), "context": flux_ctx, "pooled": pooled}),
        "video": ({**TP_VIDEO, **f32}, tvdit.random_param_tree(tvdit.VideoDiTConfig(**TP_VIDEO), 44),
                  {"x": rng.standard_normal((1, 4, 4, 8, 8), dtype=np.float32), "t": np.array([500.0], np.float32),
                   "context": video_ctx}),
        "clip": ({**TP_CLIP, **f32}, ttext.random_param_tree(ttext.TextEncoderConfig(**TP_CLIP), 45), {"ids": ids}),
        "t5": ({**TP_T5, **f32}, tt5.random_param_tree(tt5.T5EncoderConfig(**TP_T5), 46), {"ids": ids % 120}),
        "unet": ({**TP_UNET, **f32}, tuc.random_param_tree(tuc.CondUNetConfig(**TP_UNET), 47),
                 {"x": x, "t": t2, "context": unet_ctx}),
    }
    cases = {}
    for model, (config, tree, inputs) in specs.items():
        case = {"kind": "tp", "model": model, "config": config, "tree": tree, "inputs": tuple(inputs), "mesh": mesh,
                **inputs}
        cases[f"tp-{model}"] = case
        if model in ("dit", "mmdit", "flux"):  # wide enough for the int8 layers (16384 weights)
            wide = {"dit": {"dim": 128}, "mmdit": {"dim": 128}, "flux": {}}[model]
            cfg = {**config, **wide}
            tree = {"dit": lambda: random_param_tree(DiTConfig(**{**DIT, **wide}), 48),
                    "mmdit": lambda: tmmdit.random_param_tree(tmmdit.MMDiTConfig(**{**MMDIT, **wide}), 49),
                    "flux": lambda: tree}[model]()
            cases[f"tp-{model}_int8"] = {**case, "config": cfg, "tree": tree, "quantized": True, "meshless": True}
    drawn = {k: v for k, v in cases["tp-flux_int8"].items() if k != "tree"}
    cases["tp-flux_int8_drawn"] = {**drawn, "seed": 50, "noise": 0.02}  # reset_parameters' cut, not load_jax_params'
    return cases


def _fsdp_cases(world: int) -> dict[str, dict]:
    """FSDP training of tests/test_fsdp.py's DiT from the JAX package's ``init(PRNGKey(0))`` tree on ``dp`` 2
    (x ``tp`` 2 on the 4-rank world), with AdamW and ``AdamW8bit``, on numpy draws."""
    rng = np.random.default_rng(402)
    draws = [
        (rng.standard_normal((8, 4, 8, 8), dtype=np.float32), rng.standard_normal((8, 4, 8, 8), dtype=np.float32),
         rng.uniform(1e-3, 1.0, 8).astype(np.float32))
        for _ in range(max(FSDP_STEPS.values()))
    ]
    cases = {}
    for opt, steps in FSDP_STEPS.items():
        case = {
            "kind": "train_fsdp", "config": {**FSDP_DIT, "compute_dtype": "float32", "attention": "full"},
            "tree": _jax_init_tree(), "draws": draws[:steps], "optimizer": opt, "lr": 1e-3,
            "mesh": [2, 1, world // 2], "fsdp": True,
        }
        cases[f"fsdp-{opt}"] = case
        cases[f"fsdp_replicated-{opt}"] = {**case, "fsdp": False}  # the same mesh, nothing sharded over dp
    return cases


@functools.cache
def _jax_init_tree() -> dict:
    "The JAX package's ``DiT.init(PRNGKey(0))`` of tests/test_fsdp.py's model, as numpy."
    import jax
    import jax.numpy as jnp

    from skrample_tpu.models import dit as jdit

    model = jdit.DiT(jdit.DiTConfig(**FSDP_DIT, compute_dtype=jnp.float32))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _tp_dp_cases() -> dict[str, dict]:
    """The 4-rank world's ``(2, 1, 2)`` meshes: the ring and ulysses MMDiT's 3-step CFG sample (the JAX
    package's ``TestComposedAxes::test_mmdit_dp_tp_sp_matches_single`` on a 4-rank world: dp 2 x tp 2)."""
    rng = np.random.default_rng(401)
    tree = tmmdit.random_param_tree(tmmdit.MMDiTConfig(**TP_MMDIT_SAMPLE), 50)
    x0 = rng.standard_normal((4, 4, 16, 16), dtype=np.float32)
    context = rng.standard_normal((4, 77, TP_MMDIT_SAMPLE["context_dim"]), dtype=np.float32)
    return {
        f"tp_dp-{scheme}": {
            "kind": "tp_sample", "config": {**TP_MMDIT_SAMPLE, "compute_dtype": "float32", "attention": scheme},
            "tree": tree, "x0": x0, "context": context, "steps": 3, "guidance": 2.0, "mesh": [2, 1, 2],
        }
        for scheme in ("ring", "ulysses")
    }


PIPE_DIM = 16
PIPE_COUNTS = {2: (1, 5), 4: (6, 1)}  # tests/test_parallel.py:128's (stages, count) pairs at stages = the world
GRAD_DIT = {"dim": 64, "depth": 4, "heads": 4}  # tests/test_parallel.py:159's DiT; 16x16 latents: 64 tokens
GRAD_MMDIT = {**MMDIT, "depth": 1}  # one dual block: the joint attention and the image stream's own, over sp
PP_MMDIT = {"dim": 64, "depth": 4, "heads": 4, "context_dim": 32, "context_tokens": 128, "attention": "full"}
MOE_EXPERTS = 4  # tests/test_parallel.py:439's capacity cases: 4 experts of dim 16, hidden 32, 2 x 24 tokens, capacity 8


def _pipeline_cases(world: int) -> dict[str, dict]:
    """The pipeline over ``pp`` = the world: the dense-tanh stages of tests/test_parallel.py:128 at two
    microbatch counts, the pytree carry (:215), the gradients through the stage hops (:696); on the
    4-rank world the pp 2 x dp 2 training step (:733) and the pipelined DiT at pp 2 x dp 2 (:772).  The
    pipelined DiT (:159) and MMDiT (:180) at pp = the world.  Stage inputs depend on the world."""
    rng = np.random.default_rng(500 + world)
    S, dim = world, PIPE_DIM

    def normal(*shape: int, scale: float = 1.0) -> np.ndarray:
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)

    cases: dict[str, dict] = {}  # each pipe case's JAX reference is its own ("ref")
    for tag, count in zip("ab", PIPE_COUNTS[world]):
        cases[f"pipe-forward_{tag}"] = {"kind": "pipe", "mode": "forward", "mesh": [1, S], "w": normal(S, dim, dim, scale=0.3),
                                        "b": normal(S, dim, scale=0.1), "mbs": normal(count, 2, dim)}
    cases["pipe-carry"] = {"kind": "pipe", "mode": "carry", "mesh": [1, S], "blocks": [normal(dim, dim, scale=0.3) for _ in range(S)],
                           "xs": normal(3, 2, dim), "conds": normal(3, 2, dim, scale=0.1)}
    cases["pipe-grad"] = {"kind": "pipe", "mode": "grad", "mesh": [1, S], "w": normal(S, dim, dim, scale=0.3),
                          "b": normal(S, dim, scale=0.1), "mbs": normal(4, 2, dim), "target": np.ones((4, 2, dim), np.float32)}
    if world == 4:
        cases["pipe-train"] = {"kind": "pipe", "mode": "train", "mesh": [2, 2], "w": normal(2, dim, dim, scale=0.3),
                               "b": normal(2, dim, scale=0.1), "mbs": normal(3, 4, dim), "target": normal(3, 4, dim)}
    for name, case in cases.items():
        case["ref"] = f"{name}-{world}"
    dit = _grad_inputs()["dit"]
    cases["pp_dit"] = {"kind": "pp_dit", **dit, "microbatch": 4 // world, "mesh": [1, S]}
    if world == 4:
        cases["pp_dit-dp"] = {"kind": "pp_dit", **dit, "microbatch": 2, "mesh": [2, 2]}
    mm_rng = np.random.default_rng(501)
    cases["pp_mmdit"] = {
        "kind": "pp_mmdit", "config": {**PP_MMDIT, "compute_dtype": "float32"},
        "tree": tmmdit.random_param_tree(tmmdit.MMDiTConfig(**PP_MMDIT), 52), "microbatch": 2, "mesh": [1, S],
        "x": mm_rng.standard_normal((4, 4, 8, 8), dtype=np.float32), "t": np.linspace(10.0, 900.0, 4, dtype=np.float32),
        "context": mm_rng.standard_normal((4, 128, 32), dtype=np.float32),
    }
    return cases


@functools.cache
def _grad_inputs() -> dict[str, dict]:
    "The gradient cases' inputs and weights, the same for both worlds (every token count divides 2 and 4)."
    rng = np.random.default_rng(600)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    attention = {"q": f32(2, 4, 64, 16), "k": f32(2, 4, 64, 16), "v": f32(2, 4, 64, 16), "w": f32(2, 4, 64, 16)}
    joint = {"qkv_a": f32(2, 48, 192), "qkv_b": f32(2, 16, 192), "w_a": f32(2, 48, 64), "w_b": f32(2, 16, 64), "heads": 4}
    reshard = {"x": f32(2, 8, 8), "w": f32(2, 8, 8)}
    # the sp DiT takes the trainer's step: x, t and target are its x_t, 1000 sigma and noise - x0 (float32)
    x0, sigma, noise = f32(4, 4, 16, 16), np.linspace(0.01, 0.9, 4, dtype=np.float32), f32(4, 4, 16, 16)
    s = sigma[:, None, None, None]
    return {
        "attention": attention, "joint": joint, "reshard": reshard,
        "dit": {"config": {**GRAD_DIT, "compute_dtype": "float32"}, "tree": random_param_tree(DiTConfig(**GRAD_DIT), 60),
                "x0": x0, "noise": noise, "sigma": sigma, "x": (1 - s) * x0 + s * noise, "t": sigma * np.float32(1000.0),
                "target": noise - x0},
        "mmdit": {"config": {**GRAD_MMDIT, "compute_dtype": "float32"},
                  "tree": tmmdit.random_param_tree(tmmdit.MMDiTConfig(**GRAD_MMDIT), 61),
                  "x": f32(2, 4, 8, 8), "t": np.array([730.0, 41.5], np.float32), "context": f32(2, 40, 32),
                  "target": f32(2, 4, 8, 8)},
        "moe": {"tokens": f32(2, 24, 16)},
    }


def _grad_cases(world: int) -> dict[str, dict]:
    """The gradients through the sequence-parallel collectives (the ring with either block op, ulysses with
    either head op, ``reshard``, the joint attention with either scheme, the ring and ulysses DiT and
    MMDiT, and the pipelined DiT at pp = the world), and the MoE FFN over ``ep`` = the world."""
    inputs = _grad_inputs()
    cases: dict[str, dict] = {}
    for op in ("flash", "einsum"):
        cases[f"grad-ring_{op}"] = {"kind": "grad", "op": "ring", "block_op": op, **inputs["attention"]}
        cases[f"grad-ulysses_{op}"] = {"kind": "grad", "op": "ulysses", "heads_op": op, **inputs["attention"]}
    for scheme in ("ring", "ulysses"):
        cases[f"grad-joint_{scheme}"] = {"kind": "grad", "op": "joint_sp", "scheme": scheme, **inputs["joint"]}
    cases["grad-reshard"] = {"kind": "grad", "op": "reshard", **inputs["reshard"]}
    for model in ("dit", "mmdit"):
        for attention in ("ring", "ulysses"):
            case = inputs[model]
            cases[f"grad_{model}-{attention}"] = {
                "kind": "grad_model", "model": model, **case, "config": {**case["config"], "attention": attention}
            }
    if world == 4:  # the trainer's step at dp 2 x sp 2: the gradients summed over sp, then averaged over dp
        cases["grad_dit-dp_ring"] = {**cases["grad_dit-ring"], "mesh": [2, 2]}
    cases["grad_dit-pp"] = {"kind": "grad_model", "model": "dit", **inputs["dit"], "pp": world, "microbatch": 4 // world}
    params = _jax_moe_params()
    for method, capacity in (("dense", None), ("gather", 8), ("onehot", 8)):
        cases[f"moe-{method}"] = {"kind": "moe", "method": method, "capacity": capacity, "params": params,
                                  **inputs["moe"]}
    return cases


@functools.cache
def _jax_moe_params() -> dict[str, np.ndarray]:
    "The JAX package's ``init_moe_ffn(PRNGKey(11), dim=16, hidden=32, experts=4)``, as numpy."
    import jax

    from skrample_tpu.parallel import init_moe_ffn as jinit

    return {k: np.asarray(v) for k, v in jinit(jax.random.PRNGKey(11), dim=16, hidden=32, experts=MOE_EXPERTS).items()}


CASE_NAMES = tuple(_cases(2))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory: pytest.TempPathFactory):
    """``spawned(world)``: every rank's result of every case, by case name.  Both worlds start at
    once, in two threads of this process (2 + 4 single-threaded ranks), and are each run once;
    two more threads make the JAX package's mesh-less references meanwhile (``_want``: the
    pipeline, gradient and expert kinds in one, the rest in the other: XLA compiles without the
    interpreter lock), and ``spawned`` returns once they are made too.  The C15 world starts when
    the 2-rank world has ended; the resume worlds run beside them."""

    def run(world: int, store_dir: str) -> dict[str, list]:
        cases = _cases(world)
        per_rank = spawn_sp(world, list(cases.values()), store_dir, backend="gloo", device="cpu")
        return {name: [per_rank[r][i] for r in range(world)] for i, name in enumerate(cases)}

    def references(slice_kinds: bool) -> None:
        "The mesh-less references of one half of the cases: the pipeline, gradient and expert kinds, or the rest."
        for world in reversed(WORLDS):
            for case in _cases(world).values():
                if _meshless_key(case) is not None and (case["kind"] in SLICE_TOLERANCES) == slice_kinds:
                    _want(case, world)

    def run_abort(store_dir: str) -> list:
        return spawn_sp(2, [_abort_case()], store_dir, backend="gloo", device="cpu", timeout_s=ABORT_TIMEOUT_S)

    def run_then_abort(world: int, store_dir: str) -> dict[str, list]:
        "The 2-rank world, then the C15 world: it starts once the 2 ranks have ended (less contention)."
        out = run(world, store_dir)
        futures["abort"] = pool.submit(run_abort, dirs["abort"])
        return out

    def run_resume(store_dir: str) -> dict:
        "The uninterrupted run and the killed one with its resume, 4 steps each, and what they left."
        uninterrupted = ["--steps", "4", "--orbax", f"{store_dir}/a", "--checkpoint", f"{store_dir}/a.npz"]
        killed = ["--steps", "4", "--orbax", f"{store_dir}/b", "--abort-after-step", "1"]
        resumed = ["--until", "4", "--orbax", f"{store_dir}/b", "--resume", "--checkpoint", f"{store_dir}/b.npz"]
        codes = {name: spawn_cli(2, [*RESUME, *argv], store_dir) for name, argv in
                 (("a", uninterrupted), ("killed", killed), ("resumed", resumed))}
        return {"codes": codes, "dir": store_dir}

    def run_resume_adamw(store_dir: str) -> list:
        "C17: a --dp 2 --fsdp AdamW train state, 2 steps (the 8-bit one is ``run_resume``'s ``a``)."
        return spawn_cli(2, [*TINY_TRAIN, "--dp", "2", "--fsdp", "--steps", "2", "--orbax", f"{store_dir}/c"], store_dir)

    # made here, before the threads: two threads' first mktemp race to create pytest's base temp dir
    dirs = {world: str(tmp_path_factory.mktemp(f"sp{world}")) for world in (*WORLDS, "abort", "resume")}
    from skrample_tpu_torch import training

    for opt, directory in LAYOUT_DIRS.items():  # C17's dp 1 states, which the worlds resume at dp = the world
        assert training.main([*LAYOUT_ARGV[opt], "--steps", "2", "--orbax", directory]) == 0
    with ThreadPoolExecutor(len(WORLDS) + 5) as pool:
        futures: dict = {}  # filled before the 2-rank world ends and adds the C15 world's
        for world in WORLDS:
            futures[world] = pool.submit(run_then_abort if world == 2 else run, world, dirs[world])
        futures["resume"] = pool.submit(run_resume, dirs["resume"])
        futures["resume_adamw"] = pool.submit(run_resume_adamw, dirs["resume"])
        made = [pool.submit(references, half) for half in (False, True)]  # two threads: XLA compiles off the GIL
        yield lambda world: ([m.result() for m in made], futures[2].result(), futures[world].result())[2]
    for directory in LAYOUT_DIRS.values():
        shutil.rmtree(directory, ignore_errors=True)


ABORT_TIMEOUT_S = 5  # the C15 world's group timeout


def _abort_case() -> dict:
    "The C15 case: a ring DiT served on a (1, 2) mesh whose rank 1 faults inside its first ring exchange."
    config = {**SERVE_DIT, "depth": 2}
    return {
        "kind": "serve_abort", "config": {**config, "compute_dtype": "float32", "attention": "ring"},
        "tree": random_param_tree(DiTConfig(**config), seed=40), "item": (4, 8, 8), "steps": 2,
        "seeds": (1, 2, 3), "fault": 1,
    }


def test_fault_inside_a_ring_exchange_fails_every_rank(spawned) -> None:
    """ROADMAP C15: on a 2-rank gloo world with a 5 s group timeout, rank 1's ring raises inside its
    first exchange.  It aborts the mesh's groups; rank 0, blocked in the ring, raises within the
    timeout; both engines fail the request (``MeshAborted``) and every pending one within 3 timeouts
    of the fault's injection (the clock starts there: the ranks' start on a loaded host is not
    recovery), and both processes exit (``spawn_sp`` joins them)."""
    outs = spawned("abort")
    injected = [at for ((_outcomes, at, _resolved),) in outs if at is not None]
    assert len(injected) == 1, outs  # rank 1's ring, once
    for rank, ((outcomes, _at, resolved),) in enumerate(outs):
        assert outcomes[0].startswith("MeshAborted: a fault inside a collective region aborted"), (rank, outcomes)
        assert all(isinstance(o, str) and o.startswith("RuntimeError: engine") for o in outcomes[1:]), (rank, outcomes)
        assert resolved - injected[0] < 3 * ABORT_TIMEOUT_S, (rank, resolved - injected[0])
    assert outs[1][0][0][0].endswith("injected fault inside the ring")


def _jax_mesh(world: int):
    import jax

    from skrample_tpu.parallel import make_mesh

    return make_mesh(dp=1, sp=world, devices=jax.devices()[:world])


def _jax_dit(config: dict, mesh):
    import jax.numpy as jnp

    from skrample_tpu.models import dit as jdit

    fields = {**config, "compute_dtype": jnp.float32}
    return jdit.DiT(jdit.DiTConfig(**fields), mesh=mesh)


_MESHLESS: dict[str, object] = {}


def _meshless_key(case: dict) -> str | None:
    "The key of ``case``'s mesh-less reference, one for both worlds and both schemes (None: on a mesh)."
    kind = case["kind"]
    if "ref" in case:
        return case["ref"]
    if kind in ("grad", "grad_model", "moe"):  # one reference for both worlds, and every scheme
        return f"{kind}-{case.get('op') or case.get('model') or case['method']}"
    if kind in ("pp_dit", "pp_mmdit"):
        return "grad_model-dit" if kind == "pp_dit" else kind
    if kind == "train_fsdp":
        return f"fsdp-{case['optimizer']}"
    if kind == "tp":
        return None if case.get("meshless") else f"tp-{case['model']}"
    if kind == "tp_sample":
        return "tp_sample"
    if "mesh" in case:
        return "dit_dp"
    return kind if kind in ("serve", "train_dit", "train_t2i", "pipeline", "mmdit", "video") else None


def _want(case: dict, world: int):
    """The JAX package's result of ``case`` on a ``(1, world)`` mesh of the 8 virtual devices; for the
    cases added with data parallelism, the JAX package's result without a mesh, made once for both
    worlds, where its own tests hold the two equal: a mesh engine and a pooled engine equal the
    single-device batch engine (``tests/test_serving.py`` ``TestMesh``, ``tests/test_continuous.py``
    ``test_pooled_equals_batch_engine``, ``test_sharded_pool_equals_unsharded``), a dp-sharded loop the
    single one (``tests/test_parallel.py::test_dp_sharded_loop_matches_single``), the ring/ulysses DiT
    and MMDiT the full-attention ones (``test_dit_ring_attention_matches_full``,
    ``test_dit_ulysses_attention_matches_full``, ``TestJointSP::test_mmdit_sp_matches_single``), the sp
    VideoDiT the single-device one (``tests/test_video_dit.py::test_sequence_parallel_matches_single_device``);
    and a ``dp`` step's mean of equal chunks' mean losses is the whole batch's mean loss."""
    import jax
    import jax.numpy as jnp

    from skrample_tpu.parallel.joint_sp import joint_sp_attention
    from skrample_tpu.parallel.ring_attention import ring_attention
    from skrample_tpu.parallel.ulysses import ulysses_attention

    kind = case["kind"]
    key = _meshless_key(case)
    if key is not None:
        if key not in _MESHLESS:
            _MESHLESS[key] = _want_meshless(case)
        return _MESHLESS[key]
    mesh = _jax_mesh(world)
    with mesh:  # under jit: the eager shard_maps take seconds where the compiled ones take tenths
        if kind in ("ring", "ulysses"):
            qkv = (jnp.asarray(case[n]) for n in ("q", "k", "v"))
            if kind == "ring":
                fn = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh, block_op=case["block_op"]))
            else:
                fn = jax.jit(lambda q, k, v: ulysses_attention(q, k, v, mesh, heads_op=case["heads_op"]))
            return np.asarray(fn(*qkv))
        if kind == "joint_sp":
            fn = jax.jit(lambda a, b: joint_sp_attention(a, b, case["heads"], mesh, scheme=case["scheme"]))
            return [np.asarray(o) for o in fn(jnp.asarray(case["qkv_a"]), jnp.asarray(case["qkv_b"]))]
        params = jax.tree.map(jnp.asarray, case["tree"])
        model = _jax_dit(case["config"], mesh)
        if kind == "dit":
            return np.asarray(jax.jit(model.apply)(params, jnp.asarray(case["x"]), jnp.asarray(case["t"])))
        from skrample_tpu import scheduling
        from skrample_tpu.ops import CompiledDenoiser, compile_sampler
        from skrample_tpu.sampling import models, structured

        compiled = compile_sampler(
            structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), case["steps"]
        )
        return np.asarray(CompiledDenoiser.build(compiled).run(model.as_sampleable(params), jnp.asarray(case["x0"])))


def _jax_sampling():
    from skrample_tpu import scheduling
    from skrample_tpu.sampling import models, structured

    return structured.DPM(order=2, stochasticity=1.0), scheduling.FlowShift(scheduling.Linear()), models.FlowModel()


def _want_meshless(case: dict):
    "The JAX package's engine requests (each alone at bucket 1), or one whole-batch loss and its gradients."
    import jax
    import jax.numpy as jnp

    from skrample_tpu.models import mmdit as jmmdit
    from skrample_tpu.models import text_encoder as jtext
    from skrample_tpu.serving import ServingEngine as JaxEngine
    from skrample_tpu_torch.models import _tree

    kind = case["kind"]
    if kind in ("pipe", "grad", "grad_model", "moe", "pp_dit", "pp_mmdit"):
        return _want_slice(case)
    params = jax.tree.map(jnp.asarray, case.get("tree", {}))
    if kind == "tp":  # the JAX model without a mesh (full attention for a sequence-parallel one)
        fields = dict(case["config"])
        if fields.get("attention") in ("ring", "ulysses"):
            fields["attention"] = "full"
        model = _jax_model(case["model"], fields)
        return np.asarray(jax.jit(model.apply)(params, *(jnp.asarray(case[n]) for n in case["inputs"])))
    if kind == "train_fsdp":  # tests/test_fsdp.py's jitted step, without a mesh, on the same draws
        import optax

        from skrample_tpu import optim as joptim

        model = _jax_dit(case["config"], None)
        opt = joptim.adamw8bit(case["lr"]) if case["optimizer"] == "adamw8bit" else optax.adamw(case["lr"])

        def loss_fn(p, x0, noise, sigma):
            s = sigma[:, None, None, None]
            pred = model.apply(p, (1 - s) * x0 + s * noise, sigma * 1000.0)
            return jnp.mean((pred - (noise - x0)) ** 2)

        @jax.jit
        def step(p, state, x0, noise, sigma):
            loss, grads = jax.value_and_grad(loss_fn)(p, x0, noise, sigma)
            updates, state = opt.update(grads, state, p)
            return optax.apply_updates(p, updates), state, loss

        state, losses = opt.init(params), []
        for draw in case["draws"]:
            params, state, loss = step(params, state, *map(jnp.asarray, draw))
            losses.append(float(loss))
        return [losses, dict(_tree._flatten(jax.tree.map(np.asarray, params)))]
    if kind == "tp_sample":  # the single-device full-attention MMDiT's CFG sample
        from skrample_tpu import scheduling
        from skrample_tpu.ops import CompiledDenoiser, compile_sampler
        from skrample_tpu.sampling import models, structured

        model = _jax_model("mmdit", {**case["config"], "attention": "full"})
        compiled = compile_sampler(
            structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), case["steps"]
        )
        fn = model.as_sampleable(params, jnp.asarray(case["context"]), guidance_scale=case["guidance"])
        return np.asarray(CompiledDenoiser.build(compiled, dtype=jnp.float32).run(fn, jnp.asarray(case["x0"])))
    if kind == "dit":  # the full-attention DiT
        model = _jax_dit({**case["config"], "attention": "full"}, None)
        return np.asarray(jax.jit(model.apply)(params, jnp.asarray(case["x"]), jnp.asarray(case["t"])))
    if kind == "mmdit":  # the full-attention MMDiT
        fields = {**case["config"], "compute_dtype": jnp.float32, "attention": "full"}
        model = jmmdit.MMDiT(jmmdit.MMDiTConfig(**fields))
        return np.asarray(jax.jit(model.apply)(params, *(jnp.asarray(case[n]) for n in ("x", "t", "context"))))
    if kind == "video":  # the single-device VideoDiT
        from skrample_tpu.models import video_dit as jvdit

        model = jvdit.VideoDiT(jvdit.VideoDiTConfig(**{**case["config"], "compute_dtype": jnp.float32}))
        return np.asarray(jax.jit(model.apply)(params, jnp.asarray(case["x"]), jnp.asarray(case["t"])))
    if kind == "pipeline":
        from skrample_tpu.pipeline import GenerationPipeline as JaxPipeline

        sampler, schedule, transform = _jax_sampling()
        pipe = JaxPipeline(
            model_fn=_jax_dit(case["config"], None).as_sampleable(params), sampler=sampler, schedule=schedule,
            model_transform=transform, steps=case["steps"], latent_shape=tuple(case["shape"]),
        )
        return np.asarray(pipe.generate(jax.random.PRNGKey(case["seed"])))
    if kind == "serve":
        model = _jax_dit(case["config"], None)
        sampler, schedule, transform = _jax_sampling()
        with JaxEngine(
            model.as_sampleable(params), tuple(case["item"]), sampler=sampler, schedule=schedule,
            model_transform=transform, steps=case["steps"], buckets=(1,),
        ) as engine:
            return [np.asarray(engine.generate(seed)) for seed in case["seeds"]]
    if kind == "train_dit":
        model = _jax_dit(case["config"], None)

        def loss_fn(p, x0, noise, sigma):
            s = sigma[:, None, None, None]
            pred = model.apply(p, (1 - s) * x0 + s * noise, sigma * 1000.0)
            return jnp.mean((pred - (noise - x0)) ** 2)

        args = [jnp.asarray(case[n]) for n in ("x0", "noise", "sigma")]
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
        return [float(loss), dict(_tree._flatten(jax.tree.map(np.asarray, grads)))]
    from skrample_tpu_torch.train_text_to_image import hermetic_data

    enc = jtext.TextEncoder(jtext.TextEncoderConfig(**{**case["enc"], "compute_dtype": jnp.float32}))
    mm = jmmdit.MMDiT(jmmdit.MMDiTConfig(**{**case["mmdit"], "compute_dtype": jnp.float32}))
    ids, images = (jnp.asarray(a.numpy()) for a in hermetic_data(case["size"], device="cpu"))

    def t2i_loss(p, idx, noise, sigma, drop):  # the example's loss_fn
        feats = enc.apply(p["enc"], ids[idx])
        ctx = mm.embed_context(p["mmdit"], feats, idx.shape[0])
        ctx = jnp.where(drop[:, None, None], mm.embed_context(p["mmdit"], None, idx.shape[0]), ctx)
        x0, s = images[idx], sigma[:, None, None, None]
        pred = mm.apply(p["mmdit"], (1 - s) * x0 + s * noise, sigma * 1000.0, ctx)
        return jnp.mean((pred - (noise - x0)) ** 2)

    params = jax.tree.map(jnp.asarray, case["trees"])
    loss, grads = jax.jit(jax.value_and_grad(t2i_loss))(params, *(jnp.asarray(d) for d in case["draws"]))
    grads = jax.tree.map(np.asarray, grads)
    return [float(loss), {sub: dict(_tree._flatten(grads[sub])) for sub in ("enc", "mmdit")}]


def _want_slice(case: dict):
    """The JAX package's result of a pipeline, gradient or expert case, without a mesh, where its own
    tests hold the two equal: the pipeline the stages run in sequence (tests/test_parallel.py:128, 180,
    696, 733), the pipelined DiT and MMDiT their ``apply`` (:159, :180, :772), the ring and ulysses
    attentions and models the full-attention ones (their forwards as in ``_want``; their gradients are
    ``jax.vjp`` and ``jax.value_and_grad`` of those forwards), ``reshard`` the identity on the whole array
    (a resharding), and the ep-sharded MoE FFN the unsharded one (:248, :475)."""
    import jax
    import jax.numpy as jnp

    from skrample_tpu.ops.flash_attention import attention_reference
    from skrample_tpu_torch.models import _tree

    kind = case["kind"]
    arr = lambda name: jnp.asarray(case[name])  # noqa: E731
    if kind == "pipe":
        if case["mode"] == "carry":
            def carried(xs, conds):
                out = xs
                for w in case["blocks"]:
                    out = jnp.tanh(out @ jnp.asarray(w) + conds)
                return out, conds

            @jax.jit
            def carried_vjp(xs, conds):
                (out, cond_out), vjp = jax.vjp(carried, xs, conds)
                return out, cond_out, *vjp((jnp.ones_like(out), 2 * jnp.ones_like(cond_out)))

            return [np.asarray(a) for a in carried_vjp(arr("xs"), arr("conds"))]

        def sequential(p, x):
            for stage in range(p["w"].shape[0]):
                x = jnp.tanh(x @ p["w"][stage] + p["b"][stage])
            return x

        params = {"w": arr("w"), "b": arr("b")}
        if case["mode"] == "forward":
            return [np.asarray(jax.jit(sequential)(params, arr("mbs")))]
        loss_fn = lambda p, x, target: jnp.mean((sequential(p, x) - target) ** 2)  # noqa: E731
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, arr("mbs"), arr("target"))
        return [float(loss), np.asarray(grads["w"]), np.asarray(grads["b"])]
    if kind == "grad" and case["op"] == "reshard":
        out, vjp = jax.vjp(lambda x: x, arr("x"))
        return [[np.asarray(out)], [np.asarray(vjp(arr("w"))[0])]]
    if kind == "grad" and case["op"] == "joint_sp":
        heads = case["heads"]

        def joint(a, b):
            split = lambda t: [p.reshape(*t.shape[:2], heads, -1).transpose(0, 2, 1, 3) for p in jnp.split(t, 3, -1)]  # noqa: E731
            o = attention_reference(*(jnp.concatenate([x, y], axis=2) for x, y in zip(split(a), split(b))))
            o = o.transpose(0, 2, 1, 3).reshape(a.shape[0], -1, a.shape[-1] // 3)
            return o[:, : a.shape[1]], o[:, a.shape[1]:]

        @jax.jit
        def joint_vjp(a, b, w_a, w_b):
            outs, vjp = jax.vjp(joint, a, b)
            return outs, vjp((w_a, w_b))

        outs, grads = joint_vjp(arr("qkv_a"), arr("qkv_b"), arr("w_a"), arr("w_b"))
        return [[np.asarray(o) for o in outs], [np.asarray(g) for g in grads]]
    if kind == "grad":
        @jax.jit
        def attention_vjp(q, k, v, w):
            out, vjp = jax.vjp(attention_reference, q, k, v)
            return out, vjp(w)

        out, grads = attention_vjp(arr("q"), arr("k"), arr("v"), arr("w"))
        return [[np.asarray(out)], [np.asarray(g) for g in grads]]
    if kind == "moe":
        from skrample_tpu.parallel import moe_ffn as jmoe
        from skrample_tpu.parallel import moe_ffn_capacity as jmoe_capacity

        params = jax.tree.map(jnp.asarray, case["params"])
        if case["method"] == "dense":
            return np.asarray(jax.jit(jmoe)(params, arr("tokens")))
        capacity = functools.partial(jmoe_capacity, capacity=case["capacity"], method=case["method"])
        return np.asarray(jax.jit(capacity)(params, arr("tokens")))
    params = jax.tree.map(jnp.asarray, case["tree"])
    fields = {**case["config"], "attention": "full"}
    if kind == "pp_mmdit":
        model = _jax_model("mmdit", fields)
        return np.asarray(jax.jit(model.apply)(params, arr("x"), arr("t"), arr("context")))
    model = _jax_model(case.get("model", "dit"), fields)
    extra = (arr("context"),) if "context" in case else ()

    def loss_fn(p):
        out = model.apply(p, arr("x"), arr("t"), *extra)
        return jnp.mean((out - arr("target")) ** 2), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return [float(loss), dict(_tree._flatten(jax.tree.map(np.asarray, grads))), np.asarray(out)]


def _jax_model(name: str, config: dict):
    "The JAX package's model ``name`` at ``config`` (float32)."
    import jax.numpy as jnp

    from skrample_tpu.models import dit as jdit
    from skrample_tpu.models import flux as jflux
    from skrample_tpu.models import mmdit as jmmdit
    from skrample_tpu.models import t5_encoder as jt5
    from skrample_tpu.models import text_encoder as jtext
    from skrample_tpu.models import unet_cond as juc
    from skrample_tpu.models import video_dit as jvdit

    fields = {**config, "compute_dtype": jnp.float32}
    kinds = {
        "dit": (jdit.DiT, jdit.DiTConfig), "mmdit": (jmmdit.MMDiT, jmmdit.MMDiTConfig),
        "flux": (jflux.Flux, jflux.FluxConfig), "video": (jvdit.VideoDiT, jvdit.VideoDiTConfig),
        "clip": (jtext.TextEncoder, jtext.TextEncoderConfig), "t5": (jt5.T5Encoder, jt5.T5EncoderConfig),
        "unet": (juc.CondUNet, juc.CondUNetConfig),
    }
    model, config_type = kinds[name]
    return model(config_type(**fields))


def _joined(kind: str, outs: list) -> np.ndarray | list[np.ndarray]:
    "The ranks' outputs as one global array: token shards concatenated in rank order; whole outputs equal."
    if kind in ("ring", "ulysses"):
        return np.concatenate(outs, axis=2)
    if kind == "joint_sp":
        return [np.concatenate([o[i] for o in outs], axis=1) for i in range(2)]
    if kind == "serve":  # every rank's futures hold every request's latent, gathered over dp
        for o in outs[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(o, outs[0]))
        return outs[0]
    if kind in ("train_dit", "train_t2i"):  # the averaged gradients: the same on every rank
        for o in outs[1:]:
            assert o[0] == outs[0][0] and _flat_grads(kind, o).keys() == _flat_grads(kind, outs[0]).keys()
            assert all(np.array_equal(a, _flat_grads(kind, outs[0])[k]) for k, a in _flat_grads(kind, o).items())
        return outs[0]
    for o in outs[1:]:  # the models gather their tokens: every rank holds the same whole output
        assert np.array_equal(o, outs[0])
    return outs[0]


def _flat_grads(kind: str, result: list) -> dict[str, np.ndarray]:
    "A training case's gradients by path (``enc.``/``mmdit.`` prefixed for the joint trainer)."
    if kind == "train_dit":
        return result[1]
    return {f"{sub}.{path}": g for sub, tree in result[1].items() for path, g in tree.items()}


# rtol / atol per kind, each the same float32 arithmetic with sums in another order
TOLERANCES = {
    "ring": (2e-5, 2e-6),
    "ulysses": (2e-5, 2e-6),
    "joint_sp": (2e-5, 2e-6),
    "dit": (1e-4, 1e-5),  # as the single-device DiT forward (tests/test_torch_dit.py)
    "sample": (0, 1e-4),  # the forward's differences carried through 8 steps of a contracting ODE solve
    "mmdit": (1e-4, 1e-5),  # as the single-device MMDiT forward (tests/test_torch_mmdit.py)
    "video": (1e-4, 1e-5),
    "serve": (0, 1e-4),  # as "sample": 4 stochastic steps (normals a few ulps apart, tests/test_torch_prng.py)
    "pipeline": (0, 1e-4),
    "tp_sample": (0, 1e-4),  # as "sample": 3 guided steps
}
# a tensor-parallel forward at its model's single-device tolerance (tests/test_torch_{dit,mmdit,video,flux,
# text_encoders,sdxl}.py: rtol 1e-4, atol a tenth of it or of it times the largest output)
TP_TOLERANCES = {
    "dit": TOLERANCES["dit"], "mmdit": TOLERANCES["mmdit"], "video": TOLERANCES["video"], "flux": (1e-4, 1e-5),
    "clip": (1e-4, 1e-5), "t5": (1e-4, 1e-5), "unet": (1e-4, 1e-5),
}
TRAIN_RTOL = 1e-5  # loss and every gradient: rtol, and atol of rtol x the leaf's largest magnitude, except
# the joint trainer's dense leaves: each element within K_GRAD eps32 * S of the float64 oracle and of
# JAX (``_t2i_oracle``), where the batch sums of t_mlp1's gradient cancel


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_case_matches_jax(spawned, world: int, name: str) -> None:
    """One case of the dry run on a spawned gloo world against the JAX package (see ``_want``): raw
    ring (B11 flash, einsum), ulysses, joint ring/ulysses on streams of 12 and 4 tokens a rank,
    the random-weight DiT forward and its 8-step DPM++2M sample; the ring and ulysses MMDiT
    (native wiring, qk-norm, a dual block) and the sequence-parallel VideoDiT; both engines over
    ``dp`` = the world with requests submitted at each rank's own pace, and the pipeline; one DiT
    and one text-to-image training step at ``dp`` = the world (loss and every gradient, rtol 1e-5);
    each model's forward cut over ``tp`` = the world (the int8 ones equal to their unsharded forward
    bit for bit) and FSDP training (``_check_fsdp``); the misuse cases raise the JAX package's
    ``ValueError`` on every rank (a flash DiT on a mesh without ``tp``, a bucket ``dp`` does not
    divide, ...), the trainer's ``--graph`` on CPU ranks exits with argparse's error, a pipeline over a
    ``tp`` axis and ``--dp --fsdp --orbax`` raise nothing, and a gradient through the ring or ulysses
    attention raises ``NotImplementedError``."""
    case = _cases(world)[name]
    outs = spawned(world)[name]
    if case["kind"] == "train_cli":
        _check_train_cli(case, outs)
        return
    if case["kind"] == "train_fsdp":
        if case["fsdp"]:
            _check_fsdp(case, world, outs, spawned(world)[f"fsdp_replicated-{case['optimizer']}"])
        else:
            _check_fsdp_jax(case, world, outs[0])
        return
    if "fault" in case:
        _check_fault(case, world, outs)
        return
    if case["kind"] == "resume_layout":
        _check_resume_layout(case, outs)
        return
    if case["kind"] in SLICE_TOLERANCES:
        _check_slice(case, world, outs)
        return
    if case["kind"] == "raises":
        expected = {
            "heads": f"ValueError: heads ({world + 1}) must divide the 'sp' axis size ({world})",
            "tokens": f"ValueError: tokens ({world + 1}) must divide the 'sp' axis size ({world})",
            "no_mesh": "ValueError: DiTConfig(attention='ring') needs DiT(config, mesh=...)",
            "dp": f"ValueError: buckets [1] not divisible by the mesh's dp={world}",
            "slots": f"ValueError: slots={world + 1} not divisible by the mesh's dp={world}",
            "stream_tokens": f"ValueError: stream a tokens ({world + 1}) must divide the 'sp' axis size ({world})",
            "tp": "no error",  # a pipeline over a tp axis: the axis is the model's
            "dp_graph": "SystemExit: python -m skrample_tpu_torch.training: error: --graph captures CUDA graphs: "
            "it needs --device cuda",
            "dp_orbax": "no error",  # --dp with --fsdp and --orbax: every rank's shard in the committed step
            "flash_mesh": "ValueError: DiT(mesh=...) with attention='flash' needs a 'tp' mesh axis",
        }[case["what"]]
        assert all(message.startswith(expected) for message in outs), outs
        return
    _check(case, world, outs)


def _check(case: dict, world: int, outs: list) -> None:
    "The ranks' joined result of ``case`` against the JAX package's."
    kind = case["kind"]
    if kind == "tp" and case.get("meshless"):  # int8: the unsharded forward's bits on every rank
        for sharded, single in outs:
            assert np.array_equal(sharded, single) and np.abs(single).max() > 0.1
        return
    got = _joined(kind, outs)
    want = _want(case, world)
    if kind in ("train_dit", "train_t2i"):
        np.testing.assert_allclose(got[0], want[0], rtol=TRAIN_RTOL)
        mine = _flat_grads(kind, got)
        theirs = _flat_grads(kind, want)
        assert mine.keys() == theirs.keys()
        oracle, sums = _t2i_oracle(case) if kind == "train_t2i" else ({}, {})
        for path, g in theirs.items():
            if path in sums:  # a dense leaf of the joint trainer: the oracle's per-element bound
                bound = K_GRAD * np.finfo(np.float32).eps * sums[path]
                assert_within(mine[path], oracle[path], 0, bound, f"{path} against the oracle")
                assert_within(mine[path], g, TRAIN_RTOL, bound, f"{path} against JAX")
                continue
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(mine[path], g, rtol=TRAIN_RTOL, atol=TRAIN_RTOL * scale, err_msg=path)
        return
    rtol, atol = TP_TOLERANCES[case["model"]] if kind == "tp" else TOLERANCES[kind]
    for mine, theirs in zip(got, want) if kind in ("joint_sp", "serve") else [(got, want)]:
        assert mine.shape == theirs.shape
        assert np.abs(theirs).max() > 0.1  # random weights and inputs: the comparison is not vacuous
        np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol)


# rtol / atol of the pipeline, gradient and expert cases: the JAX package's own tests' for the pipeline
# (tests/test_parallel.py: forward 1e-5 / 1e-6, gradients 1e-5 / 1e-7 with the loss at 1e-6, the pipelined
# models 1e-5 / 1e-5 and 2e-5 at pp x dp) and the experts (1e-5 / 1e-6); the gradients through the
# sequence-parallel collectives as the forwards' ("ring" above), and the models' as the dp training step's
# (TRAIN_RTOL, atol TRAIN_RTOL x the leaf's largest magnitude)
SLICE_TOLERANCES = {
    "pipe": (1e-5, 1e-6), "pp_dit": (1e-5, 1e-5), "pp_mmdit": (1e-5, 1e-5), "grad": TOLERANCES["ring"],
    "grad_model": (TRAIN_RTOL, None), "moe": (1e-5, 1e-6),
}


def _check_slice(case: dict, world: int, outs: list) -> None:
    """A pipeline, gradient or expert case's ranks against the JAX package's result (``_want_slice``)."""
    kind = case["kind"]
    want = _want(case, world)
    rtol, atol = SLICE_TOLERANCES[kind]
    if kind == "pipe":
        for o in outs[1:]:  # the stage ranks return the same outputs (broadcast) and whole gradients
            assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(o, outs[0]))
        got = outs[0]
        if case["mode"] in ("grad", "train"):
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
            for mine, theirs in zip(got[1:], want[1:]):
                np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-7)
            return
        for mine, theirs in zip(got, want):
            np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol)
        return
    if kind in ("pp_dit", "pp_mmdit"):
        for o in outs[1:]:
            assert np.array_equal(o, outs[0])
        theirs = want[2] if kind == "pp_dit" else want
        if case["mesh"][0] > 1:
            rtol = 2e-5  # tests/test_parallel.py:772's pp x dp tolerance
        assert np.abs(theirs).max() > 0.1
        np.testing.assert_allclose(outs[0], theirs, rtol=rtol, atol=atol)
        return
    if kind == "moe":
        for sharded, single in outs:  # ep-sharded == single on every rank, bit for bit
            assert np.array_equal(sharded, single)
            np.testing.assert_allclose(single, want, rtol=rtol, atol=atol)
        assert np.abs(want).max() > 0.1
        return
    if kind == "grad":
        dims = {"reshard": (2, 1), "joint_sp": (1, 1)}.get(case["op"], (2, 2))  # outputs', inputs' token dims
        got_out = [np.concatenate([o[0][i] for o in outs], axis=dims[0]) for i in range(len(want[0]))]
        got_grad = [np.concatenate([o[1][i] for o in outs], axis=dims[1]) for i in range(len(want[1]))]
        for mine, theirs in zip(got_out + got_grad, want[0] + want[1]):
            assert mine.shape == theirs.shape and np.abs(theirs).max() > 0.1
            if case["op"] == "reshard":  # data movement: exact
                assert np.array_equal(mine, theirs)
            else:
                np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol)
        return
    loss, grads = outs[0]  # grad_model: the summed gradients are the same on every rank
    for o in outs[1:]:
        assert o[0] == loss and all(np.array_equal(g, grads[k]) for k, g in o[1].items())
    np.testing.assert_allclose(loss, want[0], rtol=rtol)
    assert grads.keys() == want[1].keys()
    for path, g in want[1].items():
        np.testing.assert_allclose(grads[path], g, rtol=rtol, atol=rtol * float(np.abs(g).max()), err_msg=path)


@pytest.mark.parametrize("name", ["pipe-train", "pp_dit-dp"])
def test_pp_dp_matches_jax(spawned, name: str) -> None:
    """On a ``(dp 2, pp 2)`` mesh of the 4-rank world: a training step through the stage hops (each ``dp``
    index runs its own pipeline on its items, the gradients averaged over ``dp``; tests/test_parallel.py:733)
    and the pipelined DiT (:772), against the JAX package's sequential stages and its ``apply``."""
    _check_slice(_cases(4)[name], 4, spawned(4)[name])


def test_dp_sp_train_step_matches_jax(spawned) -> None:
    """``training.train_step`` of a ring DiT on a ``(dp 2, sp 2)`` mesh of the 4-rank world: each ``dp``
    index takes its half of the batch over its own ``sp`` pair, and the step sums the gradients over ``sp``,
    then averages them over ``dp``.  Its loss and gradients against ``jax.value_and_grad`` of the JAX
    full-attention DiT's loss on the whole batch (``SLICE_TOLERANCES["grad_model"]``)."""
    _check_slice(_cases(4)["grad_dit-dp_ring"], 4, spawned(4)["grad_dit-dp_ring"])


def _check_fsdp(case: dict, world: int, outs: list, replicated: list) -> None:
    """FSDP training as tests/test_fsdp.py holds it (its ``_run`` sharded against replicated): the sharded
    run against the same mesh's replicated one (``fsdp_replicated-*``) at its tolerances, losses rtol
    1e-5 and parameters rtol 2e-5 atol 2e-6; every rank holds the same whole parameters after the
    gather, and under 0.55 of the replicated parameter bytes; then against the JAX package (see
    ``_check_fsdp_jax``)."""
    losses, got, held = outs[0]
    for o in outs[1:]:
        assert o[0] == losses and all(np.array_equal(o[1][k], v) for k, v in got.items())
    ref_losses, ref, ref_held = replicated[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert got.keys() == ref.keys()
    for path, value in ref.items():
        np.testing.assert_allclose(got[path], value, rtol=2e-5, atol=2e-6, err_msg=path)
    assert held < 0.55 * ref_held, (held, ref_held)
    _check_fsdp_jax(case, world, outs[0])


def _check_fsdp_jax(case: dict, world: int, result: list) -> None:
    """A training case's losses and parameters against the JAX package's steps without a mesh on the
    same draws, at tests/test_fsdp.py's tolerances: losses rtol 1e-5, every parameter rtol 2e-5 atol
    2e-6, plus each element's ``_fsdp_allowance`` (the oracle's bound on how far the two packages'
    float32 gradient sums may carry it apart); at most 0.5% of the elements take the whole 2.1 lr a
    step that the bound caps at."""
    losses, got, _held = result
    want_losses, want = _want(case, world)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert want.keys() == got.keys()
    allowance = _fsdp_allowance(case)
    cap = 2.1 * case["lr"] * len(case["draws"])
    capped = sum(int((a >= cap).sum()) for a in allowance.values())
    assert capped <= 0.005 * sum(a.size for a in allowance.values()), capped
    for path, value in want.items():
        assert_within(got[path], value, 2e-5, 2e-6 + allowance[path], f"{path} against JAX")


def _fsdp_allowance(case: dict) -> dict[str, np.ndarray]:
    """Per parameter element, how far apart two float32 runs of ``case``'s steps may end beyond
    rounding the update: the case's steps through the port's DiT and the case's optimizer in float64
    (the oracle, on its own trajectory), each step's gradient error bound ``E = K_GRAD eps32 S``
    (``dense_grad_sums``) carried through the optimizer's update to first order, doubled (under
    AdamW8bit, with a code's step added to a stored moment's error where the code may round the other
    way, ``_oracle_quantized``).  An element whose gradient at some step lies within ``E`` of zero
    (S > 0: its sign is rounding) takes the cap instead: 2.1 lr a step, the most an update moves an
    element.  Made once for both worlds."""
    key = f"fsdp-{case['optimizer']}"
    if key not in _ORACLE:
        from skrample_tpu_torch.models.dit import DiT

        f64 = torch.float64
        model = DiT(DiTConfig(**{**case["config"], "compute_dtype": f64}), device="cpu").load_jax_params(case["tree"])
        model.double()
        layers = [(name, m) for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)]
        lr, b1, b2, eps, wd, eps32 = case["lr"], 0.9, 0.999, 1e-8, 1e-4, float(np.finfo(np.float32).eps)
        steps = len(case["draws"])
        cap = 2.1 * lr * steps
        eight = case["optimizer"] == "adamw8bit"
        state: dict[str, dict] = {}
        allowance: dict[str, np.ndarray] = {}
        for t, draw in enumerate(case["draws"]):
            x0, noise, sigma = (torch.from_numpy(a).to(f64) for a in draw)
            model.zero_grad()

            def loss() -> None:
                s = sigma[:, None, None, None]
                pred = model((1 - s) * x0 + s * noise, sigma * 1000.0)
                torch.mean((pred - (noise - x0)) ** 2).backward()

            sums = grad_sums_by_path(model, dense_grad_sums(loss))
            c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            with torch.no_grad():
                for name, layer in layers:
                    for leaf, param in (("w", layer.weight), ("b", layer.bias)):
                        path = f"{name}.{leaf}"
                        g = param.grad.numpy().T if leaf == "w" else param.grad.numpy()
                        e = K_GRAD * eps32 * sums[path]
                        st = state.setdefault(path, dict.fromkeys(("m", "v", "dm", "dv"), np.zeros_like(g)))
                        m = b1 * st["m"] + (1 - b1) * g
                        v = b2 * st["v"] + (1 - b2) * g * g
                        dm = b1 * st["dm"] + (1 - b1) * e  # the first-order errors of m and v
                        dv = b2 * st["dv"] + (1 - b2) * 2 * np.abs(g) * e
                        root = np.sqrt(v / c2)
                        du = dm / c1 / (root + eps) + np.abs(m / c1) * (dv / c2) / (
                            2 * np.maximum(root, 1e-300) * (root + eps) ** 2
                        )
                        upd = (m / c1) / (root + eps)
                        flip = (sums[path] > 0) & (np.abs(g) <= e)
                        if eight and g.size >= 4096:  # the state as stored: blocks of int8 codes
                            m, v, dm, dv = _oracle_quantized(m, v, dm, dv)
                        state[path] = {"m": m, "v": v, "dm": dm, "dv": dv}
                        total = allowance.get(path, np.zeros_like(g)) + 2 * lr * du
                        allowance[path] = np.where(flip | (total >= cap), cap, total)
                        value = torch.from_numpy(np.ascontiguousarray(upd.T if leaf == "w" else upd))
                        param.sub_(lr * (value + wd * param))
        _ORACLE[key] = allowance
    return _ORACLE[key]


def _oracle_quantized(
    m: np.ndarray, v: np.ndarray, dm: np.ndarray, dv: np.ndarray, block: int = 256
) -> tuple[np.ndarray, ...]:
    """AdamW8bit's stored moments of float64 ``m`` and ``v`` (the cube-root and fourth-root codes over
    blocks of ``block`` elements of the flattened leaf, ``optim.py``'s rule) and their first-order
    errors: ``dm``, ``dv``, plus one code's step where a code lies within twice its first-order error
    (from ``dm``, ``dv`` and the block scale's) of a rounding boundary."""

    def blocks(a: np.ndarray) -> np.ndarray:
        flat = a.reshape(-1)
        return np.concatenate([flat, np.zeros(-flat.size % block)]).reshape(-1, block)

    def unblock(a: np.ndarray) -> np.ndarray:
        return a.reshape(-1)[: m.size].reshape(m.shape)

    out = []
    for x, dx, power in ((m, dm, 3), (v, dv, 4)):
        xb, dxb = blocks(x), blocks(dx)
        top = np.abs(xb).argmax(1)[:, None]
        scale = np.take_along_axis(np.abs(xb), top, 1)
        dscale = np.take_along_axis(dxb, top, 1)
        scale = np.where(scale == 0, 1.0, scale)
        u = 127 * np.sign(xb) * (np.abs(xb) / scale) ** (1 / power)
        rel = np.divide(dxb, np.abs(xb), out=np.zeros_like(xb), where=xb != 0) + dscale / scale
        near = np.abs(np.abs(u - np.floor(u)) - 0.5) <= 2 * np.abs(u) / power * rel
        code = np.abs(np.round(u))
        step = (((code + 1) / 127) ** power - (code / 127) ** power) * scale
        out += [unblock(np.sign(xb) * (code / 127) ** power * scale), unblock(dxb + np.where(near, step, 0.0))]
    return out[0], out[2], out[1], out[3]


_ORACLE: dict[str, tuple] = {}


def _t2i_oracle(case: dict) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The joint trainer's loss through the port's code in float64 on the whole batch (the oracle):
    every gradient by ``enc.``/``mmdit.`` path, and each dense leaf's ``dense_grad_sums`` by path.
    Made once for both worlds."""
    if "t2i" not in _ORACLE:
        from skrample_tpu_torch.models import _tree
        from skrample_tpu_torch.train_text_to_image import hermetic_data, t2i_loss

        f64 = torch.float64
        enc = ttext.TextEncoder(ttext.TextEncoderConfig(**{**case["enc"], "compute_dtype": f64}), device="cpu")
        mm = tmmdit.MMDiT(tmmdit.MMDiTConfig(**{**case["mmdit"], "compute_dtype": f64}), device="cpu")
        enc.load_jax_params(case["trees"]["enc"]).double()
        mm.load_jax_params(case["trees"]["mmdit"]).double()
        ids, images = hermetic_data(case["size"], device="cpu")
        draws = [torch.from_numpy(a) for a in case["draws"]]
        draws = [d.to(f64) if d.is_floating_point() else d for d in draws]
        sums = dense_grad_sums(lambda: t2i_loss(enc, mm, ids, images.to(f64), *draws).backward())
        grads, bounds = {}, {}
        for sub, model in (("enc", enc), ("mmdit", mm)):
            for path, param, transposed in _tree.leaves(model):
                g = np.zeros(tuple(param.shape)) if param.grad is None else param.grad.numpy()
                grads[f"{sub}.{path}"] = g.T if transposed else g
            bounds.update({f"{sub}.{path}": v for path, v in grad_sums_by_path(model, sums).items()})
        _ORACLE["t2i"] = (grads, bounds)
    return _ORACLE["t2i"]


def _check_fault(case: dict, world: int, outs: list) -> None:
    """A model that raises at its first call on the last rank only: the first request fails on every
    rank (the injected error there, the agreement's elsewhere) instead of leaving the others in the
    all-gather.  The batch engine then serves the second request, equal on every rank and within
    the ``"serve"`` tolerance of the JAX engine's; the continuous engine closes on every rank, as it
    does on one device after a tick fault."""
    first = [o[0] for o in outs]
    assert first[-1] == "RuntimeError: injected fault", first
    assert all(f == "RuntimeError: a dispatch failed on another rank of the mesh" for f in first[:-1]), first
    second = [o[1] for o in outs]
    if case["engine"] == "continuous":
        assert all(isinstance(s, str) and s.startswith("RuntimeError: engine") for s in second), second
        return
    assert all(np.array_equal(s, second[0]) for s in second), second
    want = _want(_cases(world)["serve-batch"], world)[1]  # the JAX engine's latent of the same seed
    np.testing.assert_allclose(second[0], want, rtol=TOLERANCES["serve"][0], atol=TOLERANCES["serve"][1])


def _check_train_cli(case: dict, outs: list) -> None:
    """``python -m skrample_tpu_torch.training --dp S --opt8 --lora 2 --remat``: exit 0 on every rank,
    and rank 0's adapters against the same step on the whole batch in this process (the port's
    own: the dp step itself is held to the JAX package by ``train_dit``) at rtol 1e-5, an element
    within the most one AdamW step moves it (2.1 lr) where its gradient is rounding (a fresh ``b``
    adapter is 0, so the first step's update is lr x sign)."""
    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.checkpoint import load_params
    from skrample_tpu_torch.models import _tree

    path = case["argv"][-1]
    try:
        assert all(rc == 0 for rc, _ in outs)
        single = path.replace(".npz", "-single.npz")
        try:
            assert training.main([*case["argv"][:-1], single]) == 0
            want = dict(_tree._flatten(load_params(single)))
        finally:
            if os.path.exists(single):
                os.remove(single)
    finally:
        if os.path.exists(path):
            os.remove(path)
    got = outs[0][1]
    assert got.keys() == want.keys() and got
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=2.1e-4, err_msg=key)


def test_fsdp_kill_and_resume_equals_the_uninterrupted_run(spawned) -> None:
    """``python -m skrample_tpu_torch.training --dp 2 --fsdp --opt8 --host-loader`` on two gloo ranks: 4
    steps uninterrupted, against a run SIGKILLed after step 1 (a sharded save likely torn) and resumed
    from its last committed step to step 4 (the counterpart of tests/test_resume.py:127).  The whole
    parameters each writes and every rank's sharded train state at step 4 (its parameter parts,
    8-bit moments, count and EMA) are equal bit for bit."""
    from skrample_tpu_torch.models import _tree
    from skrample_tpu_torch.models.checkpoint import load_params

    out = spawned("resume")
    store = out["dir"]
    assert out["codes"] == {"a": [0, 0], "killed": [-9, -9], "resumed": [0, 0]}, out["codes"]
    want, got = (dict(_tree._flatten(load_params(f"{store}/{name}.npz"))) for name in ("a", "b"))
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    for rank in range(2):
        a, b = (torch.load(f"{store}/{d}/4/state-{rank}.pt", weights_only=True) for d in ("a", "b"))
        assert _tree_equal(a, b), rank
        assert a["step"] == 4 and any(getattr(p, "ndim", 0) == 1 for p in a["params"].values())


def _whole(parts: list[np.ndarray], like: np.ndarray) -> np.ndarray:
    """One tensor of a train state from the ``dp`` ranks' values, shaped as ``like`` holds it whole: a
    replicated value (every rank's alike) as it is, an FSDP part's (flat parts, or the 8-bit moments'
    blocks) concatenated in rank order."""
    if parts[0].shape == like.shape:
        assert all(np.array_equal(p, parts[0]) for p in parts)
        return parts[0]
    return np.concatenate(parts).reshape(like.shape)


def _assert_state_is_joined(whole: dict, ranks: list[dict]) -> None:
    """``whole`` (a one-rank train state: ``params``, ``ema``, ``opt`` by parameter name) is bit for bit
    the ``dp`` ranks' states (each by the names and optimizer order of its ``layout``) joined."""
    strip = lambda n: n.replace(".parametrizations.", ".").removesuffix(".original")  # noqa: E731
    for key in ("params", "ema"):
        names = {strip(n): n for n in ranks[0][key]}
        assert names.keys() == whole[key].keys(), key
        for name, value in whole[key].items():
            assert np.array_equal(value, _whole([r[key][names[name]] for r in ranks], value)), (key, name)
    for name, fields in whole["opt"].items():
        index = ranks[0]["layout"]["order"].index(name)
        for field, value in fields.items():
            parts = [np.asarray(r["opt"][index][field]) for r in ranks]
            assert np.array_equal(_whole(parts, np.asarray(value)), np.asarray(value)), (name, field)
    assert whole["count"] == ranks[0]["count"]


def _one_rank_state(argv: list[str], directory: str) -> dict:
    """The DiT trainer set up by ``argv`` in this process at dp 1, restored from the latest step in
    ``directory`` as ``main`` restores it: its parameters, EMA and optimizer state by parameter name,
    and AdamW8bit's count (None under AdamW), as numpy."""
    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.checkpoint import TrainCheckpointer

    args = training.parser().parse_args(argv)
    _model, trained, opt, ema = training.build_trainer(args, torch.device("cpu"), None)
    layout = training.train_layout(trained, opt, None)
    training._restore(training.restore_train_state(TrainCheckpointer(directory), layout, trained, opt, None), trained, opt, ema)
    state = opt.state_dict()["state"]
    return {
        "params": {n: p.detach().numpy() for n, p in trained.named_parameters()},
        "ema": {n: t.numpy() for n, t in ema.items()},
        "opt": {layout["order"][i]: {f: t.numpy() for f, t in v.items()} for i, v in state.items() if isinstance(i, int)},
        "count": int(state["count"]) if "count" in state else None,
    }


def _rank_states(directory: str, step: int) -> list[dict]:
    "Every rank's saved train state of ``step`` as numpy, with the step's layout record."
    from skrample_tpu_torch.models.checkpoint import TrainCheckpointer

    ckpt = TrainCheckpointer(directory)
    layout = ckpt.layout(step)
    out = []
    for saved in ckpt.restore_ranks(step):
        state = saved["opt_state"]["state"]
        out.append({
            "params": {n: t.numpy() for n, t in saved["params"].items()}, "ema": {n: t.numpy() for n, t in saved["ema"].items()},
            "opt": {i: {f: t.numpy() for f, t in v.items()} for i, v in state.items() if isinstance(i, int)},
            "count": int(state["count"]) if "count" in state else None, "layout": layout,
        })
    return out


@pytest.mark.parametrize("opt", ["adamw", "opt8"])
def test_fsdp_state_resumes_in_one_rank(spawned, tmp_path, opt: str) -> None:
    """ROADMAP C17: a train state committed by ``--dp 2 --fsdp`` (AdamW, 2 steps; ``--opt8``, 4 steps)
    resumes in one rank: the parameters, EMA and optimizer state restored (AdamW's moments, or
    AdamW8bit's codes, scales and count) are bit for bit the two ranks' parts joined.  A run without
    ``--resume`` over that step refuses, as the JAX example does; a resumed run's save at ``--dp 1``
    leaves the ``--dp 2`` step in place."""
    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.checkpoint import TrainCheckpointer

    out = spawned("resume")
    source, step = (f"{out['dir']}/a", 4) if opt == "opt8" else (f"{out['dir']}/c", 2)
    if opt == "adamw":
        assert spawned("resume_adamw") == [0, 0]
    directory = str(tmp_path / "ck")
    shutil.copytree(source, directory)
    argv = LAYOUT_ARGV[opt]
    _assert_state_is_joined(_one_rank_state(argv, directory), _rank_states(directory, step))
    with pytest.raises(SystemExit):  # argparse's error: a committed step and no --resume
        training.main([*argv, "--steps", "1", "--orbax", directory])
    assert training.main([*argv, "--until", str(step + 1), "--resume", "--orbax", directory]) == 0
    ckpt = TrainCheckpointer(directory)
    assert ckpt.all_steps() == [step, step + 1]
    assert ckpt.layout(step)["world"] == 2 and ckpt.layout(step + 1)["world"] == 1


def _check_resume_layout(case: dict, outs: list) -> None:
    """ROADMAP C17, the reverse of ``test_fsdp_state_resumes_in_one_rank``: a train state committed in one
    rank (2 steps, AdamW or ``--opt8``) resumes at ``--dp`` = the world with ``--fsdp``: the ranks'
    restored parts, joined, are the one-rank state bit for bit (each rank's part its chunk of it)."""
    from skrample_tpu_torch.models.checkpoint import TrainCheckpointer

    assert all(r["step"] == 2 for r in outs)
    ckpt = TrainCheckpointer(case["dir"])
    saved, order = ckpt.restore(2), ckpt.layout(2)["order"]
    state = saved["opt_state"]["state"]
    whole = {
        "params": {n: t.numpy() for n, t in saved["params"].items()}, "ema": {n: t.numpy() for n, t in saved["ema"].items()},
        "opt": {order[i]: {f: t.numpy() for f, t in v.items()} for i, v in state.items() if isinstance(i, int)},
        "count": int(state["count"]) if "count" in state else None,
    }
    for r in outs:
        r["count"] = int(r["opt"]["count"]) if "count" in r["opt"] else None
    _assert_state_is_joined(whole, outs)


def _tree_equal(a, b) -> bool:
    "Two saved train states equal: tensors bit for bit, containers and plain values alike."
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list | tuple):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_tp_sp_dit_matches_jax(spawned, attention: str) -> None:
    """The ring and ulysses DiT on a ``(1, 2, 2)`` mesh of the 4-rank world: its layers cut over ``tp``
    (two heads a rank), its tokens over ``sp``; the gathered forward against the JAX full-attention DiT
    at the ``"dit"`` tolerance."""
    name = f"tp_sp-{attention}"
    _check(_cases(4)[name], 4, spawned(4)[name])


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_dp_tp_mmdit_sample_matches_jax(spawned, scheme: str) -> None:
    """The ring and ulysses MMDiT on a ``(2, 1, 2)`` mesh of the 4-rank world (dp 2 x tp 2): its layers
    cut over ``tp``, each ``dp`` half of the batch and of the context, a 3-step DPM++2M sample with CFG
    2.0, gathered, against the JAX package's single-device full-attention sample (tolerance as
    ``"sample"``)."""
    name = f"tp_dp-{scheme}"
    _check(_cases(4)[name], 4, spawned(4)[name])


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_dp_sp_dit_matches_jax(spawned, attention: str) -> None:
    """A ring and a ulysses DiT on a ``(2, 2)`` mesh of the 4-rank world: each ``dp`` index runs its
    chunk of the batch over its own ``sp`` sub-group, and the gathered forward matches the JAX
    full-attention DiT (see ``_want``; rtol 1e-4, atol 1e-5)."""
    name = f"dit_dp-{attention}"
    _check(_cases(4)[name], 4, spawned(4)[name])
