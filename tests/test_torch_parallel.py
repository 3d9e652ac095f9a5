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
from skrample_tpu_torch.parallel.dryrun import spawn_sp

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
TRAIN_CLI = [  # the DiT trainer's CLI, 1 step of batch 4 with every option --dp composes with
    "--device", "cpu", "--steps", "1", "--batch", "4", "--dim", "64", "--depth", "1", "--heads", "1", "--size", "8",
    "--opt8", "--lora", "2", "--remat",
]


def _jfa():
    "The JAX flash-attention module (``skrample_tpu.ops`` re-exports a function of that name)."
    return importlib.import_module("skrample_tpu.ops.flash_attention")


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
    for what in ("heads", "tokens", "no_mesh", "dp", "flash_mesh", "grad_ring", "grad_ulysses", "grad_dit"):
        cases[f"raises-{what}"] = {"kind": "raises", "what": what}
    cases.update(_parallel_cases(world))
    if world == 4:  # a dp x sp mesh needs 4 ranks
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
    path = os.path.join(tempfile.gettempdir(), f"dp-cli-{uuid.uuid4().hex}-{world}.npz")
    cases["train_cli"] = {"kind": "train_cli", "argv": [*TRAIN_CLI, "--checkpoint", path]}
    for what in ("slots", "stream_tokens", "tp", "dp_graph", "dp_orbax"):
        cases[f"raises-{what}"] = {"kind": "raises", "what": what}
    return cases


CASE_NAMES = tuple(_cases(2))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory: pytest.TempPathFactory):
    """``spawned(world)``: every rank's result of every case, by case name.  Both worlds start at
    once, in two threads of this process (2 + 4 single-threaded ranks), and are each run once; a
    third thread makes the JAX package's mesh-less references meanwhile (``_want``), and
    ``spawned`` returns once they are made too."""

    def run(world: int, store_dir: str) -> dict[str, list]:
        cases = _cases(world)
        per_rank = spawn_sp(world, list(cases.values()), store_dir, backend="gloo", device="cpu")
        return {name: [per_rank[r][i] for r in range(world)] for i, name in enumerate(cases)}

    def references() -> None:
        for case in _cases(max(WORLDS)).values():
            if _meshless_key(case) is not None:
                _want(case, max(WORLDS))

    # made here, before the threads: two threads' first mktemp race to create pytest's base temp dir
    dirs = {world: str(tmp_path_factory.mktemp(f"sp{world}")) for world in WORLDS}
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        futures = {world: pool.submit(run, world, dirs[world]) for world in WORLDS}
        made = pool.submit(references)
        yield lambda world: (made.result(), futures[world].result())[1]


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
    if "mesh" in case:
        return "dit_dp"
    kind = case["kind"]
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
    params = jax.tree.map(jnp.asarray, case.get("tree", {}))
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
}
TRAIN_RTOL = 1e-5  # loss and every gradient: rtol, and atol of rtol x the leaf's largest magnitude


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_case_matches_jax(spawned, world: int, name: str) -> None:
    """One case of the dry run on a spawned gloo world against the JAX package (see ``_want``): raw
    ring (B11 flash, einsum), ulysses, joint ring/ulysses on streams of 12 and 4 tokens a rank,
    the random-weight DiT forward and its 8-step DPM++2M sample; the ring and ulysses MMDiT
    (native wiring, qk-norm, a dual block) and the sequence-parallel VideoDiT; both engines over
    ``dp`` = the world with requests submitted at each rank's own pace, and the pipeline; one DiT
    and one text-to-image training step at ``dp`` = the world (loss and every gradient, rtol 1e-5);
    the misuse cases raise the JAX package's ``ValueError`` on every rank (what the port does not
    serve yet, a mesh for the flash attention, a ``tp`` axis, ``--dp`` with ``--graph`` or
    ``--orbax``, a gradient through the ring or ulysses attention, ``NotImplementedError``)."""
    case = _cases(world)[name]
    outs = spawned(world)[name]
    if case["kind"] == "train_cli":
        _check_train_cli(case, outs)
        return
    if "fault" in case:
        _check_fault(case, world, outs)
        return
    if case["kind"] == "raises":
        expected = {
            "heads": f"ValueError: heads ({world + 1}) must divide the 'sp' axis size ({world})",
            "tokens": f"ValueError: tokens ({world + 1}) must divide the 'sp' axis size ({world})",
            "no_mesh": "ValueError: DiTConfig(attention='ring') needs DiT(config, mesh=...)",
            "dp": f"ValueError: buckets [1] not divisible by the mesh's dp={world}",
            "slots": f"ValueError: slots={world + 1} not divisible by the mesh's dp={world}",
            "stream_tokens": f"ValueError: stream a tokens ({world + 1}) must divide the 'sp' axis size ({world})",
            "tp": "NotImplementedError: tensor parallelism (a 'tp' mesh axis) comes with a later slice",
            "dp_graph": "NotImplementedError: --dp > 1 with --graph or --orbax",
            "dp_orbax": "NotImplementedError: --dp > 1 with --graph or --orbax",
            "flash_mesh": "NotImplementedError: DiT(mesh=...) with attention='flash'",
            **dict.fromkeys(
                ("grad_ring", "grad_ulysses", "grad_dit"),
                "NotImplementedError: a gradient through sequence-parallel attention",
            ),
        }[case["what"]]
        assert all(message.startswith(expected) for message in outs), outs
        return
    _check(case, world, outs)


def _check(case: dict, world: int, outs: list) -> None:
    "The ranks' joined result of ``case`` against the JAX package's."
    kind = case["kind"]
    got = _joined(kind, outs)
    want = _want(case, world)
    if kind in ("train_dit", "train_t2i"):
        np.testing.assert_allclose(got[0], want[0], rtol=TRAIN_RTOL)
        mine = _flat_grads(kind, got)
        theirs = _flat_grads(kind, want)
        assert mine.keys() == theirs.keys()
        for path, g in theirs.items():
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(mine[path], g, rtol=TRAIN_RTOL, atol=TRAIN_RTOL * scale, err_msg=path)
        return
    rtol, atol = TOLERANCES[kind]
    for mine, theirs in zip(got, want) if kind in ("joint_sp", "serve") else [(got, want)]:
        assert mine.shape == theirs.shape
        assert np.abs(theirs).max() > 0.1  # random weights and inputs: the comparison is not vacuous
        np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol)


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


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_dp_sp_dit_matches_jax(spawned, attention: str) -> None:
    """A ring and a ulysses DiT on a ``(2, 2)`` mesh of the 4-rank world: each ``dp`` index runs its
    chunk of the batch over its own ``sp`` sub-group, and the gathered forward matches the JAX
    full-attention DiT (see ``_want``; rtol 1e-4, atol 1e-5)."""
    name = f"dit_dp-{attention}"
    _check(_cases(4)[name], 4, spawned(4)[name])
