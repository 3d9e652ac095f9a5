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

import importlib
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from skrample_tpu_torch import prng
from skrample_tpu_torch.models.dit import DiTConfig, random_param_tree
from skrample_tpu_torch.ops import flash_attention as tfa
from skrample_tpu_torch.parallel import batch_keys
from skrample_tpu_torch.parallel.dryrun import spawn_sp

WORLDS = (2, 4)
DIT = {"dim": 64, "depth": 2, "heads": 4}  # head dim 16; 16x16 latents at patch 2: 64 tokens
B, H, D = 2, 4, 16  # the raw attention cases: 16 tokens a rank


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
    return cases


CASE_NAMES = tuple(_cases(2))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory: pytest.TempPathFactory):
    """``spawned(world)``: every rank's result of every case, by case name.  Both worlds start at
    once, in two threads of this process (2 + 4 single-threaded ranks), and are each run once."""

    def run(world: int) -> dict[str, list]:
        cases = _cases(world)
        store_dir = str(tmp_path_factory.mktemp(f"sp{world}"))
        per_rank = spawn_sp(world, list(cases.values()), store_dir, backend="gloo", device="cpu")
        return {name: [per_rank[r][i] for r in range(world)] for i, name in enumerate(cases)}

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {world: pool.submit(run, world) for world in WORLDS}
        yield lambda world: futures[world].result()


def _jax_mesh(world: int):
    import jax

    from skrample_tpu.parallel import make_mesh

    return make_mesh(dp=1, sp=world, devices=jax.devices()[:world])


def _jax_dit(config: dict, mesh):
    import jax.numpy as jnp

    from skrample_tpu.models import dit as jdit

    fields = {**config, "compute_dtype": jnp.float32}
    return jdit.DiT(jdit.DiTConfig(**fields), mesh=mesh)


def _want(case: dict, world: int):
    "The JAX package's result of ``case`` on a ``(1, world)`` mesh of the 8 virtual devices."
    import jax
    import jax.numpy as jnp

    from skrample_tpu.parallel.joint_sp import joint_sp_attention
    from skrample_tpu.parallel.ring_attention import ring_attention
    from skrample_tpu.parallel.ulysses import ulysses_attention

    mesh = _jax_mesh(world)
    kind = case["kind"]
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


def _joined(kind: str, outs: list) -> np.ndarray | list[np.ndarray]:
    "The ranks' outputs as one global array: token shards concatenated in rank order; whole outputs equal."
    if kind in ("ring", "ulysses"):
        return np.concatenate(outs, axis=2)
    if kind == "joint_sp":
        return [np.concatenate([o[i] for o in outs], axis=1) for i in range(2)]
    for o in outs[1:]:  # the DiT gathers its tokens: every rank holds the same whole output
        assert np.array_equal(o, outs[0])
    return outs[0]


# rtol / atol per kind, each the same float32 arithmetic with sums in another order
TOLERANCES = {
    "ring": (2e-5, 2e-6),
    "ulysses": (2e-5, 2e-6),
    "joint_sp": (2e-5, 2e-6),
    "dit": (1e-4, 1e-5),  # as the single-device DiT forward (tests/test_torch_dit.py)
    "sample": (0, 1e-4),  # the forward's differences carried through 8 steps of a contracting ODE solve
}


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_case_matches_jax(spawned, world: int, name: str) -> None:
    """One case of the dry run on a spawned gloo world against the JAX package on a ``(1, world)``
    mesh: raw ring (B11 flash, einsum), ulysses, joint ring/ulysses on streams of 12 and 4
    tokens a rank, the random-weight DiT forward and its 8-step DPM++2M sample; the misuse cases
    raise the JAX package's ``ValueError`` on every rank (what the port does not serve yet, a
    data-parallel mesh, a mesh for the flash attention, a gradient through the ring or ulysses
    attention, ``NotImplementedError``)."""
    case = _cases(world)[name]
    outs = spawned(world)[name]
    if case["kind"] == "raises":
        expected = {
            "heads": f"ValueError: heads ({world + 1}) must divide the 'sp' axis size ({world})",
            "tokens": f"ValueError: tokens ({world + 1}) must divide the 'sp' axis size ({world})",
            "no_mesh": "ValueError: DiTConfig(attention='ring') needs DiT(config, mesh=...)",
            "dp": "NotImplementedError: a data-parallel mesh (dp > 1)",
            "flash_mesh": "NotImplementedError: DiT(mesh=...) with attention='flash'",
            **dict.fromkeys(
                ("grad_ring", "grad_ulysses", "grad_dit"),
                "NotImplementedError: a gradient through sequence-parallel attention",
            ),
        }[case["what"]]
        assert all(message.startswith(expected) for message in outs), outs
        return
    got = _joined(case["kind"], outs)
    want = _want(case, world)
    rtol, atol = TOLERANCES[case["kind"]]
    for mine, theirs in zip(got, want) if case["kind"] == "joint_sp" else [(got, want)]:
        assert mine.shape == theirs.shape
        assert np.abs(theirs).max() > 0.1  # random weights and inputs: the comparison is not vacuous
        np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol)
