"""The port's tensor-parallel specs and FSDP spec rules against the JAX package, in one process.

Every model's ``param_spec()`` (float and, where the JAX model has one,
quantized) equals the JAX model's, entry for entry; ``fsdp_leaf_spec``,
``fsdp_param_specs``, ``opt_state_specs`` and ``per_device_bytes`` equal
the JAX package's on the same trees (the JAX side on the conftest's 8
virtual devices).  The forwards cut over ``tp`` and FSDP training run on
spawned gloo worlds in ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from skrample_tpu import optim as joptim
from skrample_tpu.models import dit as jdit
from skrample_tpu.models import flux as jflux
from skrample_tpu.models import mmdit as jmmdit
from skrample_tpu.models import t5_encoder as jt5
from skrample_tpu.models import text_encoder as jtext
from skrample_tpu.models import unet_cond as juc
from skrample_tpu.models import video_dit as jvdit
from skrample_tpu.parallel import fsdp as jfsdp
from skrample_tpu.parallel import make_mesh as jmake_mesh
from skrample_tpu_torch.models import dit as tdit
from skrample_tpu_torch.models import flux as tflux
from skrample_tpu_torch.models import mmdit as tmmdit
from skrample_tpu_torch.models import t5_encoder as tt5
from skrample_tpu_torch.models import text_encoder as ttext
from skrample_tpu_torch.models import unet_cond as tuc
from skrample_tpu_torch.models import video_dit as tvdit
from skrample_tpu_torch.parallel import fsdp as tfsdp
from skrample_tpu_torch.parallel.tensor_parallel import P

# (port module, port model, port config, JAX model, JAX config, fields, the JAX spec takes quantized=)
MODELS = {
    "dit": (tdit.DiT, tdit.DiTConfig, jdit.DiT, jdit.DiTConfig, {"dim": 64, "depth": 2, "heads": 4}, True),
    "mmdit": (
        tmmdit.MMDiT, tmmdit.MMDiTConfig, jmmdit.MMDiT, jmmdit.MMDiTConfig,
        {"dim": 64, "depth": 3, "heads": 4, "context_dim": 32, "qk_norm": True, "dual_attention_layers": (0,),
         "final_txt_pre_only": True, "pooled_dim": 24, "pos_embed_max": 12, "attention": "full"},
        True,
    ),
    "mmdit_native": (
        tmmdit.MMDiT, tmmdit.MMDiTConfig, jmmdit.MMDiT, jmmdit.MMDiTConfig,
        {"dim": 64, "depth": 2, "heads": 4, "context_dim": 32, "attention": "full"}, True,
    ),
    "flux": (
        tflux.Flux, tflux.FluxConfig, jflux.Flux, jflux.FluxConfig,
        {"dim": 64, "heads": 1, "rope_axes": (16, 24, 24), "depth": 2, "single_depth": 2, "context_dim": 16,
         "pooled_dim": 8},
        True,
    ),
    "clip": (
        ttext.TextEncoder, ttext.TextEncoderConfig, jtext.TextEncoder, jtext.TextEncoderConfig,
        {"vocab_size": 300, "dim": 64, "depth": 2, "heads": 4, "max_tokens": 16, "ln_affine": True}, True,
    ),
    "t5": (
        tt5.T5Encoder, tt5.T5EncoderConfig, jt5.T5Encoder, jt5.T5EncoderConfig,
        {"vocab_size": 120, "dim": 64, "head_dim": 16, "heads": 4, "ff_dim": 96, "depth": 2}, False,
    ),
    "video": (
        tvdit.VideoDiT, tvdit.VideoDiTConfig, jvdit.VideoDiT, jvdit.VideoDiTConfig,
        {"dim": 64, "depth": 2, "heads": 4, "channels": 4, "context_dim": 24}, True,
    ),
    "unet": (
        tuc.CondUNet, tuc.CondUNetConfig, juc.CondUNet, juc.CondUNetConfig,
        {"widths": (64, 128, 256), "heads": (1, 2, 4), "transformer_layers": (0, 1, 2), "context_dim": 48,
         "pooled_dim": 56},
        False,
    ),
}
SPEC_CASES = [(name, q) for name, entry in MODELS.items() for q in ((False, True) if entry[-1] else (False,))]


def _norm(tree):
    "A spec tree with every spec (the JAX package's or the port's) as ``(\"P\", entries)``."
    if isinstance(tree, JP | P):
        return ("P", tuple(tree))
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list | tuple) and not hasattr(tree, "_fields"):
        return [_norm(v) for v in tree]
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, [_norm(v) for v in tree])
    return tree


@pytest.mark.parametrize(("name", "quantized"), SPEC_CASES, ids=[f"{n}-{'int8' if q else 'float'}" for n, q in SPEC_CASES])
def test_param_spec_equals_jax(name: str, quantized: bool) -> None:
    """``param_spec()`` of each model equals the JAX model's, float and quantized: the same tree, every
    leaf the same spec; the float spec covers exactly the port's parameter tree."""
    port_model, port_config, jax_model, jax_config, fields, _ = MODELS[name]
    port = port_model(port_config(**fields, compute_dtype=torch.float32), device="cpu")
    ref = jax_model(jax_config(**fields, compute_dtype=jnp.float32))
    kwargs = {"quantized": True} if quantized else {}
    assert _norm(port.param_spec(**kwargs)) == _norm(ref.param_spec(**kwargs))
    if not quantized:  # the spec's structure is the parameter tree's
        specs = jax.tree_util.tree_structure(port.param_spec(), is_leaf=lambda x: isinstance(x, P) or x is None)
        assert specs.num_leaves == len(jax.tree_util.tree_leaves(port.param_tree(), is_leaf=lambda x: x is None))


LEAF_CASES = [
    ((512, 1536), 4, None, 2**15),
    ((512, 1536), 4, ("P", (None, "tp")), 2**15),
    ((512, 1536), 4, ("P", ("tp", None)), 2**15),
    ((128,), 4, None, 2**15),
    ((64, 64), 4, ("P", (None, "tp")), 2**15),
    ((511, 1533), 4, None, 1),
    ((511, 1536), 4, None, 1),
    ((512, 1536), 1, None, 2**15),
    ((8, 96, 96), 2, ("P", ("tp",)), 1024),
]


@pytest.mark.parametrize(("shape", "size", "base", "min_size"), LEAF_CASES)
def test_fsdp_leaf_spec_equals_jax(shape, size: int, base, min_size: int) -> None:
    "tests/test_fsdp.py's rules and a few more: the port's leaf spec is the JAX package's."
    jbase = None if base is None else JP(*base[1])
    tbase = None if base is None else P(*base[1])
    assert _norm(tfsdp.fsdp_leaf_spec(shape, size, base=tbase, min_size=min_size)) == _norm(
        jfsdp.fsdp_leaf_spec(shape, size, base=jbase, min_size=min_size)
    )


@pytest.fixture(scope="module")
def dit_tree():
    "tests/test_fsdp.py's DiT (dim 128, depth 2, 8 heads): its JAX tree and tensor-parallel specs."
    config = {"patch": 2, "channels": 4, "dim": 128, "depth": 2, "heads": 8}
    ref = jdit.DiT(jdit.DiTConfig(**config, compute_dtype=jnp.float32))
    port = tdit.DiT(tdit.DiTConfig(**config, compute_dtype=torch.float32), device="cpu")
    params = ref.init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params), ref.param_spec(), port.param_spec()


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_fsdp_specs_and_bytes_equal_jax(dit_tree, optimizer: str) -> None:
    """``fsdp_param_specs`` over the megatron base (min_size 1024, dp 4), ``opt_state_specs`` of optax's
    AdamW and the 8-bit AdamW state, and ``per_device_bytes`` of the parameters and that state placed
    by those specs on a (dp 4, tp 2) layout, each equal to the JAX package's (its bytes on the 8
    virtual devices)."""
    params, host, jbase, tbase = dit_tree
    jspecs = jfsdp.fsdp_param_specs(params, 4, base_specs=jbase, min_size=1024)
    tspecs = tfsdp.fsdp_param_specs(host, 4, base_specs=tbase, min_size=1024)
    assert _norm(tspecs) == _norm(jspecs)
    opt = joptim.adamw8bit(1e-3) if optimizer == "adamw8bit" else optax.adamw(1e-3)
    state = opt.init(params)
    host_state = jax.tree.map(np.asarray, state)
    jstate_specs = jfsdp.opt_state_specs(state, params, jspecs, 4)
    tstate_specs = tfsdp.opt_state_specs(host_state, host, tspecs, 4)
    assert _norm(tstate_specs) == _norm(jstate_specs)

    mesh = jmake_mesh(dp=4, extra_axes={"tp": 2}, devices=jax.devices()[:8])
    for tree, host_tree, jtree_specs, ttree_specs in ((params, host, jspecs, tspecs), (state, host_state, jstate_specs, tstate_specs)):
        placed = jax.tree.map(lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)), tree, jtree_specs)
        want = jfsdp.per_device_bytes(placed)
        mine = tfsdp.per_device_bytes(_first_part(host_tree, ttree_specs, {"dp": 4, "tp": 2}))
        assert mine == want


def _first_part(tree, specs, sizes: dict[str, int]):
    "The first device's part of every leaf: each dim a spec names cut into that axis' size, chunk 0."
    def part(leaf, spec):
        t = torch.as_tensor(np.array(leaf))
        for dim, axis in enumerate(tuple(spec) if spec is not None else ()):
            if axis is not None:
                t = t.chunk(sizes[axis], dim=dim)[0]
        return t
    return tfsdp._map(part, tree, specs)


def test_shard_tree_places_by_the_specs(dit_tree) -> None:
    """``shard_tree`` on a stand-in for one rank of dp 4: each leaf its chunk of the dim the spec puts on
    ``dp`` (the leaf whole where it puts none), as ``NamedSharding`` places it."""
    _params, host, _jbase, tbase = dit_tree
    specs = tfsdp.fsdp_param_specs(host, 4, base_specs=tbase, min_size=1024)
    placed = tfsdp.shard_tree(host, None, specs, size=4, rank=2)
    w, spec = host["blocks"][1]["qkv"]["w"], tuple(specs["blocks"][1]["qkv"]["w"])
    dim = spec.index("dp")
    assert np.array_equal(placed["blocks"][1]["qkv"]["w"].numpy(), np.split(w, 4, axis=dim)[2])
    assert placed["blocks"][1]["qkv"]["b"] is host["blocks"][1]["qkv"]["b"]
