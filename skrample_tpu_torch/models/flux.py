"""The Flux rectified-flow transformer (FLUX.1 dev / schnell) as a PyTorch module.

The same network as the JAX package's ``models/flux.py``, parameter for
parameter (black-forest-labs FLUX.1; diffusers ``FluxTransformer2DModel``):

* **double-stream blocks** (19 at full scale): image and text streams with
  their own weights, adaLN-zero modulation, per-head RMS qk-norm and RoPE,
  ONE joint attention per block over the ``[text, image]`` sequence, 4x GELU
  MLPs per stream;
* **single-stream blocks** (38): the joint sequence, a 3-way modulation,
  attention and MLP branching from the same normalised input, one output
  projection over ``[attn | gelu(mlp)]``;
* **RoPE** over 3 position axes (zero for text, (y, x) for image patches),
  consecutive-pair rotation, theta 10000;
* **conditioning** = timestep embedding + (dev only) guidance embedding +
  pooled CLIP projection, each through linear-silu-linear.

Head dim 128 puts the joint attention on the fused-qkv kernel (K2), head dim
64 on B10's body over the qkv's ``chunk(3)`` views; every adaLN runs on K3,
and the qk-norm + RoPE pass on B7 (``ops/rope.py``, any even head dim),
which rewrites the q/k thirds of each block's qkv projection in place.
:meth:`Flux.quantize_params` gives the int8 serving model (B6 in front of
each int8 product).  ``apply`` takes plain ``(B, 16, H, W)`` latents: the
2x2 packing the diffusers pipeline does on the host is :meth:`Flux.patchify`
(the same (C, p, q) feature order).  ``t`` is the schedule timestep (sigma *
1000 for the flow schedules); guidance is embedded as ``guidance * 1000``.

:meth:`Flux.load_jax_params` carries the JAX package's parameter tree
across and :meth:`Flux.param_tree` carries it back.  Parameters live in the
``dtype`` the model is built in (float32 masters, or bfloat16 serving
storage); the RMS gains stay float32.  On a mesh with a ``tp`` axis each
rank keeps its shard of the layers :meth:`Flux.param_spec` splits
(``parallel/tensor_parallel.py``) and runs ``heads / tp`` heads.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable, Iterator
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..ops._cuda import resolve_device
from ..ops.adaln import adaln_modulate
from ..ops.flash_attention import _qkv_reference, flash_attention_pairs, flash_attention_qkv
from ..ops.rope import fused_rope_qk_norm
from ..parallel import tensor_parallel
from . import _tree
from .conditioning import per_item
from .dit import _DOTS_CONTEXT, _dense, _int8_copy, _timestep_embedding

_ZERO_INIT = frozenset({"ada", "final_mod", "final_out"})
_GAINS = ("q_norm", "k_norm")
_FLASH_HEAD_DIMS = (128, 64)  # K2 on the packed qkv; B10's body on its chunk(3) views


@dataclass(frozen=True)
class FluxConfig:
    patch: int = 2
    "The pipeline-level 2x2 latent packing, folded into the model."
    channels: int = 16
    "Unpacked latent channels; the packed width is ``channels * patch**2``."
    dim: int = 512
    depth: int = 2
    "Double-stream block count (19 at full scale)."
    single_depth: int = 4
    "Single-stream block count (38 at full scale)."
    heads: int = 4
    mlp_ratio: int = 4
    context_dim: int = 512
    "T5 feature width (4096 at full scale)."
    pooled_dim: int = 256
    "CLIP pooled width (768 at full scale)."
    guidance: bool = True
    "FLUX.1-dev's guidance-distilled embedding; False for schnell."
    rope_axes: tuple[int, ...] = (16, 56, 56)
    "Per-axis rotary dims (text-zero, y, x); must sum to head_dim."
    theta: int = 10000
    compute_dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"
    '``"flash"`` (kernel K2 at head_dim 128, B10 at 64) or ``"full"`` (plain attention, any head_dim).'
    remat: bool | str = False
    """Recompute each block's activations in the backward: ``True`` the
    whole block, ``"dots"`` all but the dense layers' products (as the DiT)."""

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def packed_width(self) -> int:
        return self.channels * self.patch * self.patch


def _linear(d_in: int, d_out: int, dtype: torch.dtype) -> nn.Linear:
    return nn.Linear(d_in, d_out, device="meta", dtype=dtype)


def _gain(d: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(d, device="meta", dtype=torch.float32))


class _TwoLayer(nn.Module):
    "linear-silu-linear (the conditioning MLPs)."

    def __init__(self, d_in: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.l1 = _linear(d_in, dim, dtype)
        self.l2 = _linear(dim, dim, dtype)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _dense(self.l2, F.silu(_dense(self.l1, x, dtype)), dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _prep_qkv(qkv: torch.Tensor, p: nn.Module, cos: torch.Tensor, sin: torch.Tensor, c: FluxConfig) -> torch.Tensor:
    """RMS-normalise and rotate the q/k thirds of a fused qkv tensor in one
    pass (kernel B7).  ``cos``/``sin`` are the rope-table rows of exactly
    this tensor's tokens: a view of one stream's rows in a double block, the
    joint tables in a single block."""
    return fused_rope_qk_norm(qkv, p.q_norm, p.k_norm, cos, sin, c.heads)


def _attention(qkv: torch.Tensor, c: FluxConfig) -> torch.Tensor:
    """``"flash"`` at head dim 128 is K2 on the packed qkv; at 64 it is B10's Hopper body on the ``chunk(3)``
    views (the plain version's gradient where one is wanted).  ``"full"`` is plain attention."""
    if c.attention != "flash":
        return _qkv_reference(qkv, c.heads)
    if c.head_dim == 64:
        return flash_attention_pairs(*qkv.chunk(3, dim=-1), c.heads)
    return flash_attention_qkv(qkv, c.heads)


class _Stream(nn.Module):
    "One stream (image or text) of a double-stream block."

    def __init__(self, c: FluxConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.ada = _linear(c.dim, 6 * c.dim, dtype)
        self.qkv = _linear(c.dim, 3 * c.dim, dtype)
        self.q_norm = _gain(c.head_dim)
        self.k_norm = _gain(c.head_dim)
        self.proj = _linear(c.dim, c.dim, dtype)
        self.mlp_in = _linear(c.dim, c.mlp_ratio * c.dim, dtype)
        self.mlp_out = _linear(c.mlp_ratio * c.dim, c.dim, dtype)


class _DoubleBlock(nn.Module):
    def __init__(self, c: FluxConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.config = c
        self.img = _Stream(c, dtype)
        self.txt = _Stream(c, dtype)

    def forward(
        self, img: torch.Tensor, txt: torch.Tensor, cond: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        dense = functools.partial(_dense, dtype=c.compute_dtype)
        L = txt.shape[1]
        si_a, gi_a, ci_a, si_m, gi_m, ci_m = dense(self.img.ada, cond).chunk(6, dim=-1)
        st_a, gt_a, ct_a, st_m, gt_m, ct_m = dense(self.txt.ada, cond).chunk(6, dim=-1)

        qkv_txt = dense(self.txt.qkv, adaln_modulate(txt, st_a, ct_a))
        qkv_img = dense(self.img.qkv, adaln_modulate(img, si_a, ci_a))
        # one norm + rotate pass per stream, on that stream's rows of the joint tables ([txt, img] order)
        qkv_txt = _prep_qkv(qkv_txt, self.txt, cos[:L], sin[:L], c)
        qkv_img = _prep_qkv(qkv_img, self.img, cos[L:], sin[L:], c)
        out = _attention(torch.cat([qkv_txt, qkv_img], dim=1), c)
        attn_txt, attn_img = out[:, :L], out[:, L:]

        img = img + gi_a[:, None] * dense(self.img.proj, attn_img)
        txt = txt + gt_a[:, None] * dense(self.txt.proj, attn_txt)
        h = adaln_modulate(img, si_m, ci_m)
        img = img + gi_m[:, None] * dense(self.img.mlp_out, _gelu(dense(self.img.mlp_in, h)))
        h = adaln_modulate(txt, st_m, ct_m)
        txt = txt + gt_m[:, None] * dense(self.txt.mlp_out, _gelu(dense(self.txt.mlp_in, h)))
        return img, txt


class _SingleBlock(nn.Module):
    def __init__(self, c: FluxConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.config = c
        self.ada = _linear(c.dim, 3 * c.dim, dtype)
        self.qkv = _linear(c.dim, 3 * c.dim, dtype)
        self.q_norm = _gain(c.head_dim)
        self.k_norm = _gain(c.head_dim)
        self.mlp_in = _linear(c.dim, c.mlp_ratio * c.dim, dtype)
        self.out = _linear((1 + c.mlp_ratio) * c.dim, c.dim, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        c = self.config
        dense = functools.partial(_dense, dtype=c.compute_dtype)
        shift, gate, scale = dense(self.ada, cond).chunk(3, dim=-1)
        h = adaln_modulate(x, shift, scale)
        qkv = _prep_qkv(dense(self.qkv, h), self, cos, sin, c)
        attn = _attention(qkv, c)
        mlp = _gelu(dense(self.mlp_in, h))
        return x + gate[:, None] * dense(self.out, torch.cat([attn, mlp], dim=-1))


class Flux(nn.Module):
    """``Flux(config)(x, t, context, pooled[, guidance])``: (B, C, H, W)
    latents, (B,) or scalar schedule timestep, (B, L, context_dim) T5
    features, (B, pooled_dim) CLIP pooling [, guidance scale] -> a prediction
    of the latents' shape and dtype.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with
    parameters in ``dtype`` (the RMS gains in float32) and the JAX package's
    initialisation drawn from ``generator`` (seed 0 on the CPU when
    omitted); see :meth:`reset_parameters`."""

    def __init__(
        self,
        config: FluxConfig = FluxConfig(),
        mesh: Any = None,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        c = config
        if sum(c.rope_axes) != c.head_dim:
            raise ValueError(f"rope_axes {c.rope_axes} must sum to head_dim {c.head_dim}")
        if c.attention not in ("flash", "full"):
            raise ValueError(f"unknown attention kind {c.attention!r}")
        if c.attention == "flash" and c.head_dim not in _FLASH_HEAD_DIMS:
            raise NotImplementedError(
                f"attention='flash' takes head_dim {' or '.join(map(str, _FLASH_HEAD_DIMS))}, got {c.head_dim}: "
                "use attention='full'"
            )
        if c.remat not in (False, True, "dots"):
            raise ValueError(f"remat must be bool or 'dots', got {c.remat!r}")
        if mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("Flux(mesh=...) needs a 'tp' mesh axis (tensor parallelism)")
        self.config = c
        self.mesh = mesh
        self.x_in = _linear(c.packed_width, c.dim, dtype)
        self.ctx_in = _linear(c.context_dim, c.dim, dtype)
        self.t_mlp = _TwoLayer(256, c.dim, dtype)
        self.pool_mlp = _TwoLayer(c.pooled_dim, c.dim, dtype)
        if c.guidance:
            self.guid_mlp = _TwoLayer(256, c.dim, dtype)
        self.final_mod = _linear(c.dim, 2 * c.dim, dtype)
        self.final_out = _linear(c.dim, c.packed_width, dtype)
        # the JAX tree's "double"/"single" (nn.Module.double() takes the plain name)
        self.double_blocks = nn.ModuleList(_DoubleBlock(c, dtype) for _ in range(c.depth))
        self.single_blocks = nn.ModuleList(_SingleBlock(c, dtype) for _ in range(c.single_depth))
        if tensor_parallel.tp_size(mesh) > 1:  # each rank holds its shard and runs heads / tp heads
            layers = tensor_parallel.linears(self, _tree_path)
            tensor_parallel.cut_on_meta(layers, self.param_spec(), mesh, self._tp_segments())
            for block in (*self.double_blocks, *self.single_blocks):
                block.config = tensor_parallel.local_config(c, mesh)
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)

    def _tp_segments(self) -> dict[str, tuple[int, ...]]:
        """The fused qkv's three parts, split by heads, and the single block's ``out`` rows over
        ``[attention | mlp]``, each part split alike."""
        c = self.config
        d = c.dim
        segments = {f"double.{i}.{s}.qkv": (d, d, d) for i in range(c.depth) for s in ("img", "txt")}
        for i in range(c.single_depth):
            segments[f"single.{i}.qkv"] = (d, d, d)
            segments[f"single.{i}.out"] = (d, c.mlp_ratio * d)
        return segments

    # -- parameters ------------------------------------------------------------

    def _leaves(self) -> Iterator[tuple[str, nn.Linear | nn.Parameter]]:
        "(dotted JAX-tree path, layer or gain) for every dense layer and RMS gain."
        for name, module in self.named_modules():
            if isinstance(module, nn.Linear):
                yield _tree_path(name), module
        for name, param in self.named_parameters():
            if name.rpartition(".")[2] in _GAINS:
                yield _tree_path(name), param

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, noise: float = 0.0) -> None:
        """The JAX package's initialisation: normal weights scaled by
        ``1/sqrt(d_in)``, zero biases, zero ``ada``/``final_mod``/``final_out``
        (adaLN-zero: a fresh model outputs exactly 0), unit RMS gains; then,
        with ``noise``, ``noise * N(0, 1)`` added to every weight, bias and
        gain (``scripts/bench_flux.py``'s recipe for random weights that
        exercise every path).  Drawn on ``generator``'s device (the CPU,
        seed 0, when omitted), one layer at a time, then cast to the
        parameters' dtype."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def normal(*shape: int) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=gen.device)

        for name, leaf in self._leaves():
            if isinstance(leaf, nn.Linear):
                d_in, d_out = tensor_parallel.whole_features(leaf)
                zero = name.rpartition(".")[2] in _ZERO_INIT
                w = torch.zeros(d_in, d_out, device=gen.device) if zero else normal(d_in, d_out) / math.sqrt(d_in)
                b = torch.zeros(d_out, device=gen.device)
                if noise:
                    w += noise * normal(d_in, d_out)
                    b += noise * normal(d_out)
                tensor_parallel.load_dense(leaf, w, b)
            else:
                g = torch.ones(leaf.shape, device=gen.device)
                leaf.copy_(g + noise * normal(*leaf.shape) if noise else g)

    def param_tree(self) -> dict:
        """The parameters as the JAX package's tree of float32 numpy arrays
        (``w`` ``(d_in, d_out)``, the transpose of ``nn.Linear``'s; the RMS
        gains as ``q_norm``/``k_norm`` arrays): the inverse of
        :meth:`load_jax_params`."""
        return _tree.param_tree(self, _tree_path)

    def load_jax_params(self, tree: dict) -> Flux:
        """Fill the module from the JAX package's parameter tree (as
        ``skrample_tpu.models.flux.Flux.init`` lays it out, numpy or jax
        arrays).  Every key must be consumed and every shape must match; an
        int8 tree does not load (load the float tree, then
        :meth:`quantize_params`)."""
        tree = tensor_parallel.shard_params(tree, self.param_spec(), self.mesh, self._tp_segments())
        _tree.load_tree(self, tree, "Flux", _tree_path)
        return self

    def quantize_params(self) -> Flux:
        """The int8 serving model, the JAX package's recipe: every block's
        qkv/proj/MLP weights as per-channel int8 with dynamic per-row
        activation scales (kernel B6); the modulation heads, the
        conditioning MLPs and the input/output projections (``ada``,
        ``final_mod``, ``final_out``, ``t_mlp``, ``pool_mlp``, ``guid_mlp``,
        ``ctx_in``, ``x_in``) stay as they are and are shared with this
        model.  Serving only: rounding has no gradient."""
        exclude = frozenset({"ada", "final_mod", "final_out", "t_mlp", "pool_mlp", "guid_mlp", "ctx_in", "x_in"})
        return _int8_copy(self, exclude)

    def param_spec(self, quantized: bool = False) -> dict:
        """The JAX package's megatron specs over ``tp``: each stream's and single block's qkv and
        mlp_in column-parallel, proj, mlp_out and the single block's out row-parallel, the rest
        replicated; int8's with ``quantized``."""
        col, row, rep = tensor_parallel.dense_specs(quantized)
        P = tensor_parallel.P
        c = self.config
        two = {"l1": dict(rep), "l2": dict(rep)}
        stream = {"ada": dict(rep), "qkv": dict(col), "q_norm": P(), "k_norm": P(), "proj": dict(row),
                  "mlp_in": dict(col), "mlp_out": dict(row)}
        single = {"ada": dict(rep), "qkv": dict(col), "q_norm": P(), "k_norm": P(), "mlp_in": dict(col),
                  "out": dict(row)}
        spec: dict = {
            "x_in": rep,
            "ctx_in": rep,
            "t_mlp": dict(two),
            "pool_mlp": dict(two),
            "final_mod": rep,
            "final_out": rep,
            "double": [{"img": dict(stream), "txt": dict(stream)} for _ in range(c.depth)],
            "single": [dict(single) for _ in range(c.single_depth)],
        }
        if c.guidance:
            spec["guid_mlp"] = dict(two)
        return spec

    # -- patch packing (the diffusers pipeline's host-side pack) --------------

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        "(B, C, H, W) -> (B, N, C * p * q)"
        c = self.config
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // c.patch, c.patch, W // c.patch, c.patch)
        x = x.permute(0, 2, 4, 1, 3, 5)
        return x.reshape(B, (H // c.patch) * (W // c.patch), C * c.patch * c.patch)

    def unpatchify(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        c = self.config
        B = x.shape[0]
        x = x.reshape(B, H // c.patch, W // c.patch, c.channels, c.patch, c.patch)
        x = x.permute(0, 3, 1, 4, 2, 5)
        return x.reshape(B, c.channels, H, W)

    # -- RoPE ----------------------------------------------------------------

    def _rope_tables(
        self, txt_len: int, grid_h: int, grid_w: int, device: str | torch.device = "cpu"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) float32 of shape (txt_len + grid_h * grid_w, head_dim // 2)
        for the joint [text, image] sequence: text ids are all zero, image ids
        (0, y, x) over the patch grid, each axis with its own rotary dims."""
        c = self.config
        f32 = torch.float32
        ys, xs = torch.meshgrid(
            torch.arange(grid_h, dtype=f32, device=device), torch.arange(grid_w, dtype=f32, device=device), indexing="ij"
        )
        img_ids = torch.stack([torch.zeros(grid_h * grid_w, dtype=f32, device=device), ys.reshape(-1), xs.reshape(-1)], -1)
        ids = torch.cat([torch.zeros((txt_len, 3), dtype=f32, device=device), img_ids], dim=0)
        parts = []
        for axis, dim_a in enumerate(c.rope_axes):
            omega = 1.0 / c.theta ** (torch.arange(0, dim_a, 2, dtype=f32, device=device) / dim_a)
            parts.append(ids[:, axis : axis + 1] * omega[None])
        angles = torch.cat(parts, dim=-1)
        return torch.cos(angles), torch.sin(angles)

    # -- forward -------------------------------------------------------------

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor | float,
        context: torch.Tensor,
        pooled: torch.Tensor,
        guidance: torch.Tensor | float | None = None,
    ) -> torch.Tensor:
        c = self.config
        dtype = c.compute_dtype
        B, _C, H, W = x.shape
        if (guidance is not None) != c.guidance:
            raise ValueError("guidance= goes with FluxConfig(guidance=True), and is required there")
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)

        img = _dense(self.x_in, self.patchify(x).to(dtype), dtype)
        txt = _dense(self.ctx_in, context.to(dtype), dtype)
        L = txt.shape[1]
        cos, sin = self._rope_tables(L, H // c.patch, W // c.patch, x.device)

        cond = self.t_mlp(_timestep_embedding(t, 256).to(dtype), dtype)
        if c.guidance:
            g = torch.as_tensor(guidance, dtype=torch.float32, device=x.device).expand(B)
            cond = cond + self.guid_mlp(_timestep_embedding(g * 1000.0, 256).to(dtype), dtype)
        cond = cond + self.pool_mlp(pooled.to(dtype), dtype)
        cond = F.silu(cond)

        for block in self.double_blocks:
            img, txt = self._run(block, img, txt, cond, cos, sin)
        h = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            h = self._run(block, h, cond, cos, sin)
        img = h[:, L:].contiguous()  # K3 reads a contiguous token stream

        shift, scale = _dense(self.final_mod, cond, dtype).chunk(2, dim=-1)
        img = adaln_modulate(img, shift, scale)
        out = _dense(self.final_out, img, dtype)
        return self.unpatchify(out, H, W).to(x.dtype)

    apply = forward

    def _run(self, block: nn.Module, *args: torch.Tensor) -> Any:
        c = self.config
        if c.remat and torch.is_grad_enabled():
            context = _DOTS_CONTEXT if c.remat == "dots" else noop_context_fn
            return checkpoint(block, *args, use_reentrant=False, context_fn=context)
        return block(*args)

    # -- serving ---------------------------------------------------------------

    def as_sampleable(
        self, context: torch.Tensor, pooled: torch.Tensor, guidance: float | None = None
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """Sampling closure ``(x, t, sigma, alpha)`` with the conditioning
        bound.  Flux-dev is guidance-distilled: ``guidance`` is an embedded
        input, not a CFG doubling, so one forward per step."""

        def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            B = x.shape[0]
            return self(x, t, per_item(context, B, 2), per_item(pooled, B, 1), guidance=guidance)

        return model_fn

    def as_served(self, guidance: float | None = None) -> Callable[..., torch.Tensor]:
        """Conditioned-serving closure ``(x, t, sigma, alpha, (context, pooled))``
        for ``ServingEngine(conditioned=True)``: each request submits its
        ``(context, pooled)`` pair and the engine stacks them per batch."""

        def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any, ctx: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
            context, pooled = ctx
            return self(x, t, context, pooled, guidance=guidance)

        return model_fn


def _tree_path(name: str) -> str:
    "A module path as the JAX tree names it (``double_blocks.3.img.qkv`` -> ``double.3.img.qkv``)."
    head, _, rest = name.partition(".")
    return f"{_TREE_NAMES.get(head, head)}.{rest}" if rest else name


_TREE_NAMES = {"double_blocks": "double", "single_blocks": "single"}


def random_param_tree(config: FluxConfig, seed: int) -> dict:
    """A JAX-layout Flux tree with EVERY leaf random from a numpy seed (normal
    weights scaled by ``1/sqrt(d_in)``, normal biases scaled by 0.1, gains
    ``1 + 0.1 N(0, 1)``): the adaLN-zero initialisation would make both
    packages output exactly 0, so parity checks draw all weights from this."""
    rng = np.random.default_rng(seed)
    c = config
    d = c.dim

    def dense(d_in: int, d_out: int) -> dict:
        w = rng.standard_normal((d_in, d_out), dtype=np.float32) / np.float32(math.sqrt(d_in))
        return {"w": w, "b": rng.standard_normal(d_out, dtype=np.float32) * np.float32(0.1)}

    def gain() -> np.ndarray:
        return np.float32(1) + rng.standard_normal(c.head_dim, dtype=np.float32) * np.float32(0.1)

    def stream() -> dict:
        return {
            "ada": dense(d, 6 * d),
            "qkv": dense(d, 3 * d),
            "q_norm": gain(),
            "k_norm": gain(),
            "proj": dense(d, d),
            "mlp_in": dense(d, c.mlp_ratio * d),
            "mlp_out": dense(c.mlp_ratio * d, d),
        }

    tree: dict = {
        "x_in": dense(c.packed_width, d),
        "ctx_in": dense(c.context_dim, d),
        "t_mlp": {"l1": dense(256, d), "l2": dense(d, d)},
        "pool_mlp": {"l1": dense(c.pooled_dim, d), "l2": dense(d, d)},
        "final_mod": dense(d, 2 * d),
        "final_out": dense(d, c.packed_width),
        "double": [{"img": stream(), "txt": stream()} for _ in range(c.depth)],
        "single": [
            {
                "ada": dense(d, 3 * d),
                "qkv": dense(d, 3 * d),
                "q_norm": gain(),
                "k_norm": gain(),
                "mlp_in": dense(d, c.mlp_ratio * d),
                "out": dense((1 + c.mlp_ratio) * d, d),
            }
            for _ in range(c.single_depth)
        ],
    }
    if c.guidance:
        tree["guid_mlp"] = {"l1": dense(256, d), "l2": dense(d, d)}
    return tree


def flux_forward_flops(config: FluxConfig, batch: int, h: int, w: int, txt_tokens: int) -> float:
    "Analytic matmul FLOPs of one forward (the JAX package's count)."
    c = config
    n_img = (h // c.patch) * (w // c.patch)
    n = n_img + txt_tokens
    d = c.dim
    total = 0.0
    # double blocks: per-token qkv(6) + proj(2) + mlp(8+8) = 24 d^2 per stream
    for tokens in (n_img, txt_tokens):
        total += c.depth * batch * tokens * d * d * 24
    total += c.depth * batch * 2 * (2.0 * d * 6 * d)  # two 6-group ada heads per block
    total += 4.0 * batch * c.depth * n * n * d  # joint attention scores + combine
    # single blocks: per-token qkv(6) + mlp_in(8) + fused out(10) = 24 d^2
    total += c.single_depth * batch * n * d * d * 24
    total += c.single_depth * batch * 2.0 * d * 3 * d  # 3-group ada head
    total += 4.0 * batch * c.single_depth * n * n * d
    pw = c.packed_width
    total += 2.0 * batch * n_img * pw * d * 2  # x_in + final_out
    total += 2.0 * batch * txt_tokens * c.context_dim * d  # ctx_in
    # conditioning MLPs (per batch row): t, pooled, guidance, final_mod
    total += 2.0 * batch * (256 * d + d * d)
    total += 2.0 * batch * (c.pooled_dim * d + d * d)
    if c.guidance:
        total += 2.0 * batch * (256 * d + d * d)
    total += 2.0 * batch * d * 2 * d
    return total
