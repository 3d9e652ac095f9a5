"""The text-conditioned SD-class UNet (UNet2DConditionModel) as a PyTorch
module: the SD1.5 / SDXL denoiser.

The same network as the JAX package's ``models/unet_cond.py``, parameter
for parameter (diffusers ``UNet2DConditionModel``):

* resnet blocks with timestep-embedding injection
  (``h += time_emb_proj(silu(emb))``) and GroupNorm(affine, eps 1e-5),
* ``Transformer2DModel`` stages per level: GroupNorm + token projection,
  then K basic blocks of self-attention, cross-attention over the text
  context and a GEGLU feed-forward (exact erf gelu); K is the per-level
  ``transformer_layers`` (SDXL: (0, 2, 10)),
* skip concatenation down -> up on the channel axis, a stride-2 conv
  downsample with torch ``padding=1``, nearest-2x upsample + conv,
* SDXL's added conditioning: pooled text + six sinusoidally embedded
  ``time_ids`` through a second MLP into the time embedding.

The interior is channels-last, as in :mod:`.unet`: every GroupNorm (46 a
forward at SDXL base) is kernel B8, every stride-1 3x3 conv (38) is kernel
B12 with its norm off (``_conv``: one rounding of the f32 sum), and every
d = 64 self-attention (70) is kernel B10, reading the ``chunk(3)`` views of
the fused qkv product in place.  A self-attention at another head dim
dividing 128 is kernel B9 on heads zero-padded to 128, as the JAX package
pads them for its packed kernel.  Cross-attention (77 text tokens) and
every other head dim stay plain PyTorch, as the JAX package leaves them to
einsum outside any Pallas kernel.  :meth:`CondUNet.load_jax_params` carries the JAX package's tree
across and :meth:`CondUNet.param_tree` back; :meth:`CondUNet.quantize_params`
gives the int8 serving model (B6 in front of each int8 product) at the
``"deep"`` or ``"all"`` scope.  The encoder (resnets, Transformer2D stages,
conditioning) is shared with :class:`~.controlnet.ControlNet`.  On a mesh
with a ``tp`` axis the Transformer2D stages' layers are cut as
:meth:`CondUNet.param_spec` splits them (``parallel/tensor_parallel.py``);
convs, norms and time embeddings stay whole.
"""

from __future__ import annotations

import copy
import itertools
import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops._cuda import resolve_device
from ..ops.flash_attention import (
    attention_reference,
    flash_attention_packed,
    flash_attention_pairs,
    pairs_kernel_fits,
)
from ..ops.groupnorm import groupnorm_cl
from ..ops.quant import Int8Dense, quantize_params
from .conditioning import doubled_t, guided_mix, per_item
from ..parallel import tensor_parallel
from .dit import _dense, _timestep_embedding
from .unet import (
    _AffineSpec,
    _ConvSpec,
    _DenseSpec,
    _conv,
    _map,
    _random_tree,
    _to_channels_last,
    _to_nchw,
    _TreeModule,
    _upsample_nearest,
    _walk,
)

__all__ = ["CondUNet", "CondUNetConfig", "attention_route", "random_param_tree"]


@dataclass(frozen=True)
class CondUNetConfig:
    channels: int = 4
    widths: tuple[int, ...] = (320, 640, 1280)
    "Per-level channel widths (SDXL's (320, 640, 1280); SD1.5 adds a 4th 1280)."
    layers_per_block: int = 2
    transformer_layers: tuple[int, ...] = (0, 2, 10)
    "Basic transformer blocks per attention stage, per level; 0 = a plain level."
    mid_transformer_layers: int | None = None
    "Mid-block depth; None = the last level's count (SD1.5 sets it: its last level is plain)."
    heads: tuple[int, ...] = (5, 10, 20)
    "Attention heads per level (head_dim = width / heads; 64 for SDXL)."
    context_dim: int = 2048
    pooled_dim: int = 1280
    "SDXL's pooled-text width (with ``time_ids`` micro-conditioning); 0 = SD1.5."
    time_ids: int = 6
    add_time_embed_dim: int = 256
    groups: int = 32
    compute_dtype: torch.dtype = torch.bfloat16
    layout: str = "auto"
    """Accepted for parity with the JAX configuration and ignored: the port's
    interior is always channels-last (NCHW against NHWC was a TPU lane
    choice)."""

    @property
    def levels(self) -> int:
        return len(self.widths)

    @property
    def resolved_mid_layers(self) -> int:
        return self.transformer_layers[-1] if self.mid_transformer_layers is None else self.mid_transformer_layers

    @property
    def time_dim(self) -> int:
        return 4 * self.widths[0]


def _ln_affine(x: torch.Tensor, p: Any) -> torch.Tensor:
    "LayerNorm with a learned f32 affine (eps 1e-5): statistics and affine in f32, one rounding."
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return (((x32 - mean) * torch.rsqrt(var + 1e-5)) * p.g + p.b).to(x.dtype)


def attention_route(n: int, kv_len: int, heads: int, head_dim: int) -> str:
    """Where ``CondUNet._mha`` sends an attention, as the JAX package's
    ``_mha`` does: ``"pairs"`` (kernel B10: a self-attention at head dim 64,
    any ``N`` and head count), ``"packed"`` (kernel B9: a self-attention
    whose head dim divides 128 and is not 64, each head zero-padded to 128
    with q pre-scaled by ``sqrt(128 / d)``, the reference's recipe) or
    ``"plain"`` (cross-attention and every other head dim, as the JAX
    package runs them as einsum).  The JAX package's ``N >= 1024`` and
    ``N % 128`` conditions are TPU budgets and are dropped."""
    if kv_len != n:
        return "plain"
    if pairs_kernel_fits(n, heads, head_dim):
        return "pairs"
    if head_dim <= 128 and 128 % head_dim == 0:
        return "packed"
    return "plain"


def _cond_unet_skeleton(c: CondUNetConfig) -> dict:
    "The JAX ``CondUNet.init`` tree with leaf specs in place of arrays."

    def resnet(c_in: int, c_out: int) -> dict:
        return {
            "norm1": _AffineSpec(c_in),
            "conv1": _ConvSpec(3, c_in, c_out),
            "temb": _DenseSpec(c.time_dim, c_out),
            "norm2": _AffineSpec(c_out),
            "conv2": _ConvSpec(3, c_out, c_out, scale=0.0),
            "skip": _ConvSpec(1, c_in, c_out) if c_in != c_out else None,
        }

    def basic(d: int) -> dict:
        return {
            "ln1": _AffineSpec(d),
            "attn1_qkv": _DenseSpec(d, 3 * d),
            "attn1_out": _DenseSpec(d, d),
            "ln2": _AffineSpec(d),
            "attn2_q": _DenseSpec(d, d),
            "attn2_kv": _DenseSpec(c.context_dim, 2 * d),
            "attn2_out": _DenseSpec(d, d),
            "ln3": _AffineSpec(d),
            "ff_in": _DenseSpec(d, 8 * d),
            "ff_out": _DenseSpec(4 * d, d),
        }

    def transformer(d: int, depth: int) -> dict | None:
        if not depth:
            return None
        return {
            "norm": _AffineSpec(d),
            "proj_in": _DenseSpec(d, d),
            "blocks": [basic(d) for _ in range(depth)],
            "proj_out": _DenseSpec(d, d, scale=0.0),
        }

    widths = c.widths
    tree: dict = {
        "conv_in": _ConvSpec(3, c.channels, widths[0]),
        "t_mlp1": _DenseSpec(widths[0], c.time_dim),
        "t_mlp2": _DenseSpec(c.time_dim, c.time_dim),
        "norm_out": _AffineSpec(widths[0]),
        "conv_out": _ConvSpec(3, widths[0], c.channels, scale=0.0),
    }
    if c.pooled_dim:
        tree["add_mlp1"] = _DenseSpec(c.pooled_dim + c.time_ids * c.add_time_embed_dim, c.time_dim)
        tree["add_mlp2"] = _DenseSpec(c.time_dim, c.time_dim)
    tree["down"] = [
        {
            "resnets": [resnet(widths[max(i - 1, 0)] if j == 0 else w, w) for j in range(c.layers_per_block)],
            "attns": [transformer(w, c.transformer_layers[i]) for _ in range(c.layers_per_block)],
            "downsample": _ConvSpec(3, w, w) if i < c.levels - 1 else None,
        }
        for i, w in enumerate(widths)
    ]
    mid = widths[-1]
    tree["mid"] = {"res1": resnet(mid, mid), "attn": transformer(mid, c.resolved_mid_layers), "res2": resnet(mid, mid)}
    # skip-channel bookkeeping mirrors the down path exactly
    skip_widths = [widths[0]]
    for i, w in enumerate(widths):
        skip_widths += [w] * c.layers_per_block
        if i < c.levels - 1:
            skip_widths.append(w)
    tree["up"] = []
    for i in reversed(range(c.levels)):
        w = widths[i]
        prev = widths[min(i + 1, c.levels - 1)]
        resnets, attns = [], []
        for j in range(c.layers_per_block + 1):
            resnets.append(resnet((prev if j == 0 else w) + skip_widths.pop(), w))
            attns.append(transformer(w, c.transformer_layers[i]))
        tree["up"].append({"resnets": resnets, "attns": attns, "upsample": _ConvSpec(3, w, w) if i > 0 else None})
    return tree


class _CondEncoder(_TreeModule):
    """What the conditional UNet and its ControlNet share: the resnets, the
    Transformer2D stages, the time (and text_time) conditioning and the
    encoder (conv_in, the down path, the mid block), all read from a tree of
    :func:`_cond_unet_skeleton`'s leaves at the shape :attr:`_shape`."""

    @property
    def _shape(self) -> CondUNetConfig:
        return self.config

    # -- building blocks ------------------------------------------------------

    def _gn(self, x: torch.Tensor, p: Any, silu: bool = False) -> torch.Tensor:
        "Affine GroupNorm (eps 1e-5) + optional SiLU in one B8 pass: f32 statistics and affine, one rounding."
        return groupnorm_cl(x, self._shape.groups, fuse_silu=silu, eps=1e-5, scale=p.g, bias=p.b)

    def _resnet(self, p: dict, x: torch.Tensor, cond: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _conv(p["conv1"], self._gn(x, p["norm1"], silu=True), dtype)
        emb = _dense(p["temb"], cond, dtype)
        h = h + emb[:, None, None, :]
        h = _conv(p["conv2"], self._gn(h, p["norm2"], silu=True), dtype)
        skip = _conv(p["skip"], x, dtype) if p["skip"] is not None else x
        return skip + h

    def _mha(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
        "Multi-head attention on packed (B, N, H*d) projections; see :func:`attention_route`."
        B, N, D = q.shape
        d = D // heads
        route = attention_route(N, k.shape[1], heads, d)
        if route == "pairs":
            return flash_attention_pairs(q, k, v, heads)
        if route == "packed":
            # zero-padded heads: padded q/k lanes add zero logits and padded v lanes slice away, so the
            # result is exact; q's pre-scale (rounded to the compute dtype, as the reference's) cancels
            # the kernel's 1/sqrt(128)
            def pad_heads(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
                h = x.reshape(B, N, heads, d)
                if scale != 1.0:
                    h = h * torch.tensor(scale, dtype=h.dtype, device=h.device)
                return F.pad(h, (0, 128 - d)).reshape(B, N, heads * 128)

            out = flash_attention_packed(pad_heads(q, math.sqrt(128 / d)), pad_heads(k), pad_heads(v), heads)
            return out.reshape(B, N, heads, 128)[..., :d].reshape(B, N, D)

        def split(x: torch.Tensor) -> torch.Tensor:
            return x.reshape(B, -1, heads, d).transpose(1, 2)

        out = attention_reference(split(q), split(k), split(v))
        return out.transpose(1, 2).reshape(B, N, D)

    def _transformer(
        self, p: dict, x: torch.Tensor, context: torch.Tensor, heads: int, dtype: torch.dtype
    ) -> torch.Tensor:
        "Transformer2DModel: norm -> tokens -> K basic blocks -> back + residual (``heads / tp`` a rank)."
        heads //= getattr(self, "_tp", 1)
        B, H, W, C = x.shape
        tokens = self._gn(x, p["norm"]).view(B, H * W, C)
        h = _dense(p["proj_in"], tokens.to(dtype), dtype)
        for blk in p["blocks"]:
            qkv = _dense(blk["attn1_qkv"], _ln_affine(h, blk["ln1"]), dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            h = h + _dense(blk["attn1_out"], self._mha(q, k, v, heads), dtype)
            q = _dense(blk["attn2_q"], _ln_affine(h, blk["ln2"]), dtype)
            k, v = _dense(blk["attn2_kv"], context, dtype).chunk(2, dim=-1)
            h = h + _dense(blk["attn2_out"], self._mha(q, k, v, heads), dtype)
            gate, act = _dense(blk["ff_in"], _ln_affine(h, blk["ln3"]), dtype).chunk(2, dim=-1)
            # GEGLU uses the exact (erf) gelu, unlike the DiT family's tanh
            h = h + _dense(blk["ff_out"], gate * F.gelu(act), dtype)
        h = _dense(p["proj_out"], h, dtype)
        return x + h.view(B, H, W, C)

    # -- forward ----------------------------------------------------------------

    def _cond_vector(
        self,
        t: torch.Tensor,
        pooled: torch.Tensor | None,
        time_ids: torch.Tensor | None,
        batch: int,
        dtype: torch.dtype,
    ) -> torch.Tensor:
        "silu(time embedding [+ SDXL text_time added conditioning]): what every resnet's time injection reads."
        c = self._shape
        tree = self.tree
        if (pooled is not None) != bool(c.pooled_dim):
            raise ValueError("pooled= goes with CondUNetConfig(pooled_dim > 0), and is required there")
        if c.pooled_dim and time_ids is None:
            # SDXL was trained on this micro-conditioning: zeroing it would sample a degenerate 0x0 crop
            raise ValueError(
                "SDXL conditioning needs time_ids= (orig_h, orig_w, crop_top, crop_left, "
                "target_h, target_w): see SDXLStack.time_ids"
            )
        temb = _timestep_embedding(t, c.widths[0]).to(dtype)
        temb = _dense(tree["t_mlp2"], F.silu(_dense(tree["t_mlp1"], temb, dtype)), dtype)
        if c.pooled_dim:
            ids_emb = _timestep_embedding(time_ids.reshape(-1), c.add_time_embed_dim)
            add = torch.cat([pooled.float(), ids_emb.reshape(batch, -1)], dim=-1)
            temb = temb + _dense(tree["add_mlp2"], F.silu(_dense(tree["add_mlp1"], add.to(dtype), dtype)), dtype)
        return F.silu(temb)

    def _encode(
        self,
        h: torch.Tensor,
        cond: torch.Tensor,
        context: torch.Tensor,
        dtype: torch.dtype,
        embed: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """conv_in [+ ``embed``, a ControlNet's control embedding, before the
        first skip] -> down path -> mid; returns (mid output, skip stack)."""
        c = self._shape
        tree = self.tree
        h = _conv(tree["conv_in"], h, dtype)
        if embed is not None:
            h = h + embed
        skips = [h]
        for i, level in enumerate(tree["down"]):
            for res, attn in zip(level["resnets"], level["attns"]):
                h = self._resnet(res, h, cond, dtype)
                if attn is not None:
                    h = self._transformer(attn, h, context, c.heads[i], dtype)
                skips.append(h)
            if level["downsample"] is not None:
                h = _conv(level["downsample"], h, dtype, stride=2, pad=1)
                skips.append(h)
        mid = tree["mid"]
        h = self._resnet(mid["res1"], h, cond, dtype)
        if mid["attn"] is not None:
            h = self._transformer(mid["attn"], h, context, c.heads[-1], dtype)
        h = self._resnet(mid["res2"], h, cond, dtype)
        return h, skips


class CondUNet(_CondEncoder):
    """``CondUNet(config)(x, t, context[, pooled, time_ids, control])``:
    (B, C, H, W) latents, a (B,) or scalar timestep, (B, L, context_dim) text
    features [, (B, pooled_dim) pooled text, (B, time_ids) micro-conditioning]
    -> a prediction of the latents' shape and dtype.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with
    parameters in ``dtype`` (the norms' affines in float32) and the JAX
    package's initialisation drawn from ``generator``: zero ``conv2``,
    ``proj_out`` and ``conv_out``, so a fresh model outputs exactly 0;
    :meth:`reset_parameters` with ``noise`` draws random weights."""

    def __init__(
        self,
        config: CondUNetConfig = CondUNetConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
        mesh: Any = None,
    ) -> None:
        super().__init__()
        _check_shape(config)
        if mesh is not None and "tp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("CondUNet(mesh=...) needs a 'tp' mesh axis (tensor parallelism)")
        self.config = config
        self.mesh = mesh
        self._build(_cond_unet_skeleton(config), dtype, torch.device("meta"))
        self._tp = tensor_parallel.tp_size(mesh)
        if self._tp > 1:  # the transformer stages' layers cut over tp; convs, norms and embeddings whole
            for heads, layers in zip(config.heads, config.transformer_layers):
                if layers:
                    tensor_parallel.local_heads(heads, mesh)
            dense = ((path, leaf) for path, leaf in _walk(self.tree) if isinstance(leaf, nn.Linear))
            tensor_parallel.cut_on_meta(dense, self.param_spec(), mesh, self._tp_segments())
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)

    def _tp_segments(self) -> dict[str, tuple[int, ...]]:
        """Each transformer block's fused ``attn1_qkv`` ``[q | k | v]``, cross-attention ``attn2_kv``
        ``[k | v]`` and GEGLU ``ff_in`` ``[gate | act]``, each part split over ``tp`` alike."""
        parts = {"attn1_qkv": 3, "attn2_kv": 2, "ff_in": 2}
        return {
            path: (spec.d_out // parts[name],) * parts[name]
            for path, spec in _walk(self._skeleton)
            if (name := path.rpartition(".")[2]) in parts
        }

    def load_jax_params(self, tree: dict) -> CondUNet:
        """Fill the module from the JAX package's parameter tree (see ``_TreeModule.load_jax_params``);
        under ``tp`` each rank loads its shard of the transformer stages."""
        if self._tp > 1:
            tree = tensor_parallel.shard_params(tree, self.param_spec(), self.mesh, self._tp_segments())
        super().load_jax_params(tree)
        return self

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor | float,
        context: torch.Tensor,
        pooled: torch.Tensor | None = None,
        time_ids: torch.Tensor | None = None,
        control: tuple[list[torch.Tensor], torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """``control``: a ``(down_residuals, mid_residual)`` pair (NCHW), the
        published ControlNet injection points: each down residual adds to the
        matching skip entry, the mid residual after the mid block."""
        c = self.config
        dtype = c.compute_dtype
        B = x.shape[0]
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)
        cond = self._cond_vector(t, pooled, time_ids, B, dtype)
        context = context.to(dtype)

        h, skips = self._encode(_to_channels_last(x, dtype), cond, context, dtype)
        if control is not None:
            down_res, mid_res = control
            if len(down_res) != len(skips):
                raise ValueError(f"control carries {len(down_res)} down residuals, the UNet has {len(skips)} skips")
            skips = [s + _to_channels_last(r, s.dtype) for s, r in zip(skips, down_res)]
            h = h + _to_channels_last(mid_res, h.dtype)

        for idx, level in enumerate(self.tree["up"]):
            i = c.levels - 1 - idx
            for res, attn in zip(level["resnets"], level["attns"]):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = self._resnet(res, h, cond, dtype)
                if attn is not None:
                    h = self._transformer(attn, h, context, c.heads[i], dtype)
            if level["upsample"] is not None:
                h = _upsample_nearest(h, (2 * h.shape[1], 2 * h.shape[2]))
                h = _conv(level["upsample"], h, dtype)

        h = self._gn(h, self.tree["norm_out"], silu=True)
        h = _conv(self.tree["conv_out"], h, dtype)
        return _to_nchw(h, x.dtype)

    apply = forward

    def quantize_params(self, scope: str = "deep") -> CondUNet:
        """The int8 serving model, the JAX package's recipe: the dense layers
        of the chosen Transformer2D stages as per-channel int8 with dynamic
        per-row activation scales (kernel B6 in front of each product); the
        convolutions (4-D weights) are untouched and the conditioning
        pathway (``temb``, ``t_mlp1/2``, ``add_mlp1/2``) stays as it is: its
        output feeds every resnet's time injection.  Every other parameter is
        shared with this model.  Serving only: rounding has no gradient.

        * ``"deep"`` (the default): only the stages of at least 4 basic
          blocks (SDXL base: the 10-deep width-1280 down, mid and up stages,
          a long conv-free run holding most of the matmul work), the mid
          stage counted by its own depth; the conv-interleaved shallow stages
          stay 16-bit;
        * ``"all"``: every dense layer above the quantizer's size floor;
        * ``"none"``: this model itself, unquantized."""
        if scope == "none":
            return self
        if scope not in ("deep", "all"):
            raise ValueError(f"scope must be 'deep', 'all', or 'none', got {scope!r}")
        if self._tp > 1:
            raise ValueError("an int8 CondUNet is served unsharded: the JAX package gives it no quantized specs")
        c = self.config
        exclude = frozenset({"temb", "t_mlp1", "t_mlp2", "add_mlp1", "add_mlp2"})

        def entry(leaf: Any) -> dict | None:  # a dense layer as the quantizer's {"w", "b"} entry; convs and norms None
            return {"w": leaf.weight.detach().t(), "b": leaf.bias.detach()} if isinstance(leaf, nn.Linear) else None

        dense = _map(self.tree, entry)
        if scope == "all":
            chosen = dense
        else:
            threshold = 4
            deep = {i for i, depth in enumerate(c.transformer_layers) if depth >= threshold}
            mid_deep = c.resolved_mid_layers >= threshold
            chosen = {  # up level j is level len(widths) - 1 - j
                "down": [{"attns": lvl["attns"] if i in deep else None} for i, lvl in enumerate(dense["down"])],
                "mid": {"attn": dense["mid"]["attn"] if mid_deep else None},
                "up": [
                    {"attns": lvl["attns"] if c.levels - 1 - j in deep else None} for j, lvl in enumerate(dense["up"])
                ],
            }
        return _int8_leaves(self, quantize_params(chosen, exclude=exclude))

    def param_spec(self) -> dict:
        """The JAX package's specs over ``tp``: the transformer stages megatron-style (attn1_qkv,
        attn2_q, attn2_kv and ff_in column-parallel, attn1_out, attn2_out and ff_out row-parallel);
        convs, norms, the stages' proj_in/proj_out and the time embeddings replicated."""
        col, row, rep = tensor_parallel.dense_specs()
        P = tensor_parallel.P
        aff = {"g": P(), "b": P()}

        def resnet(has_skip: bool) -> dict:
            return {"norm1": dict(aff), "conv1": dict(rep), "temb": dict(rep), "norm2": dict(aff),
                    "conv2": dict(rep), "skip": dict(rep) if has_skip else None}

        def basic() -> dict:
            return {"ln1": dict(aff), "attn1_qkv": dict(col), "attn1_out": dict(row), "ln2": dict(aff),
                    "attn2_q": dict(col), "attn2_kv": dict(col), "attn2_out": dict(row), "ln3": dict(aff),
                    "ff_in": dict(col), "ff_out": dict(row)}

        def transformer(depth: int) -> dict:
            return {"norm": dict(aff), "proj_in": dict(rep), "blocks": [basic() for _ in range(depth)],
                    "proj_out": dict(rep)}

        c = self.config
        spec: dict = {"conv_in": dict(rep), "t_mlp1": dict(rep), "t_mlp2": dict(rep), "norm_out": dict(aff),
                      "conv_out": dict(rep)}
        if c.pooled_dim:
            spec["add_mlp1"] = dict(rep)
            spec["add_mlp2"] = dict(rep)
        spec["down"] = [
            {
                "resnets": [
                    resnet(j == 0 and c.widths[max(i - 1, 0)] != c.widths[i]) for j in range(c.layers_per_block)
                ],
                "attns": [
                    transformer(c.transformer_layers[i]) if c.transformer_layers[i] else None
                    for _ in range(c.layers_per_block)
                ],
                "downsample": dict(rep) if i < c.levels - 1 else None,
            }
            for i in range(c.levels)
        ]
        spec["mid"] = {
            "res1": resnet(False),
            "attn": transformer(c.resolved_mid_layers) if c.resolved_mid_layers else None,
            "res2": resnet(False),
        }
        spec["up"] = [
            {
                "resnets": [resnet(True) for _ in range(c.layers_per_block + 1)],
                "attns": [
                    transformer(c.transformer_layers[i]) if c.transformer_layers[i] else None
                    for _ in range(c.layers_per_block + 1)
                ],
                "upsample": dict(rep) if i > 0 else None,
            }
            for i in reversed(range(c.levels))
        ]
        return spec

    def as_sampleable(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor | None = None,
        time_ids: torch.Tensor | None = None,
        guidance_scale: float = 1.0,
        uncond_context: torch.Tensor | None = None,
        uncond_pooled: torch.Tensor | None = None,
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """Sampling closure.  ``guidance_scale != 1`` runs classifier-free
        guidance against ``uncond_context`` (the encoded empty prompt), both
        branches in one doubled-batch forward."""
        if guidance_scale == 1.0:

            def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
                B = x.shape[0]  # single-prompt conditioning serves any batch
                pool = None if pooled is None else per_item(pooled, B, 1)
                tid = None if time_ids is None else per_item(time_ids, B, 1)
                return self(x, t, per_item(context, B, 2), pool, tid)

            return model_fn

        if uncond_context is None or (pooled is not None and uncond_pooled is None):
            raise ValueError("guided sampling needs uncond_context= (and uncond_pooled= with SDXL)")

        def guided_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            B = x.shape[0]
            ctx = torch.cat([per_item(context, B, 2), per_item(uncond_context, B, 2)])
            pool = ids = None
            if pooled is not None:
                pool = torch.cat([per_item(pooled, B, 1), per_item(uncond_pooled, B, 1)])
                ids = torch.cat([per_item(time_ids, B, 1)] * 2)
            both = self(torch.cat([x, x]), doubled_t(t, B), ctx, pool, ids)
            return guided_mix(both[:B], both[B:], guidance_scale)

        return guided_fn


def _check_shape(c: CondUNetConfig) -> None:
    if not (len(c.transformer_layers) == len(c.heads) == c.levels):
        raise ValueError("widths / transformer_layers / heads must have equal lengths")
    for w, h, k in zip(c.widths, c.heads, c.transformer_layers):
        if k and w % h:
            raise ValueError(f"width {w} not divisible by heads {h}")


def _int8_leaves(model: _TreeModule, quantized: dict) -> _TreeModule:
    """A copy of ``model`` whose dense leaves that ``quantized`` (a
    :func:`~skrample_tpu_torch.ops.quant.quantize_params` tree at the same
    paths) holds as ``{"w_q", "b"}`` become :class:`~skrample_tpu_torch.ops.
    quant.Int8Dense`; every other parameter is shared with ``model``."""
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    clone = copy.deepcopy(model, shared)
    slot = {id(leaf): key for key, leaf in clone.leaves.items()}

    def swap(node: Any, tree: Any) -> None:
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, child in items:
            if isinstance(child, dict) and "w_q" in child:
                clone.leaves[slot[id(tree[key])]] = tree[key] = Int8Dense(child)
            elif isinstance(child, dict | list):
                swap(child, tree[key])

    swap(quantized, clone.tree)
    return clone


def random_param_tree(config: CondUNetConfig, seed: int) -> dict:
    """A JAX-layout CondUNet tree from a numpy seed: the standard
    initialisation plus ``0.02 * N(0, 1)`` on every leaf (the JAX tests'
    recipe, ``tests/test_sdxl_stack.py``; the zero-initialised output layers
    would otherwise make the prediction exactly 0)."""
    return _random_tree(_cond_unet_skeleton(config), seed)


def cond_unet_forward_flops(config: CondUNetConfig, batch: int, h: int, w: int, context_len: int) -> float:
    """FLOPs (2 per multiply-add) of one forward at a (h, w) latent: every
    convolution, dense layer (the conditioning MLPs included) and attention
    product, counted from shapes as the JAX package's
    ``scripts/bench_sdxl.py`` counts them by tracing."""
    c = config
    total = 0.0
    cross = context_len

    def conv(k: int, c_in: int, c_out: int, hw: int) -> float:
        return 2.0 * batch * hw * k * k * c_in * c_out

    def dense(d_in: int, d_out: int, rows: int) -> float:
        return 2.0 * batch * rows * d_in * d_out

    def transformer(d: int, depth: int, n: int) -> float:
        f = 2 * dense(d, d, n)  # proj_in, proj_out
        per_block = dense(d, 3 * d, n) + dense(d, d, n) + dense(d, d, n) + dense(c.context_dim, 2 * d, cross)
        per_block += dense(d, d, n) + dense(d, 8 * d, n) + dense(4 * d, d, n)
        per_block += 4.0 * batch * n * n * d + 4.0 * batch * n * cross * d  # self and cross attention products
        return f + depth * per_block

    def resnet(c_in: int, c_out: int, hw: int) -> float:
        f = conv(3, c_in, c_out, hw) + conv(3, c_out, c_out, hw) + dense(c.time_dim, c_out, 1)
        return f + (conv(1, c_in, c_out, hw) if c_in != c_out else 0.0)

    skel = _cond_unet_skeleton(c)
    hw = h * w
    total += dense(c.widths[0], c.time_dim, 1) + dense(c.time_dim, c.time_dim, 1)
    if c.pooled_dim:
        add_in = c.pooled_dim + c.time_ids * c.add_time_embed_dim
        total += dense(add_in, c.time_dim, 1) + dense(c.time_dim, c.time_dim, 1)
    total += conv(3, c.channels, c.widths[0], hw)
    for i, level in enumerate(skel["down"]):
        for res, attn in zip(level["resnets"], level["attns"]):
            total += resnet(res["conv1"].c_in, res["conv1"].c_out, hw)
            if attn is not None:
                total += transformer(c.widths[i], len(attn["blocks"]), hw)
        if level["downsample"] is not None:
            hw //= 4
            total += conv(3, c.widths[i], c.widths[i], hw)
    mid = skel["mid"]
    total += 2 * resnet(c.widths[-1], c.widths[-1], hw)
    if mid["attn"] is not None:
        total += transformer(c.widths[-1], len(mid["attn"]["blocks"]), hw)
    for idx, level in enumerate(skel["up"]):
        i = c.levels - 1 - idx
        for res, attn in zip(level["resnets"], level["attns"]):
            total += resnet(res["conv1"].c_in, res["conv1"].c_out, hw)
            if attn is not None:
                total += transformer(c.widths[i], len(attn["blocks"]), hw)
        if level["upsample"] is not None:
            hw *= 4
            total += conv(3, c.widths[i], c.widths[i], hw)
    total += conv(3, c.widths[0], c.channels, hw)
    return total
