"""Sequence parallelism for JOINT (two-stream) attention.

The MMDiT family concatenates image and text token streams into one joint
attention per block.  Both streams arrive here in the packed per-token
``[q | k | v]`` layout straight off each stream's fused qkv product, each
stream's token axis sharded over the mesh's ``sp`` axis: sharding the joint
axis instead would cut the stream boundary across ranks.  Each rank builds its
joint sequence from its two shards.  Two exact schemes, as the single-stream
ones:

* ``"ulysses"`` — all-to-alls scatter heads and gather tokens per stream; each
  rank concatenates the two full streams and runs B9 over the whole joint
  sequence for its H/S head shard; the inverse all-to-alls restore the token
  sharding.
* ``"ring"`` — each rank's local joint block is ``img_shard ++ txt_shard``
  and K/V blocks rotate as in ``ring_attention.py``.  The global key order is
  img_0, txt_0, img_1, txt_1, ...: a permutation of the joint sequence, which
  softmax attention does not see (its normaliser sums over every key), and
  each query's output stays at its own local position.  At FLUX.1-dev's
  4096 + 512 tokens over 4 ranks that block is 1152 rows: B11 masks the
  ragged tile.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention as fa
from .ring_attention import axis_group, ring_attention_local
from .ulysses import from_heads, to_heads


def joint_sp_attention(
    qkv_a: torch.Tensor,
    qkv_b: torch.Tensor,
    heads: int,
    mesh: DeviceMesh,
    axis: str = "sp",
    scheme: str = "ulysses",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact joint softmax attention over two token-sharded packed streams.

    ``qkv_a/qkv_b``: this rank's ``(B, n/S, 3*dim)`` shards of each stream's per-token packed
    projections, of one size on every rank (a stream's token count divides by the axis size:
    the caller that shards it checks that, as the DiT does); ``"ulysses"`` needs ``heads`` to
    divide by the axis size too.  Returns this rank's ``(B, n/S, dim)`` output shard of each
    stream."""
    if scheme not in ("ulysses", "ring"):
        raise ValueError(f"unknown scheme {scheme!r}")
    group, size, _rank = axis_group(mesh, axis)
    dim = qkv_a.shape[-1] // 3
    if dim % heads:
        raise ValueError(f"dim ({dim}) must divide by heads ({heads})")
    head_dim = dim // heads
    if scheme == "ulysses" and heads % size:
        raise ValueError(f"heads ({heads}) must divide the {axis!r} axis size ({size}) for ulysses")

    def split_heads(qkv_loc: torch.Tensor) -> list[torch.Tensor]:  # (B, n, 3*dim) -> three (B, H, n, d)
        B, n = qkv_loc.shape[:2]
        return [part.reshape(B, n, heads, head_dim).transpose(1, 2) for part in qkv_loc.chunk(3, dim=-1)]

    def merge_heads(o: torch.Tensor) -> torch.Tensor:  # (B, H, n, d) -> (B, n, dim)
        B, H, n, d = o.shape
        return o.transpose(1, 2).reshape(B, n, H * d)

    parts_a, parts_b = split_heads(qkv_a), split_heads(qkv_b)
    if scheme == "ulysses":  # each rank: its head shard of both whole streams
        parts_a = [to_heads(t, group, size) for t in parts_a]
        parts_b = [to_heads(t, group, size) for t in parts_b]
    n_a = parts_a[0].shape[2]
    joint = [torch.cat([a, b], dim=2) for a, b in zip(parts_a, parts_b)]
    if scheme == "ulysses":
        out = fa.flash_attention(*joint)
        oa, ob = from_heads(out[:, :, :n_a], group, size), from_heads(out[:, :, n_a:], group, size)
    else:  # ring over the local joint blocks (img_shard ++ txt_shard)
        out = ring_attention_local(*joint, group)
        oa, ob = out[:, :, :n_a], out[:, :, n_a:]
    return merge_heads(oa), merge_heads(ob)
