"""Train the text -> image stack jointly: TextEncoder + MMDiT, conditioned
flow matching with classifier-free-guidance dropout.

    python -m skrample_tpu_torch.train_text_to_image [--steps 60] [--batch 8] [--dim 128] [--size 16]
        [--cfg-dropout 0.1] [--device cuda|cpu]
    torchrun --nproc-per-node N -m skrample_tpu_torch.train_text_to_image --dp N

The port's counterpart of the JAX package's ``examples/train_text_to_image.py``:

* prompts go through :class:`~.models.text_encoder.ByteTokenizer` and the
  :class:`~.models.text_encoder.TextEncoder`, which trains jointly with the
  :class:`~.models.mmdit.MMDiT` (native wiring: the learned null context);
* a ``--cfg-dropout`` share of the batch rows drop their context to the
  MMDiT's null embedding, which is what makes guided serving meaningful;
* one optimizer over both models' parameters, optax's ``adamw(1e-4)``
  (:func:`~.training.make_optimizer`'s settings).

The data are hermetic, as the example's: the 32 :data:`PROMPTS` as byte ids
of 128 tokens, each owning a fixed random "image" latent
``normal(PRNGKey(42), (32, 4, size, size))``.  Step ``n`` draws from the
``n``-th of ``split(PRNGKey(2), steps)`` (the example's ``lax.scan`` over
its epoch) what the example's ``train_step`` draws (:func:`t2i_draws`),
bit for bit through :mod:`.prng`.  Compute is bf16 on the card and f32 on
the CPU, and the attention is ``"flash"`` on the card at head dim 64 or
128 (``"full"`` otherwise), the example's ``"full"`` on the CPU.

``--dp N`` runs N data-parallel ranks under ``torchrun`` (``main`` starts
the group from its environment and refuses a world of another size): every
rank draws the whole batch's randoms from the step key and takes its
chunk, the gradients are averaged over ``dp`` before the update, and the
loss printed is the whole batch's.  ``--tp M`` cuts both models' layers
over a ``tp`` axis of M ranks (``parallel/tensor_parallel.py``: each rank
runs ``heads / M`` heads; ``torchrun`` starts ``dp * tp`` ranks), the
example's ``(dp, tp)`` mesh: the ``tp`` ranks of a ``dp`` index see the
same chunk.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch
from torch import nn

from . import prng
from .models.mmdit import MMDiT, MMDiTConfig
from .models.text_encoder import ByteTokenizer, TextEncoder, TextEncoderConfig
from .ops._cuda import resolve_device
from .parallel import average_grads, shard_batch
from .training import data_parallel_world, dist_requested, global_mean, make_optimizer

__all__ = [
    "PROMPTS",
    "build_models",
    "hermetic_data",
    "main",
    "t2i_draws",
    "t2i_loss",
    "t2i_optimizer",
    "t2i_train_step",
]

PROMPTS = [
    f"a {style} of a {subject}"
    for style in ("photo", "painting", "sketch", "sculpture")
    for subject in ("cat", "fox", "city", "mountain", "river", "paper crane", "bowl of ramen", "robot")
]
TOKENS = 128  # the byte ids' length, the encoder's max_tokens and the MMDiT's context_tokens
IMAGE_SEED = 42  # the example's PRNGKey(42) for its fixed image latents
STEP_SEED = 2  # the example's PRNGKey(2), split into one key a step


def hermetic_data(
    size: int, channels: int = 4, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The example's paired data on ``device``: ``(len(PROMPTS), 128)`` int64 byte ids and the
    ``normal(PRNGKey(42), (len(PROMPTS), channels, size, size))`` float32 image latents."""
    device = resolve_device(device)
    ids = torch.from_numpy(ByteTokenizer().batch(PROMPTS, TOKENS).astype(np.int64)).to(device)
    images = prng.normal(prng.PRNGKey(IMAGE_SEED), (len(PROMPTS), channels, size, size), torch.float32, device)
    return ids, images


def t2i_draws(
    key: torch.Tensor,
    batch: int,
    size: int,
    cfg_dropout: float,
    channels: int = 4,
    prompts: int = len(PROMPTS),
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(idx, noise, sigma, drop)`` of one step, the example's ``train_step`` draws: ``kb, kn, kt,
    kd = split(key, 4)``, the prompt rows ``randint(kb, (batch,), 0, prompts)``, the noise
    ``normal(kn, (batch, channels, size, size))``, sigma ``uniform(kt, (batch,), 1e-3, 1)`` and the
    CFG-dropout rows ``bernoulli(kd, cfg_dropout, (batch,))``."""
    device = resolve_device(device)
    kb, kn, kt, kd = prng.split(key, 4)
    idx = prng.randint(kb, (batch,), 0, prompts, device).long()
    noise = prng.normal(kn, (batch, channels, size, size), torch.float32, device)
    sigma = prng.uniform(kt, (batch,), torch.float32, 1e-3, 1.0, device)
    drop = prng.bernoulli(kd, cfg_dropout, (batch,), device)
    return idx, noise, sigma, drop


def t2i_loss(
    enc: TextEncoder,
    mmdit: MMDiT,
    ids: torch.Tensor,
    images: torch.Tensor,
    idx: torch.Tensor,
    noise: torch.Tensor,
    sigma: torch.Tensor,
    drop: torch.Tensor,
) -> torch.Tensor:
    """The example's ``loss_fn``: the encoder's features of the drawn prompts through
    ``embed_context``, the null context on the ``drop`` rows, the linear interpolant ``x_t = (1 -
    sigma) x0 + sigma noise`` at ``t = 1000 sigma``, and the mean squared error against the
    velocity ``noise - x0``."""
    batch = idx.shape[0]
    feats = enc(ids[idx])
    ctx = mmdit.embed_context(feats, batch)
    null = mmdit.embed_context(None, batch)
    ctx = torch.where(drop[:, None, None], null, ctx)
    x0 = images[idx]
    s = sigma[:, None, None, None]
    xt = (1 - s) * x0 + s * noise
    pred = mmdit(xt, sigma * 1000.0, ctx)
    return torch.mean((pred - (noise - x0)) ** 2)


def t2i_optimizer(enc: TextEncoder, mmdit: MMDiT) -> torch.optim.AdamW:
    "One AdamW over both models' parameters, optax's ``adamw(1e-4)`` (:func:`~.training.make_optimizer`)."
    return make_optimizer(nn.ModuleList([enc, mmdit]))


def t2i_train_step(
    enc: TextEncoder,
    mmdit: MMDiT,
    opt: torch.optim.Optimizer,
    ids: torch.Tensor,
    images: torch.Tensor,
    draws: tuple[torch.Tensor, ...],
    mesh: Any = None,
) -> torch.Tensor:
    """One joint step on the whole batch's ``draws`` (:func:`t2i_draws`): loss and grads of both
    models, then the update.  A parameter the loss does not reach (the encoder's ``text_proj``)
    gets a zero gradient, as ``jax.value_and_grad`` gives it, so weight decay moves it as optax
    does.  With ``mesh`` (a ``dp`` axis) this rank takes its ``dp`` chunk of the draws, the
    gradients are averaged over ``dp`` and the returned loss is the whole batch's mean.  Returns the
    loss, detached, on the device."""
    params = [p for model in (enc, mmdit) for p in model.parameters()]
    if mesh is not None:
        draws = tuple(shard_batch(mesh, d) for d in draws)
    opt.zero_grad(set_to_none=True)
    loss = t2i_loss(enc, mmdit, ids, images, *draws)
    loss.backward()
    if mesh is not None:
        average_grads(params, mesh)
        loss = global_mean(loss.detach(), mesh)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    return loss.detach()


def build_models(dim: int, device: torch.device, mesh: Any = None) -> tuple[TextEncoder, MMDiT]:
    """The example's pair at width ``dim``: a 2-block encoder (2 heads, 128 tokens) and a 2-block
    MMDiT (2 heads, context width ``dim``), float32 masters, computing in bf16 on the card and f32
    on the CPU, the MMDiT's attention by the module docstring's rule; with ``mesh`` (a ``tp`` axis)
    both cut over ``tp``."""
    heads = 2
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    attention = "flash" if device.type == "cuda" and dim // heads in (64, 128) else "full"
    enc = TextEncoder(
        TextEncoderConfig(dim=dim, depth=2, heads=heads, max_tokens=TOKENS, compute_dtype=dtype),
        device=device,
        generator=torch.Generator().manual_seed(0),
        mesh=mesh,
    )
    mmdit = MMDiT(
        MMDiTConfig(
            dim=dim, depth=2, heads=heads, context_dim=dim, context_tokens=TOKENS, compute_dtype=dtype,
            attention=attention,
        ),
        mesh=mesh,
        device=device,
        generator=torch.Generator().manual_seed(1),
    )
    return enc, mmdit


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m skrample_tpu_torch.train_text_to_image", description=__doc__.split("\n\n")[0]
    )
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--size", type=int, default=16, help="latent H=W")
    ap.add_argument("--cfg-dropout", type=float, default=0.1)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks (run under torchrun with as many)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks: both models' layers cut over tp")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh, owned = None, False
    if args.dp * args.tp > 1 or dist_requested():
        mesh, device, owned = data_parallel_world(args.dp, device, ap, tp=args.tp)
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    try:
        enc, mmdit = build_models(args.dim, device, mesh if args.tp > 1 else None)
        opt = t2i_optimizer(enc, mmdit)
        ids, images = hermetic_data(args.size, device=device)
        keys = prng.split(prng.PRNGKey(STEP_SEED), args.steps)

        t0 = time.perf_counter()
        losses = []
        for key in keys:
            draws = t2i_draws(key, args.batch, args.size, args.cfg_dropout, device=device)
            losses.append(t2i_train_step(enc, mmdit, opt, ids, images, draws, mesh))
        values = np.asarray(torch.stack(losses).float().cpu())
        dt = time.perf_counter() - t0
    finally:
        if owned:
            torch.distributed.destroy_process_group()
    if main_rank:
        per_step = dt / args.steps * 1e3
        print(f"{args.steps} joint steps in {dt:.2f}s ({per_step:.2f} ms/step on {device}, first included)")
        k = max(1, args.steps // 4)
        first, last = float(values[:k].mean()), float(values[-k:].mean())
        print(f"loss (mean of {k}) {first:.4f} -> {last:.4f}")
    if not np.isfinite(values).all():
        print("non-finite loss", file=sys.stderr)
        return 1
    k = max(1, args.steps // 4)
    if not float(values[-k:].mean()) < float(values[:k].mean()):
        print("conditioned flow-matching loss should decrease", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
