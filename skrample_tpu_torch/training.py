"""Train the DiT with flow matching.

    python -m skrample_tpu_torch.training [--steps 100] [--batch 8] [--remat]
        [--checkpoint dit.npz] [--device cuda|cpu] [--graph]

The port's counterpart of the JAX package's
``examples/train_flow_matching.py``: the conditional flow-matching loss
(linear interpolant, velocity target: what ``FlowModel`` sampling expects),
grads through the fused adaLN and fused-qkv attention kernels and their
backward kernels, AdamW with optax's ``adamw(1e-4)`` settings, and an EMA
shadow of the parameters (what one serves from).  The data are a fixed set
of 64 random latents made on the device from a seeded generator, so the run
needs no dataset; batches, noise and timesteps come from a second seeded
generator.  Compute is bf16 on CUDA and f32 on the CPU, like the example.

``--checkpoint PATH`` loads the parameters from PATH when it exists and
saves them there at the end, in the JAX package's ``.npz`` format.
``--graph`` (CUDA only) runs each step as one CUDA graph
(:class:`GraphedTrainStep`, the counterpart of the example's jitted step):
AdamW keeps its step count on the device (``capturable=True``) and the EMA
decay comes from a device step counter.  The
example's mesh (``--dp/--tp/--fsdp``), orbax and resume, 8-bit AdamW,
host-loader and LoRA options are later slices of the port.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from collections.abc import Sequence

import torch

from .models.checkpoint import load_params, save_params
from .models.dit import DiT, DiTConfig
from .models.ema import ema_init, ema_update
from .ops._cuda import resolve_device
from .ops.graphs import CapturedGraph

DATASET_SIZE = 64
DATASET_SEED = 42  # the JAX example's PRNGKey(42) for its fixed image set


def flow_matching_loss(model: DiT, x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    "``mean((model(x_t, 1000 sigma) - (noise - x0))^2)`` with ``x_t = (1 - sigma) x0 + sigma noise``."
    s = sigma[:, None, None, None]
    xt = (1 - s) * x0 + s * noise
    pred = model(xt, sigma * 1000.0)
    return torch.mean((pred - (noise - x0)) ** 2)


def make_optimizer(model: DiT, capturable: bool = False) -> torch.optim.AdamW:
    """AdamW as optax's ``adamw(1e-4)``: betas (0.9, 0.999), eps 1e-8 outside
    the square root, decoupled weight decay 1e-4 on every parameter.
    PyTorch's own default decay is 1e-2, so every setting is spelled out.
    ``capturable=True`` keeps the step count on the device, which a CUDA
    graph of the step needs (CUDA parameters only)."""
    return torch.optim.AdamW(
        model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4, capturable=capturable
    )


def train_step(
    model: DiT,
    opt: torch.optim.Optimizer,
    ema: dict[str, torch.Tensor],
    x0: torch.Tensor,
    noise: torch.Tensor,
    sigma: torch.Tensor,
    step: int,
    ema_decay: float = 0.9999,
) -> torch.Tensor:
    """One step: loss and grads, the optimizer's update, then the EMA update
    at step index ``step``.  Returns the loss (detached, on the device: the
    host does not wait for it)."""
    opt.zero_grad(set_to_none=True)
    loss = flow_matching_loss(model, x0, noise, sigma)
    loss.backward()
    opt.step()
    ema_update(ema, model, decay=ema_decay, step=step)
    return loss.detach()


class GraphedTrainStep:
    """:func:`train_step` as one CUDA graph: loss and grads, the optimizer's
    update, the EMA update, and the step counter's increment.

    The first call is the capture's warm-up pass (a real step, run eagerly,
    which also builds AdamW's state) and then captures :meth:`body`; later
    calls copy the batch into the static inputs and replay.  The optimizer
    must be capturable (``make_optimizer(model, capturable=True)``); the
    gradients are set to None before the capture so the graph's backward
    allocates them in its own pool and every replay rewrites them in place;
    the EMA decay comes from :attr:`step`, a device counter (starting at
    ``step``), by :func:`~skrample_tpu_torch.models.ema.ema_decay_device`.
    The batch is drawn outside the graph (a device generator) and copied in.
    Returns the loss (the graph's own tensor: read or copy it before the next
    call)."""

    def __init__(
        self,
        model: DiT,
        opt: torch.optim.Optimizer,
        ema: dict[str, torch.Tensor],
        step: int = 0,
        ema_decay: float = 0.9999,
    ):
        self.model, self.opt, self.ema, self.ema_decay = model, opt, ema, ema_decay
        device = next(model.parameters()).device
        self.step = torch.tensor(step, dtype=torch.int64, device=device)
        self._graph: CapturedGraph | None = None

    def body(self, x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """One step, :func:`train_step` with the EMA step on the device: what the graph captures.  Clearing
        the gradients is host work (it drops them), so under capture the backward allocates them anew in
        the graph's pool."""
        self.opt.zero_grad(set_to_none=True)
        loss = flow_matching_loss(self.model, x0, noise, sigma)
        loss.backward()
        self.opt.step()
        ema_update(self.ema, self.model, decay=self.ema_decay, step=self.step)
        self.step += 1
        return loss.detach()

    def __call__(self, x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        if self._graph is None:
            static = (x0.clone(), noise.clone(), sigma.clone())
            self._graph = CapturedGraph(self.body, static, what="GraphedTrainStep")
            return self._graph.warmup_output
        return self._graph(x0, noise, sigma)


def synthetic_dataset(size: int, device: torch.device) -> torch.Tensor:
    "The fixed training set: 64 standard-normal ``(4, size, size)`` latents, made on the device."
    gen = torch.Generator(device=device).manual_seed(DATASET_SEED)
    return torch.randn((DATASET_SIZE, 4, size, size), generator=gen, device=device)


def draw_batch(
    data: torch.Tensor, batch: int, gen: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    "``(x0, noise, sigma)``: ``batch`` items of ``data`` drawn with replacement, N(0, 1) noise, sigma ~ U(1e-3, 1)."
    idx = torch.randint(0, data.shape[0], (batch,), generator=gen, device=data.device)
    x0 = data[idx]
    noise = torch.randn(x0.shape, generator=gen, device=data.device)
    sigma = 1e-3 + torch.rand((batch,), generator=gen, device=data.device) * (1.0 - 1e-3)
    return x0, noise, sigma


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skrample_tpu_torch.training", description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2, help="dim/heads must be 128 for the attention kernels")
    ap.add_argument("--size", type=int, default=16, help="latent H=W")
    ap.add_argument("--remat", action="store_true", help="recompute each block's activations in the backward")
    ap.add_argument("--ema-decay", type=float, default=0.9999)
    ap.add_argument("--checkpoint", type=str, default="", help="load from (when it exists) and save to this .npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--graph", action="store_true", help="run each step as one CUDA graph (CUDA only)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.graph and device.type != "cuda":
        ap.error("--graph captures CUDA graphs: it needs --device cuda")
    config = DiTConfig(
        dim=args.dim,
        depth=args.depth,
        heads=args.heads,
        compute_dtype=torch.float32 if device.type == "cpu" else torch.bfloat16,
        attention="flash",
        remat=args.remat,
    )
    model = DiT(config, device=device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        model.load_jax_params(load_params(args.checkpoint))
        print(f"resumed from {args.checkpoint}")
    opt = make_optimizer(model, capturable=args.graph)
    ema = ema_init(model)
    data = synthetic_dataset(args.size, device)
    gen = torch.Generator(device=device).manual_seed(1)
    graphed = GraphedTrainStep(model, opt, ema, ema_decay=args.ema_decay) if args.graph else None

    t0 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        x0, noise, sigma = draw_batch(data, args.batch, gen)
        if graphed is not None:
            losses.append(graphed(x0, noise, sigma).clone())
        else:
            losses.append(train_step(model, opt, ema, x0, noise, sigma, step, ema_decay=args.ema_decay))
    values = torch.stack(losses).tolist() if losses else []
    dt = time.perf_counter() - t0
    if values:
        print(f"{args.steps} steps in {dt:.2f}s ({dt / args.steps * 1e3:.2f} ms/step on {device}, first step included)")
        print(f"loss {values[0]:.4f} -> {values[-1]:.4f}")
        if not all(math.isfinite(v) for v in values):
            print("non-finite loss", file=sys.stderr)
            return 1
    if args.checkpoint:
        save_params(args.checkpoint, model.param_tree())
        print(f"saved {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
