"""Train the DiT with flow matching.

    python -m skrample_tpu_torch.training [--steps 100] [--batch 8] [--remat]
        [--checkpoint dit.npz] [--device cuda|cpu] [--graph] [--opt8] [--lora N]
        [--host-loader] [--orbax DIR [--resume] [--until N] [--save-every N]
        [--abort-after-step K]]
    torchrun --nproc-per-node N -m skrample_tpu_torch.training --dp D [--tp T] [--fsdp] [...]

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
the optimizer keeps its step count on the device (``capturable=True``) and
the EMA decay comes from a device step counter.

The example's other options:

* ``--host-loader``: the data set stays on the host and
  ``data.EpochLoader`` (key ``PRNGKey(7)``) with ``data.prefetch_to_device``
  feeds the card; each step draws what the JAX example draws from
  ``fold_in(PRNGKey(1), n)`` (``kb, kn, kt = split(key, 3)``: the noise
  ``normal(kn)``, sigma ``uniform(kt, 1e-3, 1)``) over the set
  ``normal(PRNGKey(42), (64, 4, size, size))``, through ``prng``: batch ``n``
  of a resumed run is batch ``n`` of an uninterrupted one;
* ``--opt8``: ``optim.AdamW8bit`` (int8 moments, ~2 bytes a parameter);
* ``--lora N``: rank-N adapters (``models.lora``, key ``PRNGKey(2)``) over
  the frozen base, merged inside the step (:class:`LoRAModel`);
* ``--orbax DIR``: the full train state (parameters, optimizer state, EMA,
  step) in a ``models.TrainCheckpointer`` directory, the port's own format
  (not orbax's); ``--resume`` continues its latest step (an existing
  checkpoint without ``--resume`` is an error), ``--until N`` trains to
  global step N, ``--save-every N`` saves every N steps and
  ``--abort-after-step K`` kills the process with SIGKILL after global step
  K, a save possibly mid-write (fault injection); these two need
  ``--host-loader`` and ``--orbax``.  Every option works with ``--graph``: a
  restore lands before the first call (the capture), the graph's step
  counter starts at the restored step, and ``--lora`` captures the merge.

``--dp N`` trains on N data-parallel ranks started by ``torchrun`` (``main``
initialises the group from its environment, NCCL on cards and gloo on the
CPU, and refuses a world of another size): every rank draws the whole
batch (the same generator or loader key on every rank) and takes its
``dp`` chunk, the gradients are averaged over ``dp`` before the update,
and the loss printed is the whole batch's mean.  ``--tp M`` cuts the DiT's
layers over a ``tp`` axis of M ranks (``torchrun`` starts ``dp * tp``;
``parallel/tensor_parallel.py``), and ``--fsdp`` (at ``--dp > 1``) shards
the parameters, optimizer moments and EMA over ``dp`` as the JAX example
lays them out (``fsdp_param_specs(..., min_size=1024)`` over the DiT's
megatron specs; ``parallel/fsdp.py``).  They compose with ``--opt8``,
``--lora``, ``--remat``, ``--orbax`` (each rank saves and restores its own
part of the train state, a step committed once every rank has written) and
``--graph`` (the step's collectives captured: NCCL, a card a rank).  A
committed step records its layout (:func:`train_layout`: ``dp``, ``tp``,
the FSDP parts, the optimizer's order), and ``--resume`` continues a step
of another ``--dp``/``--fsdp`` layout too: every rank's file is read, each
sharded leaf joined whole and cut for this run (:func:`relayout_state`, bit
for bit).  A change of ``--tp`` is refused.  A save never replaces a step
of another layout.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import math
import os
import signal
import sys
import time
from collections.abc import Sequence
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from . import parallel, prng
from .data import EpochLoader, prefetch_to_device
from .models import _tree
from .models.checkpoint import TrainCheckpointer, load_params, save_params
from .models.dit import DiT, DiTConfig
from .models.ema import ema_init, ema_update
from .models.lora import jax_leaves, lora_init, lora_leaves, lora_merge, lora_param_count, lora_to_numpy
from .ops._cuda import resolve_device
from .ops.graphs import CapturedGraph
from .optim import AdamW8bit, Moment8
from .parallel import fsdp, tensor_parallel

DATASET_SIZE = 64
DATASET_SEED = 42  # the JAX example's PRNGKey(42) for its fixed image set


def flow_matching_loss(model: DiT, x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    "``mean((model(x_t, 1000 sigma) - (noise - x0))^2)`` with ``x_t = (1 - sigma) x0 + sigma noise``."
    s = sigma[:, None, None, None]
    xt = (1 - s) * x0 + s * noise
    pred = model(xt, sigma * 1000.0)
    return torch.mean((pred - (noise - x0)) ** 2)


def make_optimizer(model: nn.Module, capturable: bool = False) -> torch.optim.AdamW:
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
    mesh: Any = None,
) -> torch.Tensor:
    """One step: loss and grads, the optimizer's update, then the EMA update
    at step index ``step``.  Returns the loss (detached, on the device: the
    host does not wait for it).  With ``mesh`` (a ``dp`` axis) the batch is
    the whole one: this rank takes its ``dp`` chunk, the gradients are
    averaged over ``dp`` and the loss returned is the whole batch's mean; a sequence-parallel model's
    gradients are summed over ``sp`` first.  A model cut over ``tp``
    runs its collectives itself; FSDP-sharded parameters (``parallel.fsdp``) are gathered in the
    forward and again for the backward, and their gradients reduce-scattered there."""
    opt.zero_grad(set_to_none=True)
    if mesh is not None:
        x0, noise, sigma = (parallel.shard_batch(mesh, a) for a in (x0, noise, sigma))
    sharded = any(fsdp.is_shard(p) for p in model.parameters())
    with fsdp.regather() if sharded else contextlib.nullcontext():
        loss = flow_matching_loss(model, x0, noise, sigma)
    loss.backward()
    if mesh is not None:
        trained = [p for p in model.parameters() if p.requires_grad]
        tensor_parallel.sum_partial_grads(trained, mesh)
        if parallel.batch_axis_of(mesh, "sp") is not None:  # a sequence-parallel model: each rank's tokens' share
            parallel.sum_grads(trained, mesh, "sp")
        parallel.average_grads(trained, mesh)
        loss = global_mean(loss.detach(), mesh)
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
    With ``mesh`` the graph captures the data-parallel step's collectives too
    (NCCL: a card a rank).
    Returns the loss (the graph's own tensor: read or copy it before the next
    call)."""

    def __init__(
        self,
        model: DiT,
        opt: torch.optim.Optimizer,
        ema: dict[str, torch.Tensor],
        step: int = 0,
        ema_decay: float = 0.9999,
        mesh: Any = None,
    ):
        self.model, self.opt, self.ema, self.ema_decay, self.mesh = model, opt, ema, ema_decay, mesh
        device = next(model.parameters()).device
        self.step = torch.tensor(step, dtype=torch.int64, device=device)
        self._graph: CapturedGraph | None = None

    def body(self, x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """One step, :func:`train_step` with the EMA step on the device: what the graph captures.  Clearing
        the gradients is host work (it drops them), so under capture the backward allocates them anew in
        the graph's pool."""
        loss = train_step(self.model, self.opt, self.ema, x0, noise, sigma, self.step, self.ema_decay, self.mesh)
        self.step += 1
        return loss

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


class LoRAModel(nn.Module):
    """A frozen base model with rank-r adapters merged in at every call: ``forward`` runs the base on
    ``lora_merge``'s weights through ``functional_call``.  The adapters are this module's parameters
    (in jax's flatten order of the adapter dict); the base is not a submodule, so ``parameters()``,
    an EMA shadow and an optimizer see the adapters alone."""

    def __init__(self, base: nn.Module, adapters: dict[str, dict[str, torch.Tensor]], scale: float = 1.0):
        super().__init__()
        object.__setattr__(self, "base", base.requires_grad_(False))
        self.scale = scale
        self.adapters = {path: {k: nn.Parameter(t.detach()) for k, t in ab.items()} for path, ab in adapters.items()}
        self.leaves = nn.ParameterList(lora_leaves(self.adapters))
        names = {leaf.path: leaf.name for leaf in jax_leaves(base)}
        for path, ab in self.adapters.items():  # over a cut base layer, each rank's gradient is a part
            if getattr(base.get_submodule(names[path].rpartition(".")[0]), "tp", None) is not None:
                for t in ab.values():
                    t.tp_partial = True

    def current_adapters(self) -> dict[str, dict[str, torch.Tensor]]:
        """The adapters as the step reads them: each read through :attr:`leaves` (whole where FSDP shards
        them), in the adapter dict's layout."""
        order = [(path, k) for path in sorted(self.adapters) for k in sorted(self.adapters[path])]
        current: dict[str, dict[str, torch.Tensor]] = {}
        for i, (path, k) in enumerate(order):
            current.setdefault(path, {})[k] = self.leaves[i]
        return current

    def forward(self, *args: Any, **kwargs: Any) -> torch.Tensor:
        "The base model's forward (its arguments as they are) on the merged weights."
        return functional_call(self.base, lora_merge(self.base, self.current_adapters(), self.scale), args, kwargs)


FSDP_MIN_SIZE = 1024  # the JAX example's fsdp_param_specs(..., min_size=1024)


def shard_for_fsdp(trained: nn.Module, model: DiT, mesh: Any) -> list[str]:
    """Shard ``trained``'s parameters over ``dp`` as the JAX example's ``--fsdp`` lays them out
    (``fsdp_param_specs(params, dp, base_specs=..., min_size=1024)``: the DiT's megatron specs as the
    base; a LoRA run's adapters on replicated bases); returns the names sharded."""
    _group, dp, _rank = parallel.axis_group(mesh, "dp")
    if isinstance(trained, LoRAModel):
        specs = {name: fsdp.fsdp_leaf_spec(tuple(p.shape), dp, min_size=FSDP_MIN_SIZE)
                 for name, p in trained.named_parameters()}
    else:
        base = model.param_spec()
        names = {id(p): name for name, p in model.named_parameters()}
        specs = {
            names[id(param)]: fsdp.fsdp_leaf_spec(
                tuple(param.shape[::-1]) if transposed else tuple(param.shape), dp,
                base=tensor_parallel.spec_at(base, path), min_size=FSDP_MIN_SIZE,
            )
            for path, param, transposed in _tree.leaves(model)
        }
    return fsdp.shard_module(trained, mesh, specs)


def whole_param_tree(model: DiT, mesh: Any) -> dict:
    """The model's JAX-layout tree, whole: its FSDP parts gathered over ``dp`` (each leaf read through
    its parametrization) and its ``tp`` shards over ``tp`` (collectives: every rank calls it)."""
    tree = model.param_tree()
    return tensor_parallel.gather_params(tree, model.param_spec(), mesh, model._tp_segments())


def host_loader_batch(
    batch: dict[str, torch.Tensor], n: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x0, noise, sigma)`` of global step ``n`` in ``--host-loader`` mode, as the JAX example draws
    them: ``key = fold_in(PRNGKey(1), n)``, ``kb, kn, kt = split(key, 3)``, the noise
    ``normal(kn, x0.shape)``, sigma ``uniform(kt, (batch,), 1e-3, 1.0)``; ``x0`` is the loader's."""
    x0 = batch["x0"]
    _kb, kn, kt = prng.split(prng.fold_in(prng.PRNGKey(1), n), 3)
    noise = prng.normal(kn, tuple(x0.shape), torch.float32, device=device)
    sigma = prng.uniform(kt, (x0.shape[0],), torch.float32, 1e-3, 1.0, device=device)
    return x0, noise, sigma


def host_dataset(size: int) -> torch.Tensor:
    "``--host-loader``'s set on the host: the JAX example's ``normal(PRNGKey(42), (64, 4, size, size))``."
    return prng.normal(prng.PRNGKey(DATASET_SEED), (DATASET_SIZE, 4, size, size), torch.float32, device="cpu")


def _train_state(trained: nn.Module, opt: torch.optim.Optimizer, ema: dict[str, torch.Tensor], step: int) -> dict:
    return {"params": dict(trained.named_parameters()), "opt_state": opt.state_dict(), "ema": ema, "step": step}


_PART = ".parametrizations."


def _whole_name(name: str) -> str:
    "A parameter's name with an FSDP part's ``parametrizations.<leaf>.original`` read as the leaf's own."
    return name.replace(_PART, ".").removesuffix(".original") if _PART in name else name


def train_layout(trained: nn.Module, opt: torch.optim.Optimizer, mesh: Any) -> dict:
    """How this rank's train state is cut, as the checkpoint records it: ``dp`` and ``tp``, the FSDP
    parts (``{whole parameter name: whole shape}``) and the optimizer's parameters in its order."""
    names = {id(p): name for name, p in trained.named_parameters()}
    return {
        "dp": parallel.axis_group(mesh, "dp")[1] if mesh is not None else 1,
        "tp": tensor_parallel.tp_size(mesh),
        "fsdp": {
            _whole_name(n): [int(d) for d in p.fsdp_shape] for n, p in trained.named_parameters() if fsdp.is_shard(p)
        },
        "order": [_whole_name(names[id(p)]) for group in opt.param_groups for p in group["params"]],
    }


def relayout_state(
    states: list[dict], saved: dict, live: dict, trained: nn.Module, opt: torch.optim.Optimizer, mesh: Any
) -> dict:
    """This rank's train state in the ``live`` layout from every rank's state of a step committed in the
    ``saved`` one (:func:`train_layout` both): each FSDP-sharded leaf (its parameter, EMA and optimizer
    state) joined whole from the ``dp`` ranks' parts in rank order, then cut for this rank's ``dp``
    index where the live layout shards it, each optimizer entry moved to its parameter's live index.
    ``tp`` stays: each rank reads the ranks of its own ``tp`` index.  Concatenations and slices only,
    so the state restored is bit for bit the one the ranks held."""
    if saved["tp"] != live["tp"]:
        raise ValueError(f"a train state committed at --tp {saved['tp']} resumes only at that --tp, not {live['tp']}")
    if sorted(saved["order"]) != sorted(live["order"]):
        raise ValueError("the committed train state holds other parameters than this run's model")
    tp, (dp, index) = live["tp"], (parallel.axis_group(mesh, "dp")[1:] if mesh is not None else (1, 0))
    tp_index = tensor_parallel.axis_rank(mesh) if tp > 1 else 0
    ranks = [states[d * tp + tp_index] for d in range(saved["dp"])]  # the saved mesh's (dp, 1, tp) order

    def convert(name: str, parts: list[Any], field: str = "") -> Any:
        """One leaf's tensor (or a plain value: the first rank's) from the saved ranks' parts; ``field``:
        the optimizer state's entry (the 8-bit moments' are kept by blocks)."""
        if not isinstance(parts[0], torch.Tensor):
            return parts[0]
        blocked = field in Moment8._fields
        whole = fsdp.join_parts(parts, tuple(saved["fsdp"][name]), blocked) if name in saved["fsdp"] else parts[0]
        return fsdp.cut_part(whole, dp, index, blocked) if name in live["fsdp"] else whole

    def by_name(key: str) -> dict[str, torch.Tensor]:
        return {_whole_name(n): [r[key][n] for r in ranks] for n in ranks[0][key]}

    params, ema = by_name("params"), by_name("ema")
    live_names = {_whole_name(n): n for n, _p in trained.named_parameters()}
    saved_opt = [r["opt_state"]["state"] for r in ranks]
    opt_state: dict = {}
    for key, value in saved_opt[0].items():
        if not isinstance(key, int):  # shared entries (AdamW8bit's count)
            opt_state[key] = value
            continue
        name = saved["order"][key]
        opt_state[live["order"].index(name)] = {
            field: convert(name, [s[key][field] for s in saved_opt], field) for field in value
        }
    return {
        "params": {live_names[n]: convert(n, parts) for n, parts in params.items()},
        "ema": {live_names[n]: convert(n, parts) for n, parts in ema.items()},
        "opt_state": {"state": opt_state, "param_groups": opt.state_dict()["param_groups"]},
        "step": ranks[0]["step"],
    }


def restore_train_state(
    ckpt: TrainCheckpointer, layout: dict, trained: nn.Module, opt: torch.optim.Optimizer, mesh: Any
) -> dict:
    """The latest committed step's train state for this rank in ``layout`` (:func:`train_layout`): its
    own file where the step was committed in this layout, else every rank's file cut for it
    (:func:`relayout_state`)."""
    step = ckpt.latest_step()
    saved = ckpt.layout(step)
    world = dist.get_world_size() if mesh is not None else 1
    if saved["world"] == world and ("order" not in saved or saved == {**layout, "world": world}):
        return ckpt.restore(step)
    if "order" not in saved:
        raise ValueError(f"step {step} in {ckpt.directory} records no train layout: only its own world resumes it")
    return relayout_state(ckpt.restore_ranks(step), saved, layout, trained, opt, mesh)


@torch.no_grad()
def _restore(state: dict, trained: nn.Module, opt: torch.optim.Optimizer, ema: dict[str, torch.Tensor]) -> int:
    "Copy a saved train state into the live tensors (those a later capture reads); returns its step."
    for name, p in trained.named_parameters():
        p.copy_(state["params"][name])
    opt.load_state_dict(state["opt_state"])
    for name, t in ema.items():
        t.copy_(state["ema"][name])
    return int(state["step"])


def global_mean(value: torch.Tensor, mesh: Any, axis: str = "dp") -> torch.Tensor:
    "The mean over mesh axis ``axis`` of each rank's ``value`` (a sum all-reduce of a copy, then a division)."
    group, size, _rank = parallel.axis_group(mesh, axis)
    total = value.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / size


def dist_requested() -> bool:
    "Started by ``torchrun`` (its environment names a world), or inside an initialised group."
    return "WORLD_SIZE" in os.environ or dist.is_initialized()


def data_parallel_world(
    dp: int, device: torch.device, ap: argparse.ArgumentParser, tp: int = 1
) -> tuple[Any, torch.device, bool]:
    """``(mesh, device, owned)`` for ``--dp`` (and ``--tp``): a ``make_mesh(dp=dp, sp=1,
    extra_axes={"tp": tp})`` over the process group (the ``tp`` axis only where ``tp > 1``),
    which this call initialises (``owned``) from ``torchrun``'s environment (NCCL with this rank's
    card, ``LOCAL_RANK``, on CUDA; gloo on the CPU) or, outside ``torchrun`` at ``dp = 1``, as a
    one-rank group over an in-process store; an initialised group is used as it is.  A world of
    another size than ``dp * tp`` is refused."""
    owned = False
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        options = {"device_id": device} if device.type == "cuda" else {}
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, **options)
        elif dp * tp == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **options)
        else:
            ap.error(f"--dp {dp} --tp {tp}: start {dp * tp} ranks with torchrun --nproc-per-node {dp * tp}")
        owned = True
    elif device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.get_world_size() != dp * tp:
        world = dist.get_world_size()
        if owned:
            dist.destroy_process_group()
        ap.error(f"--dp {dp} --tp {tp} needs a world of {dp * tp} ranks, got WORLD_SIZE={world}")
    return parallel.make_mesh(dp=dp, sp=1, extra_axes={"tp": tp} if tp > 1 else None), device, owned


def parser() -> argparse.ArgumentParser:
    "The trainer's command line."
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
    ap.add_argument(
        "--orbax", type=str, default="",
        help="TrainCheckpointer directory for the full train state (params + optimizer state + EMA + step); "
        "the port's own format, not orbax's",
    )
    ap.add_argument("--resume", action="store_true", help="continue the latest step in --orbax (required if it has one)")
    ap.add_argument("--until", type=int, default=0, help="train until global step N (overrides --steps)")
    ap.add_argument("--save-every", type=int, default=0, help="save the train state every N steps (needs --host-loader)")
    ap.add_argument(
        "--abort-after-step", type=int, default=-1,
        help="fault injection: SIGKILL this process after global step K (--host-loader, --orbax)",
    )
    ap.add_argument("--opt8", action="store_true", help="int8 block-quantized AdamW moments (optim.AdamW8bit)")
    ap.add_argument(
        "--host-loader", action="store_true",
        help="feed a host-resident set through data.EpochLoader + prefetch_to_device with the JAX example's draws",
    )
    ap.add_argument("--lora", type=int, default=0, help="train rank-N LoRA adapters over the frozen base")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks (run under torchrun with as many)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks: the DiT's layers cut over tp")
    ap.add_argument(
        "--fsdp", action="store_true",
        help="shard the parameters, optimizer moments and EMA over dp (ZeRO-3; needs --dp > 1)",
    )
    return ap


def main(argv: Sequence[str] | None = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.fsdp and args.dp < 2:
        ap.error("--fsdp shards over the dp axis; pass --dp > 1")
    device = resolve_device(args.device)
    if args.graph and device.type != "cuda":
        ap.error("--graph captures CUDA graphs: it needs --device cuda")
    mesh, owned = None, False
    if args.dp * args.tp > 1 or dist_requested():
        mesh, device, owned = data_parallel_world(args.dp, device, ap, tp=args.tp)
        if args.graph and dist.get_backend() != "nccl" and args.dp * args.tp > 1:
            if owned:
                dist.destroy_process_group()
            ap.error("--graph with more than one rank captures the collectives: it needs NCCL (a card a rank)")
    try:
        return _train(args, ap, device, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def build_trainer(
    args: argparse.Namespace, device: torch.device, mesh: Any
) -> tuple[DiT, nn.Module, torch.optim.Optimizer, dict[str, torch.Tensor]]:
    """``(model, trained, optimizer, EMA)`` as ``main``'s options set them up: the DiT (cut over ``tp``,
    loaded from ``--checkpoint``), its LoRA wrapper with ``--lora``, sharded over ``dp`` with
    ``--fsdp``, and AdamW or ``--opt8``'s AdamW8bit over what is trained."""
    tp_mesh = mesh if tensor_parallel.tp_size(mesh) > 1 else None
    config = DiTConfig(
        dim=args.dim,
        depth=args.depth,
        heads=args.heads,
        compute_dtype=torch.float32 if device.type == "cpu" else torch.bfloat16,
        attention="flash",
        remat=args.remat,
    )
    model = DiT(config, mesh=tp_mesh, device=device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        model.load_jax_params(load_params(args.checkpoint))
        print(f"resumed from {args.checkpoint}")
    trained: nn.Module = model
    if args.lora:
        trained = LoRAModel(model, lora_init(prng.PRNGKey(2), model, rank=args.lora))
        n_base = sum(p.numel() for p in model.parameters())
        n_ad = lora_param_count(trained.adapters)
        print(f"LoRA rank {args.lora}: training {n_ad} of {n_base} params ({n_ad / n_base:.2%})")
    if args.fsdp:
        shard_for_fsdp(trained, model, mesh)
        print(f"FSDP over dp={args.dp}: rank {dist.get_rank()} holds {fsdp.per_device_bytes(trained)} parameter bytes")
    if args.opt8:
        leaves = list(trained.parameters()) if args.lora else [leaf.tensor for leaf in jax_leaves(model)]
        opt: torch.optim.Optimizer = AdamW8bit(leaves, lr=1e-4, capturable=args.graph)
    else:
        opt = make_optimizer(trained, capturable=args.graph)
    return model, trained, opt, ema_init(trained)


def _train(args: argparse.Namespace, ap: argparse.ArgumentParser, device: torch.device, mesh: Any) -> int:
    "``main``'s run once the device (and the data-parallel mesh, if any) are set."
    main_rank = mesh is None or dist.get_rank() == 0
    model, trained, opt, ema = build_trainer(args, device, mesh)
    start_step = 0
    ckpt = TrainCheckpointer(args.orbax) if args.orbax else None
    layout = train_layout(trained, opt, mesh)
    if ckpt is not None and ckpt.latest_step() is not None:
        if not args.resume:
            ap.error(f"{args.orbax} already holds step {ckpt.latest_step()}: pass --resume to continue it")
        start_step = _restore(restore_train_state(ckpt, layout, trained, opt, mesh), trained, opt, ema)
        print(f"resumed from {args.orbax} at step {start_step}")
    elif args.resume:
        print(f"--resume: nothing committed in {args.orbax or '(no --orbax)'}, starting fresh")
    if args.until:
        if args.until < start_step:
            ap.error(f"--until {args.until} is before the restored step {start_step}")
        args.steps = args.until - start_step
    if (args.save_every or args.abort_after_step >= 0) and (not args.host_loader or ckpt is None):
        ap.error("--save-every/--abort-after-step need --host-loader and --orbax (per-step boundaries)")
    graphed = None
    if args.graph:
        graphed = GraphedTrainStep(trained, opt, ema, step=start_step, ema_decay=args.ema_decay, mesh=mesh)

    def step_once(x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor, n: int) -> torch.Tensor:
        if graphed is not None:
            return graphed(x0, noise, sigma).clone()
        return train_step(trained, opt, ema, x0, noise, sigma, n, ema_decay=args.ema_decay, mesh=mesh)

    t0 = time.perf_counter()
    losses = []
    end = start_step + args.steps
    if args.host_loader:
        loader = EpochLoader({"x0": host_dataset(args.size)}, args.batch, prng.PRNGKey(7))
        # iter_from(start_step): the O(1) resume cursor, batch n of a resumed run is batch n of an uninterrupted one
        batches = itertools.islice(prefetch_to_device(loader.iter_from(start_step), device=device), args.steps)
        for n, batch in enumerate(batches, start=start_step):
            losses.append(step_once(*host_loader_batch(batch, n, device), n))
            done = n + 1
            if args.save_every and done % args.save_every == 0 and done != end:
                ckpt.save(done, _train_state(trained, opt, ema, done), layout)
            if args.abort_after_step == n:
                # die like a preemption: join the last boundary save, start one more, SIGKILL with it likely
                # mid-write (the torn directory is never committed; resume sees the last complete step)
                ckpt.wait()
                if not args.save_every or done % args.save_every:
                    ckpt.save(done, _train_state(trained, opt, ema, done), layout)
                print(f"aborting after step {n} (fault injection)", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
    else:
        data = synthetic_dataset(args.size, device)
        gen = torch.Generator(device=device).manual_seed(1)
        for n in range(start_step, end):
            losses.append(step_once(*draw_batch(data, args.batch, gen), n))
    values = torch.stack(losses).tolist() if losses else []
    dt = time.perf_counter() - t0
    if values and main_rank:
        print(f"{args.steps} steps in {dt:.2f}s ({dt / args.steps * 1e3:.2f} ms/step on {device}, first step included)")
        print(f"loss {values[0]:.4f} -> {values[-1]:.4f}")
    if not all(math.isfinite(v) for v in values):
        print("non-finite loss", file=sys.stderr)
        return 1
    if args.checkpoint:  # every rank gathers its shards (collectives), the first writes
        tree = lora_to_numpy(trained.current_adapters()) if args.lora else whole_param_tree(model, mesh)
        if main_rank:
            save_params(args.checkpoint, tree)
            print(f"saved {args.checkpoint}")
    if ckpt is not None:
        if args.steps or ckpt.latest_step() != end:
            ckpt.save(end, _train_state(trained, opt, ema, end), layout)
        ckpt.close()
        print(f"saved step {end} -> {args.orbax} (params + optimizer state + EMA)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
