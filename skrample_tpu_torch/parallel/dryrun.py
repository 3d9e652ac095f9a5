"""Sequence-parallel dry run: S ranks, each a process, one ``torch.distributed`` group.

    python -m skrample_tpu_torch.parallel.dryrun --nproc 4                  # NCCL, one card a rank
    python -m skrample_tpu_torch.parallel.dryrun --nproc 4 --backend gloo   # CPU ranks

spawns S ranks that sample the same 8-step DPM++2M request through a small
random-weight DiT three times, with ``attention="flash"`` (no mesh),
``"ring"`` and ``"ulysses"`` over ``make_mesh(dp=1, sp=S)``, and prints
whether the two sequence-parallel samples equal the flash one (the port's
counterpart of the JAX package's ``_dryrun_ring_attention``).

:func:`run_sp` is the rank body, and :func:`spawn_sp` runs a list of cases
on S ranks and returns each rank's results; :func:`spawn_cli` runs the DiT
trainer's command line on S gloo ranks and returns their exit codes.  A case is a dict with a
``"kind"`` and numpy inputs:

* ``"ring"`` (``q, k, v, block_op``), ``"ulysses"`` (``q, k, v, heads_op``):
  the whole ``(B, H, N, d)`` arrays; each rank attends its token shard and
  returns its output shard;
* ``"joint_sp"`` (``qkv_a, qkv_b, heads, scheme``): two packed streams,
  sharded likewise;
* ``"dit"`` (``config, tree, x, t``, optionally ``mesh`` ``[dp, sp]``) and
  ``"sample"`` (``config, tree, x0, steps``): a DiT built from ``config`` (a
  dict of :class:`DiTConfig` fields, ``compute_dtype`` by name) and the
  JAX-layout ``tree``; on a ``dp`` x ``sp`` mesh each rank runs its ``dp``
  chunk of the batch and the chunks are gathered; every rank returns the
  whole output;
* ``"mmdit"`` (``config, tree, x, t, context``) and ``"video"`` (``config,
  tree, x, t``): a sequence-parallel MMDiT or VideoDiT over the ``(1,
  S)`` mesh; every rank returns the whole output;
* ``"serve"`` (``engine`` ``"batch"``/``"continuous"``, ``config, tree,
  seeds, steps``, ``buckets`` or ``slots``) and ``"pipeline"`` (``config,
  tree, shape, steps, seed``): data parallelism over a ``(S, 1)`` mesh,
  requests submitted on each rank at its own pace; every rank returns every
  request's (or the whole batch's) latent; a ``"serve"`` case with
  ``fault`` (a rank) makes that rank's model raise at its first call and
  generates its requests one at a time, each rank returning each request's
  latent or its error as ``"Type: message"``; ``"serve_abort"`` (``config, tree, seeds, steps,
  fault``): a ring DiT over ``(1, S)`` served by a mesh engine, its ring raising inside the first
  exchange on rank ``fault``; each rank returns its requests' outcomes, the wall time of the
  fault's injection (on the faulting rank; None elsewhere) and the wall time by which they were all
  resolved (ROADMAP C15);
* ``"tp"`` (``model``, ``config, tree``, the ``inputs`` it names, ``mesh`` ``[dp, sp, tp]``, optionally
  ``quantized`` and ``meshless``; a Flux with ``seed, noise`` in place of ``tree`` draws its weights by
  its own initialisation): one forward of a model (``"dit"``, ``"mmdit"``, ``"flux"``,
  ``"video"``, ``"clip"``, ``"t5"``, ``"unet"``) with its layers cut over ``tp``; every rank returns the
  whole output (with ``meshless``, beside the same model's output without a mesh) and ``"tp_sample"``
  (``config, tree, x0, context, steps, guidance, mesh``): an MMDiT's CFG sample on a ``dp`` x ``tp``
  mesh, gathered over ``dp``;
* ``"train_dit"`` (``config, tree, x0, noise, sigma``) and ``"train_t2i"``
  (``enc, mmdit`` configs, ``trees``, ``draws``): one data-parallel step at
  ``dp = S``; every rank returns the loss and its gradients by tree path;
  ``"train_cli"`` (``argv``): ``training.main(argv + ["--dp", S])`` inside the
  group; every rank returns its exit code and the last parameter file's
  tree when ``argv`` names one (rank 0 writes it);
* ``"train_fsdp"`` (``config, tree, draws, optimizer, lr, mesh``, ``fsdp``): the DiT's FSDP training steps
  on a ``dp`` x ``tp`` mesh (``fsdp=False``: the same mesh's replicated steps); every rank returns the losses, the whole parameters and its parameter bytes;
* ``"raises"`` (``what``): each rank returns the error the named misuse
  raises, as ``"Type: message"`` (``"heads"``, ``"tokens"``, ``"no_mesh"``,
  ``"dp"`` (a bucket ``dp`` does not divide), ``"slots"``,
  ``"stream_tokens"`` (an MMDiT stream ``sp`` does not divide),
  ``"flash_mesh"`` (a flash DiT given a mesh): ``ValueError``; ``"tp"``, a
  pipeline over a ``tp`` axis, ``"dp_graph"``, ``"dp_orbax"``, the DiT
  trainer's ``--dp`` with ``--graph`` or ``--orbax``);
* ``"pipe"`` (``mode``, ``mesh`` ``[dp, pp]``, the stages' inputs):
  ``pipeline_apply`` of dense-tanh stages, forward, pytree carry, gradient
  or pp x dp training step; ``"pp_dit"`` / ``"pp_mmdit"``: a model's
  ``apply_pipelined``; every rank returns the whole result;
* ``"grad"`` (``op``: ring, ulysses, joint_sp, reshard) and
  ``"grad_model"`` (a sequence-parallel DiT or MMDiT, or a pipelined DiT):
  outputs and input gradients, or a loss and its whole gradients;
* ``"moe"``: the MoE FFN over ``ep`` = the world beside the same call
  unsharded; ``"resume_layout"``: the DiT trainer at ``--dp`` = the world
  with ``--fsdp`` restored from a step another layout committed.

Nothing here starts a process or a group when the module is imported.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any

import numpy as np

TIMEOUT_S = 60


def _device(device: str, rank: int) -> Any:
    import torch

    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _dit(case: dict, mesh: Any, device: Any) -> Any:
    import torch

    from ..models.dit import DiT, DiTConfig

    fields = dict(case["config"])
    fields["compute_dtype"] = getattr(torch, fields.get("compute_dtype", "float32"))
    config = DiTConfig(**fields)
    sharding = config.attention in ("ring", "ulysses") or "tp" in (getattr(mesh, "mesh_dim_names", None) or ())
    model = DiT(config, mesh=mesh if sharding else None, device=device).load_jax_params(case["tree"])
    return model.requires_grad_(False)


def _dtype_fields(config: dict) -> dict:
    import torch

    return {**config, "compute_dtype": getattr(torch, config.get("compute_dtype", "float32"))}


def _stagger(rank: int, index: int) -> None:
    "Each rank submits at its own pace: rank r waits 4 ms x r before its requests 0 and 2."
    if index in (0, 2):
        time.sleep(0.004 * rank)


def _serve(case: dict, device: Any) -> list:
    """A ``"serve"`` case: every request's latent, as every rank's futures hold them."""
    import torch.distributed as dist

    from .. import scheduling
    from ..continuous import ContinuousServingEngine
    from ..sampling import models, structured
    from ..serving import ServingEngine
    from . import make_mesh

    tp = case.get("tp", 1)  # a DiT cut over tp under the dp engine: the tp ranks of a dp index see one chunk
    mesh = make_mesh(dp=dist.get_world_size() // tp, sp=1, extra_axes={"tp": tp} if tp > 1 else None)
    model_fn = _dit(case, mesh if tp > 1 else None, device).as_sampleable()
    rank = dist.get_rank()
    if case.get("fault") == rank:  # this rank's model raises at its first call
        calls = []
        inner = model_fn

        def model_fn(*args: Any) -> Any:
            calls.append(None)
            if len(calls) == 1:
                raise RuntimeError("injected fault")
            return inner(*args)

    common = {
        "item_shape": tuple(case["item"]),
        "sampler": structured.DPM(order=2, stochasticity=1.0),
        "schedule": scheduling.FlowShift(scheduling.Linear()),
        "model_transform": models.FlowModel(),
        "steps": case["steps"],
        "mesh": mesh,
        "device": device,
    }
    if case["engine"] == "batch":
        engine: Any = ServingEngine(model_fn, buckets=tuple(case["buckets"]), max_delay_ms=20.0, **common)
    else:
        engine = ContinuousServingEngine(model_fn, slots=case["slots"], **common)
    with engine:
        if "fault" in case:  # one request at a time: the first meets the fault
            return [_outcome(lambda: engine.generate(seed).float().cpu().numpy()) for seed in case["seeds"]]
        futures = []
        for index, seed in enumerate(case["seeds"]):
            _stagger(rank, index)
            futures.append(engine.submit(seed))
        return [f.result().float().cpu().numpy() for f in futures]


def _serve_abort(case: dict, device: Any) -> list:
    """A ``"serve_abort"`` case: a ring DiT over ``(1, S)`` behind a ``ServingEngine`` on that mesh, whose
    ring raises inside its first exchange on rank ``fault`` (the block fold after the hop's sends and
    receives are posted); every request is submitted at once, one a dispatch.  Returns each
    request's outcome (``"Type: message"``), the wall time (``time.time()``: one clock for the ranks
    of a host) at which the fault was injected on this rank (None on the others), and the wall time
    by which every future was resolved."""
    from unittest import mock

    import torch.distributed as dist

    from .. import scheduling
    from ..ops import flash_attention as fa
    from ..sampling import models, structured
    from ..serving import ServingEngine
    from . import make_mesh

    mesh = make_mesh(dp=1, sp=dist.get_world_size())
    model = _dit(case, mesh, device)
    fold = fa.flash_attention_block_stats
    injected: list[float] = []

    def faulty(*args: Any) -> Any:
        injected.append(time.time())
        raise RuntimeError("injected fault inside the ring")

    patch = mock.patch.object(fa, "flash_attention_block_stats", faulty if dist.get_rank() == case["fault"] else fold)
    engine = ServingEngine(
        model.as_sampleable(), tuple(case["item"]), sampler=structured.DPM(order=2),
        schedule=scheduling.FlowShift(scheduling.Linear()), model_transform=models.FlowModel(),
        steps=case["steps"], buckets=(1,), max_delay_ms=0.0, mesh=mesh, device=device,
    )
    with patch, engine:
        futures = [engine.submit(seed) for seed in case["seeds"]]
        outcomes = [_outcome(lambda f=f: f.result().float().cpu().numpy()) for f in futures]
        return [outcomes, injected[0] if injected else None, time.time()]


def _tp_model(case: dict, mesh: Any, device: Any) -> Any:
    """A ``"tp"`` case's model on ``mesh``, its weights from the case's JAX-layout tree (int8 with
    ``quantized``), and the call that runs it on the case's inputs (this rank's ``dp`` chunk)."""
    import torch

    from . import shard_batch

    name = case["model"]
    fields = _dtype_fields(case["config"])
    args = [torch.from_numpy(np.asarray(case[n])).to(device) for n in case["inputs"]]
    if mesh is not None:
        args = [shard_batch(mesh, a) for a in args]
    elif fields.get("attention") in ("ring", "ulysses"):  # the twin without a mesh: full attention
        fields["attention"] = "full"
    if name == "dit":
        from ..models.dit import DiT, DiTConfig

        model = DiT(DiTConfig(**fields), mesh=mesh, device=device).load_jax_params(case["tree"])
    elif name == "mmdit":
        from ..models.mmdit import MMDiT, MMDiTConfig

        model = MMDiT(MMDiTConfig(**fields), mesh=mesh, device=device).load_jax_params(case["tree"])
    elif name == "flux":
        from ..models.flux import Flux, FluxConfig

        if "seed" in case:  # each rank draws every layer whole from the seed and keeps its part
            gen = torch.Generator(device).manual_seed(case["seed"])
            model = Flux(FluxConfig(**fields), mesh=mesh, device=device, generator=gen)
            model.reset_parameters(gen, noise=case["noise"])
        else:
            model = Flux(FluxConfig(**fields), mesh=mesh, device=device).load_jax_params(case["tree"])
    elif name == "video":
        from ..models.video_dit import VideoDiT, VideoDiTConfig

        model = VideoDiT(VideoDiTConfig(**fields), mesh=mesh, device=device).load_jax_params(case["tree"])
    elif name == "clip":
        from ..models.text_encoder import TextEncoder, TextEncoderConfig

        model = TextEncoder(TextEncoderConfig(**fields), mesh=mesh, device=device)
        model.load_jax_params(case["tree"])
    elif name == "t5":
        from ..models.t5_encoder import T5Encoder, T5EncoderConfig

        model = T5Encoder(T5EncoderConfig(**fields), mesh=mesh, device=device)
        model.load_jax_params(case["tree"])
    elif name == "unet":
        from ..models.unet_cond import CondUNet, CondUNetConfig

        model = CondUNet(CondUNetConfig(**fields), mesh=mesh, device=device)
        model.load_jax_params(case["tree"])
    else:
        raise ValueError(f"unknown tp model {name!r}")
    model.requires_grad_(False)
    if case.get("quantized"):
        model = model.quantize_params()
    return model, args


def _tp(case: dict, device: Any) -> Any:
    """A ``"tp"`` case: the model on a ``(dp, sp, tp)`` mesh (``case["mesh"]``), each ``dp`` chunk's
    output gathered; every rank returns the whole output (with ``"meshless"``, also the same model's
    output without a mesh on the same rank, for a bit-for-bit comparison)."""
    import torch

    from . import gather, make_mesh

    dp, sp, tp = case["mesh"]
    mesh = make_mesh(dp=dp, sp=sp, extra_axes={"tp": tp})
    model, args = _tp_model(case, mesh, device)
    with torch.inference_mode():
        y = model(*args)
        out = gather(mesh, y, 0, "dp").float().cpu().numpy() if dp > 1 else y.float().cpu().numpy()
        if not case.get("meshless"):
            return out
        single, whole = _tp_model(case, None, device)
        return [out, single(*whole).float().cpu().numpy()]


def _tp_sample(case: dict, device: Any) -> Any:
    """A ``"tp_sample"`` case: an MMDiT on a ``(dp, sp, tp)`` mesh samples ``steps`` DPM++2M steps with
    classifier-free guidance (``guidance``) from its ``dp`` chunk of ``x0`` and of the per-item context;
    every rank returns the whole batch's latent (gathered over ``dp``)."""
    import torch

    from .. import scheduling
    from ..models.mmdit import MMDiT, MMDiTConfig
    from ..ops import CompiledDenoiser, compile_sampler
    from ..sampling import models, structured
    from . import gather, make_mesh, shard_batch

    dp, sp, tp = case["mesh"]
    mesh = make_mesh(dp=dp, sp=sp, extra_axes={"tp": tp})
    model = MMDiT(MMDiTConfig(**_dtype_fields(case["config"])), mesh=mesh, device=device)
    model.load_jax_params(case["tree"]).requires_grad_(False)
    x0, context = (shard_batch(mesh, torch.from_numpy(case[n]).to(device)) for n in ("x0", "context"))
    compiled = compile_sampler(
        structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), case["steps"]
    )
    with torch.inference_mode():
        out = CompiledDenoiser.build(compiled, device=device).run(model.as_sampleable(context, case["guidance"]), x0)
        return gather(mesh, out, 0, "dp").float().cpu().numpy()


def _train_fsdp(case: dict, device: Any) -> list:
    """A ``"train_fsdp"`` case: the DiT on a ``(dp, 1, tp)`` mesh, its parameters, moments and EMA sharded
    over ``dp`` (``training.shard_for_fsdp``: the JAX example's ``min_size=1024`` over the megatron
    specs), ``len(draws)`` steps of ``optimizer`` (``"adamw"``: AdamW at optax's ``adamw(lr)`` settings;
    ``"adamw8bit"``) on the given ``(x0, noise, sigma)`` draws; every rank returns the losses, the
    whole parameter tree by path and its parameter bytes."""
    import torch

    from ..models import _tree
    from ..models.dit import DiT, DiTConfig
    from ..models.ema import ema_init
    from ..models.lora import jax_leaves
    from ..optim import AdamW8bit
    from ..training import shard_for_fsdp, train_step, whole_param_tree
    from . import fsdp, make_mesh

    dp, _sp, tp = case["mesh"]
    mesh = make_mesh(dp=dp, sp=1, extra_axes={"tp": tp})
    model = DiT(DiTConfig(**_dtype_fields(case["config"])), mesh=mesh, device=device).load_jax_params(case["tree"])
    if case.get("fsdp", True):  # without: the same mesh's replicated run
        shard_for_fsdp(model, model, mesh)
    lr = case["lr"]
    if case["optimizer"] == "adamw8bit":
        opt: Any = AdamW8bit([leaf.tensor for leaf in jax_leaves(model)], lr=lr)
    else:
        opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    ema = ema_init(model)
    losses = []
    for step, draw in enumerate(case["draws"]):
        x0, noise, sigma = (torch.from_numpy(a).to(device) for a in draw)
        losses.append(float(train_step(model, opt, ema, x0, noise, sigma, step, mesh=mesh)))
    return [losses, dict(_tree._flatten(whole_param_tree(model, mesh))), fsdp.per_device_bytes(model)]


def _outcome(call: Any) -> Any:
    "``call()``, or the error it raised as ``\"Type: message\"``."
    try:
        return call()
    except Exception as err:
        return f"{type(err).__name__}: {err}"


def _pipeline(case: dict, device: Any) -> Any:
    import torch.distributed as dist

    from ..pipeline import GenerationPipeline
    from .. import scheduling
    from ..sampling import models, structured
    from . import make_mesh

    model = _dit(case, None, device)
    pipe = GenerationPipeline(
        model.as_sampleable(),
        structured.DPM(order=2, stochasticity=1.0),
        scheduling.FlowShift(scheduling.Linear()),
        models.FlowModel(),
        case["steps"],
        tuple(case["shape"]),
        mesh=make_mesh(dp=dist.get_world_size(), sp=1),
        device=device,
    )
    return pipe.generate(case["seed"]).float().cpu().numpy()


def _grads(leaves: Any) -> dict:
    "``{tree path: gradient in the JAX layout}`` from ``(path, parameter, transposed)`` leaves."
    import numpy as np

    out = {}
    for path, param, transposed in leaves:
        g = np.zeros(tuple(param.shape), np.float32) if param.grad is None else param.grad.float().cpu().numpy()
        out[path] = np.ascontiguousarray(g.T) if transposed else g
    return out


def _train(case: dict, device: Any) -> list:
    """A ``"train_dit"`` or ``"train_t2i"`` case at ``dp`` = the world: ``[loss, grads by path]``."""
    import torch
    import torch.distributed as dist

    from ..models import _tree
    from . import make_mesh

    tp = case.get("tp", 1)  # the models cut over tp, dp = world / tp
    mesh = make_mesh(dp=dist.get_world_size() // tp, sp=1, extra_axes={"tp": tp} if tp > 1 else None)
    if case["kind"] == "train_dit":
        from ..models.ema import ema_init
        from ..training import make_optimizer, train_step

        model = _dit(case, mesh if tp > 1 else None, device).requires_grad_(True)
        opt = make_optimizer(model)
        x0, noise, sigma = (torch.from_numpy(case[n]).to(device) for n in ("x0", "noise", "sigma"))
        loss = train_step(model, opt, ema_init(model), x0, noise, sigma, 0, mesh=mesh)
        leaves = [
            (f"{name}.{leaf}", getattr(layer, attr), leaf == "w")
            for name, layer in model._layers()
            for leaf, attr in (("w", "weight"), ("b", "bias"))
        ]
        return [float(loss), _whole_grads(_grads(leaves), model, mesh)]
    from ..models.mmdit import MMDiT, MMDiTConfig
    from ..models.text_encoder import TextEncoder, TextEncoderConfig
    from ..train_text_to_image import hermetic_data, t2i_optimizer, t2i_train_step

    cut = mesh if tp > 1 else None
    enc = TextEncoder(TextEncoderConfig(**_dtype_fields(case["enc"])), device=device, mesh=cut)
    mmdit = MMDiT(MMDiTConfig(**_dtype_fields(case["mmdit"])), mesh=cut, device=device)
    enc.load_jax_params(case["trees"]["enc"])
    mmdit.load_jax_params(case["trees"]["mmdit"])
    ids, images = hermetic_data(case["size"], device=device)
    draws = tuple(torch.from_numpy(a).to(device) for a in case["draws"])
    loss = t2i_train_step(enc, mmdit, t2i_optimizer(enc, mmdit), ids, images, draws, mesh)
    grads = {name: _whole_grads(_grads(_tree.leaves(m)), m, mesh) for name, m in (("enc", enc), ("mmdit", mmdit))}
    return [float(loss), grads]


def _whole_grads(grads: dict, model: Any, mesh: Any) -> dict:
    "Gradients by tree path, each ``tp``-cut one gathered whole (``tensor_parallel.gather_params``)."
    from ..models import _tree
    from . import tensor_parallel

    if tensor_parallel.tp_size(mesh) == 1:
        return grads
    tree: dict = {}
    for path, g in grads.items():
        _tree._put(tree, path.split("."), g)
    whole = tensor_parallel.gather_params(tree, model.param_spec(), mesh, model._tp_segments())
    return dict(_tree._flatten(whole))


def _train_cli(case: dict) -> list:
    """A ``"train_cli"`` case: ``[exit code, {path: array}]`` of the DiT trainer's CLI at ``--dp`` = the
    world, the parameter file read back after every rank has finished."""
    import torch.distributed as dist

    from ..models.checkpoint import load_params
    from ..models import _tree
    from ..training import main

    tp = case.get("tp", 1)
    argv = [*case["argv"], "--dp", str(dist.get_world_size() // tp), "--tp", str(tp)]
    rc = main(argv)
    dist.barrier()
    path = argv[argv.index("--checkpoint") + 1] if "--checkpoint" in argv else None
    return [rc, dict(_tree._flatten(load_params(path))) if path else {}]


def _pipe(case: dict, device: Any) -> list:
    """A ``"pipe"`` case: a dense-tanh stage a rank over ``pp`` (``(dp, pp)`` = ``case["mesh"]``).
    ``mode``: ``"forward"`` returns the outputs; ``"carry"`` runs the ``(x, cond)`` pytree carry with
    ``stack_stages`` and returns both outputs and both inputs' gradients of ``sum(x) + 2 sum(cond)``;
    ``"grad"`` and ``"train"`` return the mean square loss against ``target`` and the whole
    gradients of ``w`` and ``b`` (summed over ``pp``; at ``dp`` > 1 each rank runs its chunk of the
    items, the gradients averaged over ``dp``: the training step)."""
    import torch

    from . import average_grads, gather, make_mesh, shard_batch
    from .pipeline_stages import pipeline_apply, stack_stages
    from .ring_attention import axis_group

    dp, pp = case["mesh"]
    mesh = make_mesh(dp=dp, sp=1, extra_axes={"pp": pp})
    tensor = lambda name: torch.from_numpy(np.ascontiguousarray(case[name])).to(device)  # noqa: E731
    if case["mode"] == "carry":
        staged = stack_stages([{"w": torch.from_numpy(w).to(device)} for w in case["blocks"]], pp)
        xs, conds = (tensor(n).requires_grad_() for n in ("xs", "conds"))

        def carried(local: dict, carry: tuple) -> tuple:
            x, cond = carry
            return torch.tanh(x @ local["w"][0] + cond), cond

        out, cond_out = pipeline_apply(carried, staged, (xs, conds), mesh)
        (out.sum() + 2 * cond_out.sum()).backward()
        return [t.detach().cpu().numpy() for t in (out, cond_out, xs.grad, conds.grad)]
    w, b = (tensor(n).requires_grad_(case["mode"] != "forward") for n in ("w", "b"))
    mbs, target = tensor("mbs"), tensor("target") if "target" in case else None
    if dp > 1:  # this rank's items of every microbatch (dim 1)
        mbs, target = (shard_batch(mesh, a.transpose(0, 1)).transpose(0, 1) for a in (mbs, target))

    def dense(local: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ local["w"] + local["b"])

    out = pipeline_apply(dense, {"w": w, "b": b}, mbs, mesh, batch_axis="dp" if dp > 1 else None)
    if case["mode"] == "forward":
        return [out.detach().cpu().numpy()]
    loss = torch.mean((out - target) ** 2)
    loss.backward()
    if dp > 1:
        average_grads([w, b], mesh, "dp")
        loss = gather(mesh, loss.detach()[None], 0, "dp").mean()
    group, _size, _rank = axis_group(mesh, "pp")
    grads = [w.grad, b.grad]
    for g in grads:  # each stage rank holds its own stage's slice
        torch.distributed.all_reduce(g, group=group)
    return [float(loss.detach()), *(g.cpu().numpy() for g in grads)]


def _pipelined_model(case: dict, device: Any) -> Any:
    """A ``"pp_dit"`` or ``"pp_mmdit"`` case: the model's ``apply_pipelined`` over ``(dp, pp)`` =
    ``case["mesh"]`` in microbatches of ``microbatch``, each rank on its ``dp`` chunk, gathered:
    every rank returns the whole output."""
    import torch

    from . import gather, make_mesh, shard_batch

    dp, pp = case["mesh"]
    mesh = make_mesh(dp=dp, sp=1, extra_axes={"pp": pp})
    x, t = (shard_batch(mesh, torch.from_numpy(case[n]).to(device)) for n in ("x", "t"))
    axis = "dp" if dp > 1 else None
    with torch.inference_mode():
        if case["kind"] == "pp_dit":
            model = _dit(case, None, device)
            y = model.apply_pipelined(x, t, mesh, case["microbatch"], batch_axis=axis)
        else:
            from ..models.mmdit import MMDiT, MMDiTConfig

            model = MMDiT(MMDiTConfig(**_dtype_fields(case["config"])), device=device).load_jax_params(case["tree"])
            ctx = shard_batch(mesh, torch.from_numpy(case["context"]).to(device))
            y = model.apply_pipelined(x, t, mesh, case["microbatch"], context=ctx, batch_axis=axis)
        return (gather(mesh, y, 0, "dp") if dp > 1 else y).float().cpu().numpy()


def _grad_attention(case: dict, mesh: Any, device: Any) -> list:
    """A ``"grad"`` case of the raw attentions (``op``: ``"ring"``/``"ulysses"`` with ``block_op`` or
    ``heads_op``, ``"joint_sp"`` with ``scheme``, ``"reshard"``): this rank's shards of the inputs
    as leaves, ``sum(out * cotangent)`` backward; returns this rank's output shards and its inputs'
    gradient shards."""
    import torch

    from . import joint_sp_attention, ring_attention, shard_batch, ulysses_attention
    from .ring_attention import axis_group
    from .ulysses import reshard

    def shard(name: str, dim: int) -> torch.Tensor:
        whole = torch.from_numpy(np.ascontiguousarray(case[name])).to(device)
        return shard_batch(mesh, whole, spatial_axis=dim).clone()

    op = case["op"]
    if op == "reshard":  # (B, n, m): tokens over sp on dim 1 in, on dim 2 out
        group, size, _rank = axis_group(mesh, "sp")
        x = shard("x", 1).requires_grad_()
        outs = [reshard(x, group, size, 2, 1)]
        inputs, cotangents = [x], [shard("w", 2)]
    elif op == "joint_sp":
        inputs = [shard(n, 1).requires_grad_() for n in ("qkv_a", "qkv_b")]
        outs = list(joint_sp_attention(*inputs, case["heads"], mesh, scheme=case["scheme"]))
        cotangents = [shard(n, 1) for n in ("w_a", "w_b")]
    else:
        inputs = [shard(n, 2).requires_grad_() for n in ("q", "k", "v")]
        if op == "ring":
            outs = [ring_attention(*inputs, mesh, block_op=case["block_op"])]
        else:
            outs = [ulysses_attention(*inputs, mesh, heads_op=case["heads_op"])]
        cotangents = [shard("w", 2)]
    sum((o * w).sum() for o, w in zip(outs, cotangents)).backward()
    return [[o.detach().cpu().numpy() for o in outs], [t.grad.cpu().numpy() for t in inputs]]


def _grad_model(case: dict, mesh: Any, device: Any) -> list:
    """A ``"grad_model"`` case: the loss ``mean((model(x, t[, context]) - target)^2)`` of a
    sequence-parallel MMDiT over ``(1, S)`` (``attention`` ring or ulysses), or of a DiT's
    ``apply_pipelined`` over ``pp`` = S (``pp``), and every whole gradient by tree path: the
    sequence-parallel ranks' shares summed over ``sp``, a stage's block gradients summed over ``pp``
    (each rank holds its own stage's).  A sequence-parallel DiT takes one ``training.train_step`` on
    ``mesh`` (the case's ``(dp, sp)`` where given) on the case's ``x0``, ``noise`` and ``sigma`` (its
    ``x``, ``t`` and ``target`` are the step's ``x_t``, ``1000 sigma`` and ``noise - x0``): the step's
    loss and the gradients it leaves, summed over ``sp`` and averaged over ``dp`` by the step."""
    import torch

    from ..models import _tree
    from . import make_mesh, sum_grads
    from .ring_attention import axis_group

    fields = _dtype_fields(case["config"])
    x, t, target = (torch.from_numpy(case[n]).to(device) for n in ("x", "t", "target"))
    if case["model"] == "mmdit":
        from ..models.mmdit import MMDiT, MMDiTConfig

        model = MMDiT(MMDiTConfig(**fields), mesh=mesh, device=device).load_jax_params(case["tree"])
        loss = torch.mean((model(x, t, torch.from_numpy(case["context"]).to(device)) - target) ** 2)
    elif case.get("pp"):
        from ..models.dit import DiT, DiTConfig

        pp_mesh = make_mesh(dp=1, sp=1, extra_axes={"pp": case["pp"]})
        model = DiT(DiTConfig(**fields), device=device).load_jax_params(case["tree"])
        loss = torch.mean((model.apply_pipelined(x, t, pp_mesh, case["microbatch"]) - target) ** 2)
    else:
        from ..models.dit import DiT, DiTConfig
        from ..models.ema import ema_init
        from ..training import make_optimizer, train_step

        step_mesh = make_mesh(*case["mesh"]) if "mesh" in case else mesh
        model = DiT(DiTConfig(**fields), mesh=step_mesh, device=device).load_jax_params(case["tree"])
        x0, noise, sigma = (torch.from_numpy(case[n]).to(device) for n in ("x0", "noise", "sigma"))
        loss = train_step(model, make_optimizer(model), ema_init(model), x0, noise, sigma, 0, mesh=step_mesh)
        return [float(loss), _grads(_tree.leaves(model))]  # the optimizer leaves the step's gradients
    loss.backward()
    leaves = list(_tree.leaves(model))
    if case.get("pp"):
        group, _size, _rank = axis_group(pp_mesh, "pp")
        for path, param, _transposed in leaves:
            if path.startswith("blocks."):
                if param.grad is None:
                    param.grad = torch.zeros_like(param)
                torch.distributed.all_reduce(param.grad, group=group)
    else:
        sum_grads([param for _path, param, _transposed in leaves], mesh, "sp")
    return [float(loss.detach()), _grads(leaves)]


def _moe(case: dict, mesh: Any, device: Any) -> list:
    """A ``"moe"`` case: the MoE FFN (``method``: ``"dense"``, or capacity dispatch by ``"gather"`` /
    ``"onehot"`` at ``capacity``) with the experts split over the world as an ``ep`` axis, and the
    same call on the whole tree in this rank alone: ``[sharded, single]``."""
    import torch

    from . import make_mesh
    from .experts import moe_ffn, moe_ffn_capacity, shard_experts

    ep_mesh = make_mesh(dp=1, sp=1, extra_axes={"ep": mesh.size()})
    whole = {k: torch.from_numpy(v).to(device) for k, v in case["params"].items()}
    tokens = torch.from_numpy(case["tokens"]).to(device)

    def run(params: dict, on: Any) -> np.ndarray:
        if case["method"] == "dense":
            return moe_ffn(params, tokens, mesh=on).cpu().numpy()
        return moe_ffn_capacity(params, tokens, capacity=case["capacity"], method=case["method"], mesh=on).cpu().numpy()

    with torch.inference_mode():
        return [run(shard_experts(whole, ep_mesh), ep_mesh), run(whole, None)]


def _resume_layout(case: dict, device: Any) -> dict:
    """A ``"resume_layout"`` case: the DiT trainer set up by ``argv`` at ``--dp`` = the world with
    ``--fsdp``, restored from the latest step in ``dir`` (committed in another layout) as ``main``
    restores it; every rank returns its restored parameters, optimizer state and EMA (numpy, by name
    and optimizer index) and its layout record."""
    import torch
    import torch.distributed as dist

    from ..models.checkpoint import TrainCheckpointer
    from ..training import _restore, build_trainer, parser, restore_train_state, train_layout
    from . import make_mesh

    world = dist.get_world_size()
    args = parser().parse_args([*case["argv"], "--dp", str(world), "--fsdp"])
    mesh = make_mesh(dp=world, sp=1)
    _model, trained, opt, ema = build_trainer(args, device, mesh)
    layout = train_layout(trained, opt, mesh)
    state = restore_train_state(TrainCheckpointer(case["dir"]), layout, trained, opt, mesh)
    step = _restore(state, trained, opt, ema)
    numpy = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
    state = opt.state_dict()["state"]
    return {
        "step": step, "layout": layout, "params": {n: numpy(p) for n, p in trained.named_parameters()},
        "ema": {n: numpy(t) for n, t in ema.items()},
        "opt": {k: {f: numpy(t) for f, t in v.items()} if isinstance(v, dict) else numpy(v) for k, v in state.items()},
    }


def _run_case(case: dict, mesh: Any, device: Any) -> Any:
    """One case on this rank: a numpy array (two for ``"joint_sp"``, a list for ``"serve"``, the loss
    and gradients for a training case), or for ``"raises"`` a message."""
    import torch

    from . import gather, joint_sp_attention, make_mesh, ring_attention, shard_batch, ulysses_attention

    def shard(a: np.ndarray, dim: int) -> torch.Tensor:
        return shard_batch(mesh, torch.from_numpy(np.ascontiguousarray(a)).to(device), spatial_axis=dim)

    def out(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    kind = case["kind"]
    dtype = getattr(torch, case.get("dtype", "float32"))
    with torch.inference_mode():
        if kind in ("ring", "ulysses"):
            q, k, v = (shard(case[n], 2).to(dtype) for n in ("q", "k", "v"))
            if kind == "ring":
                return out(ring_attention(q, k, v, mesh, block_op=case["block_op"]))
            return out(ulysses_attention(q, k, v, mesh, heads_op=case["heads_op"]))
        if kind == "joint_sp":
            qkv_a, qkv_b = (shard(case[n], 1).to(dtype) for n in ("qkv_a", "qkv_b"))
            oa, ob = joint_sp_attention(qkv_a, qkv_b, case["heads"], mesh, scheme=case["scheme"])
            return [out(oa), out(ob)]
        if kind == "dit":
            dit_mesh = make_mesh(*case["mesh"]) if "mesh" in case else mesh
            model = _dit(case, dit_mesh, device)
            x, t = (shard_batch(dit_mesh, torch.from_numpy(case[n]).to(device)) for n in ("x", "t"))
            y = model(x, t)
            return out(gather(dit_mesh, y, 0, "dp") if "mesh" in case else y)
        if kind == "mmdit":
            from ..models.mmdit import MMDiT, MMDiTConfig

            model = MMDiT(MMDiTConfig(**_dtype_fields(case["config"])), mesh=mesh, device=device)
            model.load_jax_params(case["tree"])
            x, t, ctx = (torch.from_numpy(case[n]).to(device) for n in ("x", "t", "context"))
            return out(model(x, t, ctx))
        if kind == "video":
            from ..models.video_dit import VideoDiT, VideoDiTConfig

            config = VideoDiTConfig(**_dtype_fields(case["config"]), sequence_parallel=True)
            model = VideoDiT(config, mesh=mesh, device=device).load_jax_params(case["tree"])
            x, t = (torch.from_numpy(case[n]).to(device) for n in ("x", "t"))
            return out(model(x, t))
        if kind == "pipeline":
            return _pipeline(case, device)
        if kind == "sample":
            from .. import scheduling
            from ..ops import CompiledDenoiser, compile_sampler
            from ..sampling import models, structured

            model = _dit(case, mesh, device)
            compiled = compile_sampler(
                structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), case["steps"]
            )
            denoiser = CompiledDenoiser.build(compiled, device=device)
            return out(denoiser.run(model.as_sampleable(), torch.from_numpy(case["x0"]).to(device)))
    if kind == "serve":
        return _serve(case, device)
    if kind == "serve_abort":
        return _serve_abort(case, device)
    if kind == "tp":
        return _tp(case, device)
    if kind == "tp_sample":
        return _tp_sample(case, device)
    if kind in ("train_dit", "train_t2i"):
        return _train(case, device)
    if kind == "train_cli":
        return _train_cli(case)
    if kind == "train_fsdp":
        return _train_fsdp(case, device)
    if kind == "pipe":
        return _pipe(case, device)
    if kind in ("pp_dit", "pp_mmdit"):
        return _pipelined_model(case, device)
    if kind == "grad":
        return _grad_attention(case, mesh, device)
    if kind == "grad_model":
        return _grad_model(case, mesh, device)
    if kind == "moe":
        return _moe(case, mesh, device)
    if kind == "resume_layout":
        return _resume_layout(case, device)
    if kind == "raises":
        return _raises(case["what"], mesh, device)
    raise ValueError(f"unknown case kind {kind!r}")


def _raises(what: str, mesh: Any, device: Any) -> str:
    """The error that misuse ``what`` raises on this rank, as ``"Type: message"``."""
    import torch

    from ..models.dit import DiT, DiTConfig
    from . import make_mesh, ulysses_attention

    size = mesh.size(mesh.mesh_dim_names.index("sp"))
    try:
        if what == "heads":  # one head fewer than a multiple of the axis size
            x = torch.zeros((1, size + 1, 4, 8), device=device)
            ulysses_attention(x, x, x, mesh)
        elif what == "tokens":  # a latent of (size + 1) x 1 patches
            config = DiTConfig(dim=32, depth=1, heads=2, compute_dtype=torch.float32, attention="ring")
            DiT(config, mesh=mesh, device=device)(torch.zeros((1, 4, 2 * (size + 1), 2), device=device), 1.0)
        elif what == "no_mesh":
            DiT(DiTConfig(attention="ring"), device=device)
        elif what == "dp":  # the same ranks laid out as data parallel, and a bucket of 1
            from ..serving import ServingEngine

            ServingEngine(lambda x, *_: x, (4, 2, 2), buckets=(1, size), mesh=make_mesh(dp=size, sp=1), device=device)
        elif what == "slots":
            from ..continuous import ContinuousServingEngine

            dp_mesh = make_mesh(dp=size, sp=1)
            ContinuousServingEngine(lambda x, *_: x, (4, 2, 2), slots=size + 1, mesh=dp_mesh, device=device)
        elif what == "stream_tokens":  # (size + 1) x 1 image patches beside 128 text tokens
            from ..models.mmdit import MMDiT, MMDiTConfig

            config = MMDiTConfig(
                dim=32, depth=1, heads=2, context_dim=16, compute_dtype=torch.float32, attention="ring"
            )
            MMDiT(config, mesh=mesh, device=device)(torch.zeros((1, 4, 2 * (size + 1), 2), device=device), 1.0)
        elif what == "tp":
            from ..pipeline import build_pipeline

            build_pipeline(lambda x, *_: x, (size, 4, 2, 2), mesh_axes={"tp": 1}, device=device)
        elif what == "dp_graph":  # --graph captures CUDA graphs: refused on CPU ranks (argparse's exit)
            import contextlib
            import io

            from ..training import main

            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                try:
                    main(["--dp", str(size), "--graph", "--device", str(device)])
                except SystemExit:
                    return "SystemExit: " + err.getvalue().strip().splitlines()[-1]
        elif what == "dp_orbax":  # a sharded train state: every rank's file in the committed step
            import torch.distributed as dist

            from ..training import main

            with tempfile.TemporaryDirectory() as scratch:
                box = [scratch]  # the first rank's directory on every rank
                dist.broadcast_object_list(box, src=0)
                argv = ["--dp", str(size), "--fsdp", "--steps", "1", "--batch", str(2 * size), "--dim", "32",
                        "--depth", "1", "--heads", "1", "--size", "8", "--orbax", box[0], "--device", str(device)]
                if main(argv) != 0 or not os.path.exists(os.path.join(box[0], "1", f"state-{dist.get_rank()}.pt")):
                    return "no committed sharded step"
                dist.barrier()
        elif what == "flash_mesh":  # a mesh the attention would not use
            DiT(DiTConfig(attention="flash"), mesh=mesh, device=device)
        else:
            raise KeyError(what)
    except ValueError as err:
        return f"{type(err).__name__}: {err}"
    return "no error"


def meet(store: Any, rank: int, world: int, timeout_s: float = TIMEOUT_S) -> None:
    """Wait on ``store`` until every rank of the world has reached this point (``timeout_s`` at most):
    a rank that starts late (process start and imports on a loaded host take seconds) then never
    eats into a short group timeout, whose budget is the collectives', not the ranks' start."""
    from datetime import timedelta

    store.set(f"meet-{rank}", "1")
    store.wait([f"meet-{r}" for r in range(world)], timedelta(seconds=timeout_s))


def run_sp(
    rank: int,
    world: int,
    store_path: str,
    backend: str,
    device: str,
    cases: list[dict],
    out_queue: Any,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """One rank: initialise the group (``timeout_s`` its timeout) over a ``FileStore`` at ``store_path``, build
    ``make_mesh(dp=1, sp=world)``, run ``cases`` in order, put ``(rank, index, result)`` for each
    on ``out_queue`` (then ``(rank, None, "done")``), and destroy the group.  A failure puts
    ``(rank, None, traceback)`` instead, so the caller never waits out a hang."""
    import torch
    import torch.distributed as dist

    from . import make_mesh

    torch.set_num_threads(1)
    try:
        dev = _device(device, rank)
        store = dist.FileStore(store_path, world)
        meet(store, rank, world)
        options = {"device_id": dev} if backend == "nccl" else {}
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s), **options
        )
        try:
            mesh = make_mesh(dp=1, sp=world)
            for index, case in enumerate(cases):
                out_queue.put((rank, index, _run_case(case, mesh, dev)))
        finally:
            dist.destroy_process_group()
        out_queue.put((rank, None, "done"))
    except BaseException:
        out_queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        out_queue.close()
        out_queue.join_thread()  # every result written before the process exits


def spawn_sp(
    world: int,
    cases: list[dict],
    store_dir: str,
    backend: str = "nccl",
    device: str = "cuda",
    timeout_s: float = TIMEOUT_S,
) -> list[list[Any]]:
    """Run ``cases`` on ``world`` spawned ranks whose group waits ``timeout_s`` at most for a
    collective; returns ``results[rank][case index]``.

    Raises ``RuntimeError`` with the rank's traceback if a rank fails, or if the ranks do not
    finish within ``timeout_s`` plus a minute; every process is stopped before it returns."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-{world}")
    procs = [
        ctx.Process(
            target=run_sp, args=(r, world, store_path, backend, device, cases, out_queue, timeout_s), daemon=True
        )
        for r in range(world)
    ]
    results: list[list[Any]] = [[None] * len(cases) for _ in range(world)]
    try:
        for proc in procs:
            proc.start()
        done = 0
        deadline = time.monotonic() + timeout_s + 60
        while done < world:
            try:
                rank, index, value = out_queue.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, proc in enumerate(procs) if proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without reporting") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the {world} ranks did not finish within {timeout_s + 60} s") from None
                continue
            if index is not None:
                results[rank][index] = value
            elif value == "done":
                done += 1
            else:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
    finally:
        for proc in procs:
            if proc.pid is None:  # never started
                continue
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    return results


def run_cli(rank: int, world: int, store_path: str, argv: list[str], timeout_s: float) -> None:
    """One rank of :func:`spawn_cli`: initialise a gloo group over a ``FileStore``, run the DiT trainer's
    ``main(argv)`` inside it on the CPU and exit with its code (a fault-injected SIGKILL ends it first)."""
    import torch
    import torch.distributed as dist

    from ..training import main

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=timedelta(seconds=timeout_s),
    )
    try:
        code = main(argv)
    finally:
        dist.destroy_process_group()
    sys.exit(code)


def spawn_cli(world: int, argv: list[str], store_dir: str, timeout_s: float = TIMEOUT_S) -> list[int | None]:
    """``python -m skrample_tpu_torch.training ARGV`` on ``world`` spawned gloo ranks, as ``torchrun``
    would start it; returns every rank's exit code (``-9`` for a SIGKILL) once all have ended, killing
    any still running after ``timeout_s`` plus a minute (its code then None)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store_path = os.path.join(store_dir, f"cli-{os.getpid()}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=run_cli, args=(r, world, store_path, argv, timeout_s), daemon=True) for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout_s + 60
    for proc in procs:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    codes = []
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
            codes.append(None)
        else:
            codes.append(proc.exitcode)
    return codes


def sample_cases(dtype: str, seed: int = 0) -> list[dict]:
    """The CLI's cases: one 8-step sample of a DiT (dim 64, depth 2, 4 heads, 16x16 latents:
    64 tokens) with random weights from ``seed``, flash, ring and ulysses."""
    from ..models.dit import DiTConfig, random_param_tree

    fields = {"dim": 64, "depth": 2, "heads": 4}
    tree = random_param_tree(DiTConfig(**fields), seed)
    x0 = np.random.default_rng(seed + 1).standard_normal((2, 4, 16, 16), dtype=np.float32)
    return [
        {
            "kind": "sample",
            "config": {**fields, "compute_dtype": dtype, "attention": attention},
            "tree": tree,
            "x0": x0,
            "steps": 8,
        }
        for attention in ("flash", "ring", "ulysses")
    ]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, required=True, help="ranks (the sp axis size)")
    parser.add_argument(
        "--backend", choices=("nccl", "gloo"), default="nccl", help="nccl: a card a rank (default); gloo: CPU ranks"
    )
    args = parser.parse_args(argv)
    nccl = args.backend == "nccl"
    # the kernels take 16-bit inputs; the CPU's plain versions run in float32
    dtype, tolerance = ("bfloat16", 5e-2) if nccl else ("float32", 1e-4)
    with tempfile.TemporaryDirectory() as store_dir:
        results = spawn_sp(args.nproc, sample_cases(dtype), store_dir, args.backend, "cuda" if nccl else "cpu")
    flash = results[0][0]
    ok = True
    for index, attention in ((1, "ring"), (2, "ulysses")):
        agree = all(np.array_equal(results[r][index], results[0][index]) for r in range(args.nproc))
        err = float(np.abs(results[0][index] - flash).max() / np.abs(flash).max())
        passed = agree and err <= tolerance
        ok &= passed
        print(
            f"dryrun {attention}: DiT(attention={attention!r}, sp={args.nproc}, {args.backend}, {dtype}) 8-step sample "
            f"vs flash: relative max err {err:.3e} (tolerance {tolerance:.0e}), ranks agree {agree}: "
            f"{'OK' if passed else 'FAILED'}"
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
