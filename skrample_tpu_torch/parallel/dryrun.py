"""Sequence-parallel dry run: S ranks, each a process, one ``torch.distributed`` group.

    python -m skrample_tpu_torch.parallel.dryrun --nproc 4                  # NCCL, one card a rank
    python -m skrample_tpu_torch.parallel.dryrun --nproc 4 --backend gloo   # CPU ranks

spawns S ranks that sample the same 8-step DPM++2M request through a small
random-weight DiT three times, with ``attention="flash"`` (no mesh),
``"ring"`` and ``"ulysses"`` over ``make_mesh(dp=1, sp=S)``, and prints
whether the two sequence-parallel samples equal the flash one (the port's
counterpart of the JAX package's ``_dryrun_ring_attention``).

:func:`run_sp` is the rank body, and :func:`spawn_sp` runs a list of cases
on S ranks and returns each rank's results.  A case is a dict with a
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
  latent or its error as ``"Type: message"``;
* ``"train_dit"`` (``config, tree, x0, noise, sigma``) and ``"train_t2i"``
  (``enc, mmdit`` configs, ``trees``, ``draws``): one data-parallel step at
  ``dp = S``; every rank returns the loss and its gradients by tree path;
  ``"train_cli"`` (``argv``): ``training.main(argv + ["--dp", S])`` inside the
  group; every rank returns its exit code and the last parameter file's
  tree when ``argv`` names one (rank 0 writes it);
* ``"raises"`` (``what``): each rank returns the error the named misuse
  raises, as ``"Type: message"`` (``"heads"``, ``"tokens"``, ``"no_mesh"``,
  ``"dp"`` (a bucket ``dp`` does not divide), ``"slots"``,
  ``"stream_tokens"`` (an MMDiT stream ``sp`` does not divide):
  ``ValueError``; ``"flash_mesh"``, a flash DiT given a mesh, ``"tp"``, a
  pipeline over a ``tp`` axis, ``"dp_graph"``, ``"dp_orbax"``, the DiT
  trainer's ``--dp`` with ``--graph`` or ``--orbax``, and ``"grad_ring"``,
  ``"grad_ulysses"``, ``"grad_dit"``, a gradient through the
  sequence-parallel attentions: ``NotImplementedError``).

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
    use_mesh = mesh if config.attention in ("ring", "ulysses") else None
    model = DiT(config, mesh=use_mesh, device=device).load_jax_params(case["tree"])
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

    model_fn = _dit(case, None, device).as_sampleable()
    mesh = make_mesh(dp=dist.get_world_size(), sp=1)
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

    mesh = make_mesh(dp=dist.get_world_size(), sp=1)
    if case["kind"] == "train_dit":
        from ..models.ema import ema_init
        from ..training import make_optimizer, train_step

        model = _dit(case, None, device).requires_grad_(True)
        opt = make_optimizer(model)
        x0, noise, sigma = (torch.from_numpy(case[n]).to(device) for n in ("x0", "noise", "sigma"))
        loss = train_step(model, opt, ema_init(model), x0, noise, sigma, 0, mesh=mesh)
        leaves = [
            (f"{name}.{leaf}", getattr(layer, attr), leaf == "w")
            for name, layer in model._layers()
            for leaf, attr in (("w", "weight"), ("b", "bias"))
        ]
        return [float(loss), _grads(leaves)]
    from ..models.mmdit import MMDiT, MMDiTConfig
    from ..models.text_encoder import TextEncoder, TextEncoderConfig
    from ..train_text_to_image import hermetic_data, t2i_optimizer, t2i_train_step

    enc = TextEncoder(TextEncoderConfig(**_dtype_fields(case["enc"])), device=device)
    mmdit = MMDiT(MMDiTConfig(**_dtype_fields(case["mmdit"])), device=device)
    enc.load_jax_params(case["trees"]["enc"])
    mmdit.load_jax_params(case["trees"]["mmdit"])
    ids, images = hermetic_data(case["size"], device=device)
    draws = tuple(torch.from_numpy(a).to(device) for a in case["draws"])
    loss = t2i_train_step(enc, mmdit, t2i_optimizer(enc, mmdit), ids, images, draws, mesh)
    grads = _grads(_tree.leaves(enc))
    return [float(loss), {"enc": grads, "mmdit": _grads(_tree.leaves(mmdit))}]


def _train_cli(case: dict) -> list:
    """A ``"train_cli"`` case: ``[exit code, {path: array}]`` of the DiT trainer's CLI at ``--dp`` = the
    world, the parameter file read back after every rank has finished."""
    import torch.distributed as dist

    from ..models.checkpoint import load_params
    from ..models import _tree
    from ..training import main

    argv = [*case["argv"], "--dp", str(dist.get_world_size())]
    rc = main(argv)
    dist.barrier()
    path = argv[argv.index("--checkpoint") + 1] if "--checkpoint" in argv else None
    return [rc, dict(_tree._flatten(load_params(path))) if path else {}]


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
    if kind in ("train_dit", "train_t2i"):
        return _train(case, device)
    if kind == "train_cli":
        return _train_cli(case)
    if kind == "raises":
        return _raises(case["what"], mesh, device)
    raise ValueError(f"unknown case kind {kind!r}")


def _raises(what: str, mesh: Any, device: Any) -> str:
    """The error that misuse ``what`` raises on this rank, as ``"Type: message"``."""
    import torch

    from ..models.dit import DiT, DiTConfig
    from . import make_mesh, ring_attention, ulysses_attention

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
        elif what in ("dp_graph", "dp_orbax"):
            from ..training import main

            main(["--dp", str(size), "--graph" if what == "dp_graph" else "--orbax=unused", "--device", str(device)])
        elif what == "flash_mesh":  # a mesh the attention would not use
            DiT(DiTConfig(attention="flash"), mesh=mesh, device=device)
        elif what in ("grad_ring", "grad_ulysses"):  # the K/V that arrive over the wire carry no graph
            x = torch.zeros((1, size, 4, 8), device=device, requires_grad=True)
            (ring_attention if what == "grad_ring" else ulysses_attention)(x, x, x, mesh)
        elif what == "grad_dit":  # trainable parameters reach the ring attention through qkv
            config = DiTConfig(dim=32, depth=1, heads=2, compute_dtype=torch.float32, attention="ring")
            DiT(config, mesh=mesh, device=device)(torch.zeros((1, 4, 2 * size, 2), device=device), 1.0)
        else:
            raise KeyError(what)
    except (ValueError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    return "no error"


def run_sp(
    rank: int,
    world: int,
    store_path: str,
    backend: str,
    device: str,
    cases: list[dict],
    out_queue: Any,
) -> None:
    """One rank: initialise the group over a ``FileStore`` at ``store_path``, build
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
        options = {"device_id": dev} if backend == "nccl" else {}
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world, timeout=timedelta(seconds=TIMEOUT_S), **options
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
    world: int, cases: list[dict], store_dir: str, backend: str = "nccl", device: str = "cuda"
) -> list[list[Any]]:
    """Run ``cases`` on ``world`` spawned ranks; returns ``results[rank][case index]``.

    Raises ``RuntimeError`` with the rank's traceback if a rank fails, or if the ranks do not
    finish within ``TIMEOUT_S`` plus a minute; every process is stopped before it returns."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out_queue = ctx.Queue()
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-{world}")
    procs = [
        ctx.Process(target=run_sp, args=(r, world, store_path, backend, device, cases, out_queue), daemon=True)
        for r in range(world)
    ]
    results: list[list[Any]] = [[None] * len(cases) for _ in range(world)]
    try:
        for proc in procs:
            proc.start()
        done = 0
        deadline = time.monotonic() + TIMEOUT_S + 60
        while done < world:
            try:
                rank, index, value = out_queue.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, proc in enumerate(procs) if proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without reporting") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the {world} ranks did not finish within {TIMEOUT_S + 60} s") from None
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
