"""``python -m skrample_tpu_torch`` — operational entry points.

* ``info``    — torch and CUDA versions and the device inventory (the "is
  the card there" check; exits non-zero when no CUDA device is visible,
  unless ``--device cpu``).
* ``serve``   — stand up the HTTP serving front-end (:mod:`.server`) around
  a demo DiT with seeded random parameters: a harness for load tests and
  smoke checks.  Real deployments build a
  :class:`~skrample_tpu_torch.serving.ServingEngine` around their own model
  and hand it to :class:`~skrample_tpu_torch.server.ServingServer`.
* ``generate`` — one-shot demo generation to a ``.npy`` file.

Every command runs on ``--device cuda`` unless told ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from collections.abc import Sequence


def _cmd_info(args: argparse.Namespace) -> int:
    import torch

    from . import __version__

    print(f"skrample-tpu-torch {__version__}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"cuda devices: {count}")
    for i in range(count):
        props = torch.cuda.get_device_properties(i)
        print(f"  [{i}] {props.name} ({props.total_memory / 2**30:.1f} GiB, sm_{props.major}{props.minor})")
    if args.device == "cuda" and count == 0:
        print("no CUDA device visible", file=sys.stderr)
        return 1
    return 0


def _demo_engine(args: argparse.Namespace):
    "A DiT with seeded random params wrapped for the serving engine."
    import torch

    from .models.dit import DiT, DiTConfig
    from .serving import ServingEngine

    side = args.size // 8  # latent side at the usual 8x VAE factor
    heads = max(args.dim // 128, 1)  # head_dim 128: the fused-qkv attention kernel's width
    # bf16 on the card; f32 on the CPU, where bf16 matmuls are slow and gain nothing
    dtype = torch.float32 if torch.device(args.device).type == "cpu" else torch.bfloat16
    config = DiTConfig(dim=args.dim, depth=args.depth, heads=heads, compute_dtype=dtype, attention="flash")
    model = DiT(config, device=args.device, generator=torch.Generator().manual_seed(args.param_seed))
    return ServingEngine(
        model.as_sampleable(),
        item_shape=(4, side, side),
        steps=args.steps,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        device=args.device,
    )


def _cmd_serve(args: argparse.Namespace) -> int:
    from .server import ServingServer

    engine = _demo_engine(args)
    with engine, ServingServer(engine, host=args.host, port=args.port) as srv:
        print(f"serving on http://{srv.host}:{srv.port}  (POST /v1/generate, GET /healthz, GET /stats)")
        try:
            import threading

            threading.Event().wait()  # serve until interrupted
        except KeyboardInterrupt:
            print("shutting down")
    return 0


def _cmd_generate(args: argparse.Namespace) -> int:
    import numpy as np

    from .server import _to_numpy

    engine = _demo_engine(args)
    with engine:
        latent = _to_numpy(engine.generate(args.seed))
    np.save(args.out, latent)
    print(f"wrote {latent.shape} {latent.dtype} -> {args.out}")
    return 0


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_demo_flags(p: argparse.ArgumentParser) -> None:
    _add_device_flag(p)
    p.add_argument("--dim", type=int, default=256, help="DiT width (demo model)")
    p.add_argument("--depth", type=int, default=4, help="DiT depth (demo model)")
    p.add_argument("--size", type=int, default=256, help="image size in pixels (latent = size/8)")
    p.add_argument("--steps", type=int, default=25, help="denoise steps")
    p.add_argument("--param-seed", type=int, default=0, help="demo parameter seed")
    p.add_argument("--buckets", default="1,2,4,8", help="batch buckets, comma-separated")


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m skrample_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    info = sub.add_parser("info", help="torch / CUDA device inventory")
    _add_device_flag(info)
    info.set_defaults(fn=_cmd_info)

    serve = sub.add_parser("serve", help="HTTP serving front-end around a demo DiT")
    _add_demo_flags(serve)
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8000)
    serve.set_defaults(fn=_cmd_serve)

    gen = sub.add_parser("generate", help="one-shot demo generation to .npy")
    _add_demo_flags(gen)
    gen.add_argument("--seed", type=int, default=0, help="request seed")
    gen.add_argument("--out", default="latent.npy")
    gen.set_defaults(fn=_cmd_generate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
