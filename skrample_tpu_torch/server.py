"""HTTP front-end for the serving runtime.

A deployment needs a network boundary.  This module puts a small,
dependency-free (stdlib ``http.server``) JSON API in front of
:class:`~skrample_tpu_torch.serving.ServingEngine`:

* ``POST /v1/generate`` — one request per call; the handler thread parks on
  the engine future while the worker keeps packing other callers into
  bucketed batches, so concurrent HTTP clients get the engine's dynamic
  batching for free (``ThreadingHTTPServer`` = thread per connection).
* ``GET /healthz`` — liveness + engine configuration.
* ``GET /stats`` — :class:`~skrample_tpu_torch.serving.ServingStats` plus uptime,
  a padding fraction, and an in-flight gauge.

Arrays cross the wire as ``{"shape": [...], "dtype": "float32", "data":
"<base64 of raw C-order bytes>"}`` — self-describing, no pickle, no numpy
version coupling.  Prompts on conditioned engines go through a caller-
supplied ``encode_prompt(str) -> context pytree`` closure (e.g. tokenizer +
text encoder); encodings are cached per prompt string so repeated prompts
cost one encoder forward, ever.

This is a serving *front-end*, not a gateway: TLS, auth, rate limiting and
cross-host load balancing belong in the infrastructure layer in front of it.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import numpy as np
import torch

from .serving import ServingEngine

__all__ = ["ServingServer", "encode_array", "decode_array"]


def _to_numpy(x: Any) -> np.ndarray:
    "Tensors come back to the host; bfloat16, which numpy lacks, widens to float32."
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def encode_array(x: Any) -> dict:
    "Array or tensor -> JSON-safe dict (raw little-endian C-order bytes, base64)."
    arr = np.ascontiguousarray(_to_numpy(x))
    return {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "data": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def decode_array(d: dict) -> np.ndarray:
    "Inverse of :func:`encode_array`; validates length against shape*dtype."
    try:
        shape = tuple(int(s) for s in d["shape"])
        dtype = np.dtype(d["dtype"])
        raw = base64.b64decode(d["data"], validate=True)
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed array payload: {err}") from err
    expect = dtype.itemsize * int(np.prod(shape, dtype=np.int64)) if shape else dtype.itemsize
    if len(raw) != expect:
        raise ValueError(f"array payload is {len(raw)} bytes, shape/dtype implies {expect}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


class ServingServer:
    """Serve a :class:`ServingEngine` over HTTP.

    ``encode_prompt`` (optional, conditioned engines): maps a prompt string
    to the engine's context pytree — one row, no batch axis — exactly what
    ``ServingEngine.submit(context=...)`` takes.  Cached per prompt.

    ``port=0`` binds an ephemeral port (read it back from ``.port``), which
    is also how the tests run hermetically.  The HTTP listener starts
    immediately; use as a context manager or call :meth:`close`.
    """

    def __init__(
        self,
        engine: ServingEngine,
        encode_prompt: Callable[[str], Any] | None = None,
        host: str = "127.0.0.1",
        port: int = 8000,
    ):
        self.engine = engine
        self._encode_prompt = encode_prompt
        self._prompt_cache: dict[str, Any] = {}
        self._prompt_lock = threading.Lock()
        self._started = time.monotonic()
        self._inflight = 0
        self._gauge_lock = threading.Lock()

        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="skrample-http", daemon=True)
        self._thread.start()

    # -- request handling (called from handler threads) -----------------

    def handle_generate(self, payload: dict) -> dict:
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        known = {"seed", "strength", "initial", "prompt", "context"}
        unknown = set(payload) - known
        if unknown:
            raise ValueError(f"unknown fields: {sorted(unknown)} (accepted: {sorted(known)})")
        seed = payload.get("seed")
        if not isinstance(seed, int) or isinstance(seed, bool):
            raise ValueError("'seed' (int) is required")
        strength = payload.get("strength", 1.0)
        if not isinstance(strength, (int, float)) or not 0.0 < float(strength) <= 1.0:
            raise ValueError("'strength' must be a number in (0, 1]")

        initial = None
        if payload.get("initial") is not None:
            initial = torch.from_numpy(decode_array(payload["initial"]).copy())
            if tuple(initial.shape) != self.engine.item_shape:
                raise ValueError(f"'initial' shape {tuple(initial.shape)} != item_shape {self.engine.item_shape}")

        context = None
        if payload.get("prompt") is not None and payload.get("context") is not None:
            raise ValueError("pass 'prompt' or 'context', not both")
        if payload.get("prompt") is not None or payload.get("context") is not None:
            if not self.engine.conditioned:
                raise ValueError(
                    "this engine is unconditional; 'prompt'/'context' need ServingEngine(conditioned=True)"
                )
            if payload.get("prompt") is not None:
                context = self._context_for(payload["prompt"])
            else:
                context = torch.from_numpy(decode_array(payload["context"]).copy())

        with self._gauge_lock:
            self._inflight += 1
        try:
            fut = self.engine.submit(seed, initial=initial, strength=float(strength), context=context)
            out = _to_numpy(fut.result())
        finally:
            with self._gauge_lock:
                self._inflight -= 1
        return {"latent": encode_array(out)}

    def _context_for(self, prompt: Any) -> Any:
        if not isinstance(prompt, str):
            raise ValueError("'prompt' must be a string")
        if self._encode_prompt is None:
            raise ValueError("server has no prompt encoder; send a 'context' array instead")
        with self._prompt_lock:
            ctx = self._prompt_cache.get(prompt)
            if ctx is None:
                ctx = self._prompt_cache[prompt] = self._encode_prompt(prompt)
            return ctx

    def healthz(self) -> dict:
        out = {
            "ok": True,
            "device": str(self.engine.device),
            "steps": self.engine.steps,
            "item_shape": list(self.engine.item_shape),
            "conditioned": self.engine.conditioned,
        }
        if hasattr(self.engine, "buckets"):  # batch engine
            out["buckets"] = list(self.engine.buckets)
        if hasattr(self.engine, "slots"):  # continuous engine
            out["slots"] = self.engine.slots
        return out

    def stats(self) -> dict:
        s = self.engine.stats
        out = {
            "uptime_s": time.monotonic() - self._started,
            "requests": s.requests,
            "bucket_counts": {str(k): v for k, v in sorted(s.bucket_counts.items())},
            "inflight": self._inflight,
            "cached_prompts": len(self._prompt_cache),
        }
        # engine-specific gauges: batch (padding) vs continuous (occupancy)
        for name in ("batches", "padded_items", "padding_fraction", "completed", "ticks", "slot_steps", "occupancy"):
            if hasattr(s, name):
                out[name] = getattr(s, name)
        return out

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "ServingServer":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def _make_handler(server: ServingServer) -> type:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args: Any) -> None:  # quiet by default; front-ends log
            pass

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                self._reply(200, server.healthz())
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self) -> None:
            if self.path != "/v1/generate":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"null")
            except (ValueError, json.JSONDecodeError) as err:
                self._reply(400, {"error": f"bad JSON: {err}"})
                return
            try:
                result = server.handle_generate(payload)
            except ValueError as err:
                self._reply(400, {"error": str(err)})
            except Exception as err:  # engine/compile failures: surface, keep serving
                self._reply(500, {"error": f"{type(err).__name__}: {err}"})
            else:
                self._reply(200, result)

    return Handler
