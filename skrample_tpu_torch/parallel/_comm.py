"""How the port's collectives move tensors.

NCCL (a card a rank) and gloo over CPU tensors move the tensors themselves.
Gloo ranks that hold card tensors (several processes on one card) move host
memory only: each collective here sends host copies and copies what it
receives onto the tensors' card.  The ring, ulysses, the models' gathers,
the pipeline stages and FSDP all move through these calls, so that choice
is made once.  The one-shot collectives run under
:func:`~.faults.guarded`; :func:`p2p` returns its wait, and the caller
guards the region that posts and waits.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.distributed as dist

from .faults import guarded


def _staged(group: dist.ProcessGroup, tensor: torch.Tensor) -> bool:
    "Whether a collective of ``tensor`` over ``group`` goes through host copies (gloo holding a card tensor)."
    return dist.get_backend(group) == "gloo" and tensor.device.type != "cpu"


def p2p(
    sends: list[tuple[torch.Tensor, int, int]], recvs: list[tuple[torch.Tensor, int, int]], group: dist.ProcessGroup
) -> Callable[[], None]:
    """Post point-to-point ``sends`` and ``recvs`` (``(tensor, global peer rank, tag)`` each) over
    ``group`` as one batch, and return the call that waits for them all; a staged receive lands in a
    host buffer that is copied into its tensor when the wait returns."""
    landing: list[tuple[torch.Tensor, torch.Tensor]] = []
    ops = []
    for tensor, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, tensor.cpu() if _staged(group, tensor) else tensor, peer, group, tag=tag))
    for tensor, peer, tag in recvs:
        buffer = tensor
        if _staged(group, tensor):
            buffer = torch.empty(tensor.shape, dtype=tensor.dtype)
            landing.append((buffer, tensor))
        ops.append(dist.P2POp(dist.irecv, buffer, peer, group, tag=tag))
    requests = dist.batch_isend_irecv(ops) if ops else []

    def wait() -> None:
        for request in requests:
            request.wait()
        for buffer, tensor in landing:
            tensor.copy_(buffer)
        ops.clear()  # the host copies sent live until here

    return wait


def all_gather(part: torch.Tensor, group: dist.ProcessGroup, size: int, dim: int = 0) -> torch.Tensor:
    "Every rank's ``part`` (one shape on every rank), concatenated along ``dim`` in rank order."
    part = part.contiguous()
    with guarded([group]):
        if dim == 0 and dist.get_backend(group) == "nccl":
            whole = part.new_empty((size * part.shape[0], *part.shape[1:]))
            dist.all_gather_into_tensor(whole, part, group=group)
            return whole
        source = part.cpu() if _staged(group, part) else part
        parts = [torch.empty_like(source) for _ in range(size)]
        dist.all_gather(parts, source, group=group)
    return torch.cat(parts, dim=dim).to(part.device)


def all_to_all(send: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    "One ``all_to_all_single`` of a contiguous ``(S, ...)`` buffer: slot j goes to rank j, rank j's lands at j."
    source = send.cpu() if _staged(group, send) else send
    recv = torch.empty_like(source)
    with guarded([group]):
        dist.all_to_all_single(recv, source, group=group)
    return recv.to(send.device)


def broadcast(tensor: torch.Tensor, src: int, group: dist.ProcessGroup) -> None:
    "``tensor`` from global rank ``src`` on every rank of ``group``, in place."
    host = tensor.cpu() if _staged(group, tensor) else tensor
    with guarded([group]):
        dist.broadcast(host, src=src, group=group)
    if host is not tensor:
        tensor.copy_(host)


def reduce_scatter(flat: torch.Tensor, group: dist.ProcessGroup, size: int, rank: int) -> torch.Tensor:
    "This rank's range (of ``size`` equal ones) of the sum over ``group`` of the flat ``flat``."
    with guarded([group]):
        if dist.get_backend(group) == "nccl":
            out = flat.new_empty(flat.numel() // size)
            dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=group)
            return out
        # gloo carries no reduce-scatter: the whole sum (of a host copy), then this rank's range of it
        total = flat.cpu().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.chunk(size)[rank].clone().to(flat.device)
