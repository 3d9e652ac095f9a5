"""What a rank does when it faults inside a collective of a model's own.

A model on a mesh runs collectives of its own between the engines' (the
ring's point-to-point hops and ulysses' all-to-alls over ``sp``, the
tensor-parallel all-reduces over ``tp``).  A rank that raises inside one
leaves its peers waiting in it.  :func:`guarded` wraps such a region: on a
fault it aborts the region's process groups on this rank and raises
:class:`MeshAborted` from the fault.
A peer blocked in a collective with it then raises when the group's
timeout runs out (gloo waits that long for a receive; NCCL's watchdog the
same), inside its own :func:`guarded` region, so it aborts too.  The
groups are unusable from then on: the engines fail every pending request
on every rank (``serving.MeshLink.agreed`` carries the abort to the ranks
that were not in the collective).
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterable, Iterator
from typing import Any

import torch.distributed as dist


class MeshAborted(RuntimeError):
    "A collective region of a model faulted, and its mesh's process groups were aborted on this rank."


def mesh_groups(mesh: Any) -> list[dist.ProcessGroup]:
    "Every process group of ``mesh``'s dims (one per dim, this rank's)."
    return [mesh.get_group(name) for name in mesh.mesh_dim_names or ()]


def abort_groups(groups: Iterable[dist.ProcessGroup]) -> None:
    """``ProcessGroup.abort()`` on each of ``groups`` (each once); a backend that cannot abort is
    left to its timeout."""
    seen: set[int] = set()
    for group in groups:
        if id(group) in seen:
            continue
        seen.add(id(group))
        with contextlib.suppress(Exception):
            group.abort()


@contextlib.contextmanager
def guarded(groups: Iterable[dist.ProcessGroup]) -> Iterator[None]:
    """A region of collectives over ``groups``: an exception inside aborts them on this rank and is
    raised again as :class:`MeshAborted` (an inner region's :class:`MeshAborted` passes as it is)."""
    try:
        yield
    except MeshAborted:
        raise
    except Exception as err:
        abort_groups(groups)
        raise MeshAborted(f"a fault inside a collective region aborted the mesh's process groups: {err}") from err
