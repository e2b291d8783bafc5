"""Multi-process helpers of the port (counterpart of
``glint_word2vec_tpu/parallel/distributed.py``).

A gang of training processes talks through ``torch.distributed`` with the
gloo backend: :func:`initialize` forms the process group from an explicit
``host:port`` coordinator, rank and world size (nothing on a card machine
tells a program of a cluster), :func:`process_index`,
:func:`process_count` and :func:`barrier` answer the JAX runtime's
questions, and :func:`allgather_host` is the host-level allgather the
replica exchange (``parallel/exchange.py``) ships its payloads through.
Each rank trains on its own card, ``cuda:{rank % device_count}``
(:func:`rank_device`); ranks share a card when there are fewer cards than
ranks.

The corpus splits are pure numpy and give the JAX package's outputs
exactly: :func:`shard_sentences_for_process` and
:func:`shard_flat_for_process` (round-robin, the remainder dropped),
:func:`shard_flat_locality` (clustered by each sentence's rarest token),
:func:`per_process_word_counts`, and :func:`shard_span` (contiguous, every
item once: the bulk transform's split).

The mesh of a gang (``exchange="none"``): :func:`make_global_mesh` gives
each process a mesh whose model axis is its own and whose data axis
crosses the processes (each process runs ``num_data / process_count``
data ranks; the engine joins their rows through :func:`allgather_host`),
:func:`process_batch_slice` this process's share of a global batch, and
:func:`make_global_batch` its rows as tensors.
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: Seconds a collective may wait for a peer before it fails the rank: a
#: dead peer must fail its partners within this bound, so the supervisor
#: can tear the gang down.
DEFAULT_TIMEOUT_SECONDS = 300.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gang's gloo process group at ``coordinator_address``
    (``host:port``; rank 0 binds it) as ``process_id`` of
    ``num_processes``. A no-op when the group is already up. Every
    argument is required: a rank that cannot form the group raises, it
    never goes on alone."""
    import torch.distributed as dist

    if dist.is_initialized():
        logger.info("torch.distributed already initialized; skipping")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id (--coordinator, --num-processes, --process-id)"
        )
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes} "
            "processes"
        )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        rank=int(process_id), world_size=int(num_processes),
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_SECONDS),
    )
    logger.info("process group up: rank %d of %d (gloo, %s)",
                dist.get_rank(), dist.get_world_size(), coordinator_address)


def process_index() -> int:
    """This process's rank; 0 outside a gang."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The gang's world size; 1 outside a gang."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(tag: str = "") -> None:
    """All-rank rendezvous (a no-op outside a gang). ``tag`` names it in
    the log: the replica-exchange checkpoint waits here until every rank
    has written its row block, before ``train_state.json`` flips."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        logger.debug("barrier %s", tag)
        dist.barrier()


def shutdown() -> None:
    """Leave the gang's process group (a no-op outside a gang)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device, rank: int):
    """The device a rank trains on: ``"cpu"`` as asked, else the card
    ``cuda:{rank % device_count}`` (ranks share a card when there are
    fewer cards than ranks). A rank that finds no card raises."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank} found no CUDA device; pass --device cpu to run "
            "the gang on the CPU"
        )
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", rank % torch.cuda.device_count())


#: Bytes of one ``allgather_host`` chunk.
_CHUNK_BYTES = 64 << 20

#: Dtypes gloo carries on every build; any other dtype (bf16 lanes) is
#: shipped as a uint8 view of its bytes, bit for bit.
_GLOO_DTYPES = None


def _wire_view(t):
    import torch

    global _GLOO_DTYPES
    if _GLOO_DTYPES is None:
        _GLOO_DTYPES = (torch.float32, torch.float64, torch.int32,
                        torch.int64, torch.int8, torch.uint8)
    if t.dtype in _GLOO_DTYPES:
        return t
    return t.reshape(-1).view(torch.uint8)


def allgather_host(arr, out=None):
    """Host-level allgather of one fixed-shape CPU tensor (or numpy
    array, returned as numpy): ``(process_count, *shape)`` in rank order.
    The wire of the replica exchange; a gloo ``all_gather`` between the
    gang's processes. Dtypes gloo does not carry (bf16) travel as a
    uint8 view of their bytes. ``out``, a contiguous CPU tensor of the
    result's shape and dtype, receives the result (a buffer the caller
    keeps across rounds). One process returns ``arr[None]`` without a
    collective."""
    import torch
    import torch.distributed as dist

    as_numpy = isinstance(arr, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(arr)) if as_numpy else arr
    t = t.contiguous()
    if process_count() == 1:
        out = t[None]
        return out.numpy() if as_numpy else out
    w = _wire_view(t)
    world = dist.get_world_size()
    if out is None:
        out = torch.empty((world,) + tuple(t.shape), dtype=t.dtype)
    # Each rank's slot a view of one buffer: no stacking copy.
    slots = out.reshape(world, -1)
    if w is not t:
        slots = slots.view(torch.uint8)
    flat = w.reshape(-1)
    n = flat.numel()
    step = max(1, _CHUNK_BYTES // flat.element_size())
    # A large tensor goes as chunks in flight together: gloo's worker
    # threads carry them side by side (one stream carries 0.2 to 0.5 GB/s
    # on a loopback, several about 1.5 times that).
    works = [
        dist.all_gather([slots[r, a:a + step] for r in range(world)],
                        flat[a:a + step], async_op=True)
        for a in range(0, n, step)
    ]
    for work in works:
        work.wait()
    return out.numpy() if as_numpy else out


def make_global_mesh(num_data: Optional[int] = None,
                     num_model: Optional[int] = None, devices=None):
    """The ("data", "model") mesh of a gang (``distributed.py:121`` of the
    JAX package): the model axis stays inside each process, and only the
    data axis crosses processes, ``num_data / process_count`` data ranks a
    process. ``devices`` are this process's (its card, :func:`rank_device`,
    repeated by default: ranks sharing a card each hold their own
    replica). One process gives ``make_mesh(num_data, num_model,
    devices)``."""
    from glint_word2vec_torch.parallel.mesh import Mesh, make_mesh

    pc, pi = process_count(), process_index()
    if pc == 1:
        return make_mesh(num_data, num_model, devices)
    num_model = int(num_model or 1)
    num_data = int(num_data or pc)
    if num_data % pc:
        raise ValueError(
            f"data-axis size ({num_data}) must be a multiple of the process "
            f"count ({pc}) so each process holds whole data rows"
        )
    local = num_data // pc
    if devices is None:
        devices = [rank_device(None, pi)] * (local * num_model)
    devs = list(devices)
    if len(devs) < local * num_model:
        raise ValueError(
            f"mesh {local}x{num_model} of this process needs more than the "
            f"{len(devs)} devices given"
        )
    return Mesh([devs[r * num_model:(r + 1) * num_model] for r in range(local)],
                process_index=pi, process_count=pc)


def process_batch_slice(mesh, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> Tuple[float, float]:
    """This process's fraction ``[lo, hi)`` of the global batch's rows
    (``distributed.py:140`` of the JAX package)."""
    pi = _pi() if process_index is None else int(process_index)
    pc = _pc() if process_count is None else int(process_count)
    return pi / pc, (pi + 1) / pc


def make_global_batch(mesh, *host_arrays, data_axis: int = 0):
    """This process's rows of a global batch as tensors on the mesh's
    first device (``distributed.py:156`` of the JAX package): each
    process passes its own ``global_rows / process_count`` rows along
    ``data_axis`` (``data_axis=1`` for the stacked ``(K, B, ...)`` groups
    of ``train_steps``), and a gang engine treats them as the data ranks
    of this process. In one process they are the whole batch."""
    import torch

    dev = mesh.devices[0][0]
    out = []
    for a in host_arrays:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if t.shape[data_axis] % len(mesh.devices):
            raise ValueError(
                f"batch axis {data_axis} ({t.shape[data_axis]}) must split "
                f"over this process's {len(mesh.devices)} data ranks"
            )
        out.append(t.to(dev))
    return tuple(out)


def shard_sentences_for_process(
    sentences, process_index: Optional[int] = None,
    process_count: Optional[int] = None,
):
    """Round-robin sentence split across processes: rank ``pi`` takes
    sentences ``pi, pi + pc, ...``, every rank the same count (the
    remainder ``len % pc`` is dropped), so ranks dispatch near-equal step
    counts."""
    pi = _pi() if process_index is None else process_index
    pc = _pc() if process_count is None else process_count
    per = len(sentences) // pc
    return [sentences[i * pc + pi] for i in range(per)]


def _pi() -> int:
    return process_index()


def _pc() -> int:
    return process_count()


def _gather_sentences(ids: np.ndarray, offsets: np.ndarray,
                      picks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The flat ``(ids, offsets)`` of sentences ``picks`` in that order."""
    lens = np.diff(offsets)
    my_lens = lens[picks]
    out_offsets = np.zeros(len(picks) + 1, dtype=np.int64)
    np.cumsum(my_lens, out=out_offsets[1:])
    total = int(my_lens.sum())
    src_start = np.repeat(offsets[picks], my_lens)
    pos_in_sent = np.arange(total, dtype=np.int64) - np.repeat(
        out_offsets[:-1], my_lens
    )
    out_ids = np.ascontiguousarray(ids[src_start + pos_in_sent], dtype=np.int32)
    return out_ids, out_offsets


def shard_flat_for_process(
    ids: np.ndarray,
    offsets: np.ndarray,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`shard_sentences_for_process` on the flat ``(ids, offsets)``
    corpus: the same round-robin split and equal counts, vectorized."""
    pi = _pi() if process_index is None else process_index
    pc = _pc() if process_count is None else process_count
    per = (len(offsets) - 1) // pc
    return _gather_sentences(ids, offsets, np.arange(per) * pc + pi)


def shard_flat_locality(
    ids: np.ndarray,
    offsets: np.ndarray,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Locality split: sentences sorted (stably) by their rarest token,
    the largest id under the frequency-ordered vocabulary, then cut into
    ``process_count`` contiguous runs balanced by word count, each rank's
    run kept in corpus order. Tail rows then concentrate on one rank,
    which shrinks the touched-row sets every exchange ships. Ranks may
    differ by a sentence in word count; the exchange's lockstep fillers
    absorb the skew."""
    pi = _pi() if process_index is None else process_index
    pc = _pc() if process_count is None else process_count
    n = len(offsets) - 1
    if n == 0 or pc == 1:
        return (np.ascontiguousarray(ids, dtype=np.int32),
                np.asarray(offsets, dtype=np.int64))
    lens = np.diff(offsets)
    nonempty = lens > 0
    # Segment max over the flat ids; an empty sentence keys -1 and sorts
    # first, into rank 0's run.
    seg_max = np.zeros(n, dtype=np.int64)
    if len(ids):
        starts = np.minimum(offsets[:-1], len(ids) - 1)
        seg_max = np.maximum.reduceat(ids.astype(np.int64), starts)
    keys = np.where(nonempty, seg_max, -1)
    order = np.argsort(keys, kind="stable")
    cum = np.cumsum(lens[order])
    total = int(cum[-1])
    bounds = (total * np.arange(pc + 1)) // pc
    assign = np.searchsorted(bounds[1:-1], cum, side="left")
    picks = order[assign == pi]
    picks.sort()
    return _gather_sentences(ids, offsets, picks)


def per_process_word_counts(
    sentence_lengths: np.ndarray, process_count: int
) -> np.ndarray:
    """Word count of each rank's round-robin shard, from the sentence
    lengths alone: every rank computes every rank's count with no
    communication."""
    lens = np.asarray(sentence_lengths, dtype=np.int64)
    pc = int(process_count)
    per = len(lens) // pc
    return np.array(
        [int(lens[pi: per * pc: pc].sum()) for pi in range(pc)],
        dtype=np.int64,
    )


def shard_span(
    n_items: int, process_index: int, process_count: int
) -> Tuple[int, int]:
    """Contiguous, balanced ``[start, end)`` span for one rank over
    ``n_items``: every item is covered exactly once, the first
    ``n_items % process_count`` ranks take one extra. A pure function of
    its three arguments, so every rank and every resume derives the same
    split with no coordination."""
    if process_count < 1:
        raise ValueError("process_count must be >= 1")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"{process_count} processes"
        )
    if n_items < 0:
        raise ValueError("n_items must be >= 0")
    q, r = divmod(n_items, process_count)
    start = process_index * q + min(process_index, r)
    return start, start + q + (1 if process_index < r else 0)
