"""The device mesh of the port (counterpart of
``glint_word2vec_tpu/parallel/mesh.py``).

The reference's deployment geometry, ``numPartitions`` workers x
``numParameterServers`` servers, is a ("data", "model") grid of devices:

  axis "data"  (num_partitions): the rows of every minibatch are split
               here; each data rank computes the forward pass of its
               slice.
  axis "model" (num_shards): both tables are split here, by vocabulary
               rows (``rows`` layout) or by embedding columns (``dims``
               layout); each model shard is one "parameter server".

The port runs the mesh from one process (single controller): a
:class:`Mesh` is a grid of ``torch.device`` entries, a table is one tensor
per model shard on the device of that shard's first data rank, and the
collectives are explicit functions: :func:`psum` sums per-shard partials
in shard order (the model axis), :func:`all_gather` concatenates per-rank
pieces in rank order (the data axis). A device may repeat in the grid:
``["cpu"] * 8`` in the tests, or ``["cuda:0"] * 4`` on one card, is the
port's counterpart of JAX's forced host device count. Across processes
only the data axis is split (``parallel/distributed.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(num_data, num_model)`` grid of ``torch.device`` entries."""

    def __init__(self, grid: Sequence[Sequence], process_index: int = 0,
                 process_count: int = 1):
        rows = [tuple(torch.device(d) for d in row) for row in grid]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangular device grid")
        #: This process's rows of the grid: all of it in one process; in a
        #: gang (``distributed.make_global_mesh``) the data ranks
        #: ``process_index * len(devices)`` on, the other processes
        #: holding the rest.
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(rows)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices) * self.process_count,
                MODEL_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def model_devices(self) -> Tuple[torch.device, ...]:
        """The device of each model shard (its first data rank's)."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices[0]]}...)"


def _visible_cards() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * k to build "
            "a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    num_data: Optional[int] = None,
    num_model: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over ``devices`` (the visible CUDA
    cards by default; raises when there are none, never gives way to the
    CPU).

    Defaults: every device on the model axis unless sizes are given; with
    one size given, the other divides the device count. With both, the
    first ``num_data * num_model`` devices are used."""
    devs = list(devices) if devices is not None else _visible_cards()
    n = len(devs)
    if num_data is None and num_model is None:
        num_data, num_model = 1, n
    elif num_data is None:
        if n % num_model:
            raise ValueError(f"{n} devices not divisible by num_model={num_model}")
        num_data = n // num_model
    elif num_model is None:
        if n % num_data:
            raise ValueError(f"{n} devices not divisible by num_data={num_data}")
        num_model = n // num_data
    if num_data < 1 or num_model < 1:
        raise ValueError("mesh axes must be >= 1")
    if num_data * num_model > n:
        raise ValueError(
            f"mesh {num_data}x{num_model} needs more than the {n} available devices"
        )
    return Mesh([devs[r * num_model:(r + 1) * num_model]
                 for r in range(num_data)])


class Sharding(NamedTuple):
    """Where an array lives on a mesh: one axis name (or None) per array
    dimension, as JAX's ``PartitionSpec``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def table_sharding(mesh: Mesh) -> Sharding:
    """Vocabulary rows split over "model", columns whole (``rows``)."""
    return Sharding(mesh, (MODEL_AXIS, None))


def table_sharding_dims(mesh: Mesh) -> Sharding:
    """Every row, columns split over "model" (``dims``): model-axis
    traffic is the psum of scalar logit partials."""
    return Sharding(mesh, (None, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> Sharding:
    """Minibatch rows split over "data", whole on "model"."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


def psum(parts: Sequence[torch.Tensor],
         device: Optional[torch.device] = None) -> torch.Tensor:
    """The model-axis sum of per-shard partials, added in shard order on
    ``device`` (the first part's by default)."""
    dev = parts[0].device if device is None else device
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The data-axis gather: per-rank pieces concatenated in rank order
    along ``dim`` on ``device`` (the first piece's by default)."""
    dev = parts[0].device if device is None else device
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=dim)
