"""The mesh: a ``(data, shard, model)`` grid of ``torch.distributed`` ranks.

The port of ``repro.launch.mesh``. The JAX mesh puts one node on each
device of the ``data`` axis, one replica shard on each device of the
``shard`` axis and one tensor-parallel slice on each device of the
``model`` axis. The port keeps its one-card layout for the nodes, the m
nodes stacked on a leading dim, and lays a world of ``R_data x S x T``
processes over three axes, ``model`` innermost as on the JAX mesh, rank
``= (d * S + s) * T + t``:

* ``data``: the m nodes split evenly over the ``R_data`` data ranks;
  data rank d holds the ``m / R_data`` consecutive nodes
  ``d * m / R_data ..`` stacked. A matching whose partners sit on two
  data ranks exchanges through a paired send/recv
  (``repro_torch.dist.gossip.NodeAxis``).
* ``shard``: the S ranks of one data rank each keep one contiguous
  ``1 / S`` slice of every bucket of their nodes' fp32 replicas
  (``repro_torch.dist.fsdp``). Shard s of node i and shard s of its
  partner sit on ranks with the same s, so gossip never crosses the
  shard axis.

One process group per axis instance: ``shard_group`` holds the S ranks
of this rank's data rank (all-gather, reduce-scatter, the loss mean),
``data_group`` the ``R_data`` ranks of this rank's shard index (the
consensus reductions); the gossip pairs use global ranks.

A world of one (no process group) is a valid mesh: every collective is
then the identity. ``make_mesh`` builds the mesh of an initialized
world; ``init_world`` initializes one from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from an
explicit rank, size and init method (the CLIs' own spawn uses a file
store in a temporary directory). The backend is gloo on the CPU and
NCCL on the card, one card a rank, unless the caller names one: a world
of several ranks on one card names gloo (``backend="gloo"``), whose
``all_reduce`` and ``broadcast`` take CUDA tensors; its ranks then share
the host's cards round robin.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

AXES = ("data", "shard", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, shard, model)`` grid of ranks;
    ``rank = (d * shard + s) * model + t``."""

    data: int
    shard: int
    rank: int = 0
    device: Any = None
    data_group: Any = None
    shard_group: Any = None
    model: int = 1
    model_group: Any = None

    axis_names = AXES

    def __post_init__(self):
        if self.data < 1 or self.shard < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data {self.data} shard "
                             f"{self.shard} model {self.model}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.size} ranks")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "shard": self.shard, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.shard * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // (self.shard * self.model)

    @property
    def shard_rank(self) -> int:
        return self.rank // self.model % self.shard

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def global_rank(self, data_rank: int, shard_rank: Optional[int] = None,
                    model_rank: Optional[int] = None) -> int:
        """The rank at ``(data_rank, shard_rank, model_rank)`` (this
        rank's shard and model indices by default)."""
        s = self.shard_rank if shard_rank is None else shard_rank
        t = self.model_rank if model_rank is None else model_rank
        return (data_rank * self.shard + s) * self.model + t


def backend_for(device) -> str:
    """The default backend: NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank: int, *, share: bool = False) -> torch.device:
    """One card a rank: ``cuda:LOCAL_RANK`` on the card (exits naming
    both counts when the host has fewer cards than ranks), the CPU
    otherwise. ``share``: ranks share the cards round robin (a gloo
    world on fewer cards than ranks)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    from repro_torch.device import resolve_device

    resolve_device("cuda")
    cards = torch.cuda.device_count()
    if share:
        return torch.device("cuda", local_rank % cards)
    if local_rank >= cards:
        raise SystemExit(
            f"local rank {local_rank} needs a card of its own but this host has "
            f"{cards} CUDA card(s): run at most {cards} ranks a host"
        )
    return torch.device("cuda", local_rank)


def init_world(device, *, rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, local_rank: Optional[int] = None,
               backend: Optional[str] = None):
    """Initialize the default process group and return this rank's
    device. With no arguments the ``torchrun`` environment variables
    name the world; otherwise ``rank``, ``world_size`` and
    ``init_method`` (``file://...`` or ``tcp://localhost:PORT``) do.
    ``backend``: ``backend_for(device)`` unless named; gloo on the card
    lets ranks share a card."""
    import torch.distributed as dist

    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    local_rank = rank if local_rank is None else local_rank
    backend = backend or backend_for(device)
    dev = rank_device(device, local_rank, share=backend == "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if dev.type == "cuda" and backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            rank=rank, world_size=world_size, **kw)
    return dev


def make_mesh(*, shard: int = 1, model: int = 1, device="cpu") -> Mesh:
    """The ``(W / (shard * model), shard, model)`` mesh of the
    initialized world (a world of one when none is initialized). Every
    rank must call it, in the same order as every other ``new_group``."""
    import torch.distributed as dist

    if shard < 1 or model < 1:
        raise ValueError(f"shard and model factors must be >= 1, got {shard} and {model}")
    if not (dist.is_available() and dist.is_initialized()):
        if shard * model != 1:
            raise ValueError(
                f"a shard x model grid of {shard} x {model} needs a world of ranks; no "
                "process group is initialized (launch under torchrun or init_world)")
        return Mesh(1, 1, 0, torch.device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % (shard * model):
        raise ValueError(
            f"a world of {world} ranks does not split into shard groups of {shard} "
            f"x model groups of {model}")
    data = world // (shard * model)

    def at(d, s, t):
        return (d * shard + s) * model + t

    model_groups = {(d, s): dist.new_group([at(d, s, t) for t in range(model)])
                    for d in range(data) for s in range(shard)}
    shard_groups = {(d, t): dist.new_group([at(d, s, t) for s in range(shard)])
                    for d in range(data) for t in range(model)}
    data_groups = {(s, t): dist.new_group([at(d, s, t) for d in range(data)])
                   for s in range(shard) for t in range(model)}
    me = Mesh(data, shard, rank, torch.device(device), model=model)
    d, s, t = me.data_rank, me.shard_rank, me.model_rank
    return dataclasses.replace(me, data_group=data_groups[(s, t)],
                               shard_group=shard_groups[(d, t)],
                               model_group=model_groups[(d, s)])


def make_test_mesh(data: int = 1, shard: int = 1, model: int = 1, *, device="cpu") -> Mesh:
    """A mesh for the tests: a world of one in process (no process
    group), or the mesh of an initialized world of ``data * shard *
    model`` ranks (the mismatch raises)."""
    import torch.distributed as dist

    if data * shard * model == 1 and not dist.is_initialized():
        return Mesh(1, 1, 0, torch.device(device))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * shard * model:
        raise ValueError(
            f"a ({data}, {shard}, {model}) test mesh needs {data * shard * model} ranks, "
            f"the world has {world}")
    return make_mesh(shard=shard, model=model, device=device)


def spawn(fn, nprocs: int, device, args=(), *, share: bool = False) -> None:
    """Run ``fn(rank, nprocs, init_method, *args)`` in ``nprocs`` local
    processes joined through a file store in a temporary directory (the
    launch of ``--shard S`` / ``--model-par T`` without torchrun). On the
    card each rank needs a card of its own, fewer cards exit naming both
    counts, unless ``share`` (a gloo world whose ranks share the cards).
    ``fn`` must be importable (a module-level function)."""
    import tempfile

    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from repro_torch.device import resolve_device

        try:
            resolve_device("cuda")
        except RuntimeError as err:
            raise SystemExit(str(err)) from None
        cards = torch.cuda.device_count()
        if cards < nprocs and not share:
            raise SystemExit(
                f"{nprocs} ranks need one CUDA card each, but this host has {cards} card(s)")
    # CPU ranks share the host's cores rather than each taking them all
    # (OMP_NUM_THREADS, when set, decides instead)
    threads = 0
    if torch.device(device).type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned, args=(fn, nprocs, f"file://{tmp}/store", tuple(args),
                                           threads),
                           nprocs=nprocs, join=True, start_method="spawn")


def _spawned(rank: int, fn, nprocs: int, init_method: str, args, threads: int = 0) -> None:
    if threads:
        torch.set_num_threads(threads)
    fn(rank, nprocs, init_method, *args)


def torchrun_world() -> int:
    """The world size ``torchrun`` set (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


# the node/shard-count authorities live at the dist layer
from repro_torch.dist.sharding import num_nodes, num_shards  # noqa: E402,F401
