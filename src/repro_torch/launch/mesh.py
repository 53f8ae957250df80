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
POD_AXES = ("pod",) + AXES


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``([pod,] data, shard, model)`` grid of ranks;
    ``rank = ((p * data + d) * shard + s) * model + t``. The groups are
    ``repro_torch.dist.comm.Group`` objects (``None`` in a world of one);
    ``nodes_group`` spans ``(pod, data)``, the decentralized nodes' axes
    (the ``data_group`` itself without a pod axis)."""

    data: int
    shard: int
    rank: int = 0
    device: Any = None
    data_group: Any = None
    shard_group: Any = None
    model: int = 1
    model_group: Any = None
    pod: int = 1
    pod_group: Any = None
    nodes_group: Any = None

    def __post_init__(self):
        if min(self.pod, self.data, self.shard, self.model) < 1:
            raise ValueError(f"mesh axes must be >= 1, got pod {self.pod} data {self.data} "
                             f"shard {self.shard} model {self.model}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.size} ranks")

    @property
    def axis_names(self) -> tuple:
        """The JAX mesh's axis names: a ``pod`` axis only on a multi-pod mesh."""
        return POD_AXES if self.pod > 1 else AXES

    @property
    def shape(self) -> dict:
        out = {"data": self.data, "shard": self.shard, "model": self.model}
        return {"pod": self.pod, **out} if self.pod > 1 else out

    @property
    def size(self) -> int:
        return self.pod * self.data * self.shard * self.model

    @property
    def nodes(self) -> int:
        """The ranks over the node axes ``(pod, data)``."""
        return self.pod * self.data

    @property
    def node_rank(self) -> int:
        """This rank's flattened ``(pod, data)`` index, ``p * data + d``."""
        return self.rank // (self.shard * self.model)

    @property
    def pod_rank(self) -> int:
        return self.node_rank // self.data

    @property
    def data_rank(self) -> int:
        return self.node_rank % self.data

    @property
    def shard_rank(self) -> int:
        return self.rank // self.model % self.shard

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def global_rank(self, node_rank: int, shard_rank: Optional[int] = None,
                    model_rank: Optional[int] = None) -> int:
        """The rank at flattened node index ``node_rank`` (``p * data +
        d``; the data rank on a mesh without pods) and ``(shard_rank,
        model_rank)`` (this rank's by default)."""
        s = self.shard_rank if shard_rank is None else shard_rank
        t = self.model_rank if model_rank is None else model_rank
        return (node_rank * self.shard + s) * self.model + t


def _axis_groups(pod: int, data: int, shard: int, model: int, rank: int, make):
    """This rank's group of every axis, ``make(axes, ranks)`` building one
    group a call; every axis instance is made, in the same order on every
    rank (``new_group`` is collective)."""
    at = lambda p, d, s, t: ((p * data + d) * shard + s) * model + t  # noqa: E731
    me = {}
    coords = [(p, d, s, t) for p in range(pod) for d in range(data)
              for s in range(shard) for t in range(model)]
    mine = coords[rank]
    axes = {"model": 3, "shard": 2, "data": 1}
    if pod > 1:
        axes["pod"] = 0
    for name, dim in axes.items():
        seen = set()
        for c in coords:
            key = c[:dim] + c[dim + 1:]
            if key in seen:
                continue
            seen.add(key)
            ranks = tuple(at(*(c[:dim] + (i,) + c[dim + 1:]))
                          for i in range((pod, data, shard, model)[dim]))
            g = make((name,), ranks)
            if mine[:dim] + mine[dim + 1:] == key:
                me[name] = g
    if pod > 1:
        seen = set()
        for c in coords:
            key = c[2:]
            if key in seen:
                continue
            seen.add(key)
            ranks = tuple(at(p, d, *key) for p in range(pod) for d in range(data))
            g = make(("pod", "data"), ranks)
            if mine[2:] == key:
                me["nodes"] = g
    else:
        me["nodes"] = me["data"]
    return me


def _mesh_of(pod, data, shard, model, rank, device, make) -> "Mesh":
    g = _axis_groups(pod, data, shard, model, rank, make)
    return Mesh(data, shard, rank, torch.device(device), data_group=g["data"],
                shard_group=g["shard"], model=model, model_group=g["model"], pod=pod,
                pod_group=g.get("pod"), nodes_group=g["nodes"])


def virtual_mesh(*, pod: int = 1, data: int = 1, shard: int = 1, model: int = 1,
                 rank: int = 0, device="meta") -> Mesh:
    """Rank ``rank``'s view of a mesh in one process, with no world:
    every group is virtual (``comm.Group.pg`` None), so its collectives
    are recorded and answered in process, on meta tensors. The checker's
    lanes and the dry run run each rank's view of a mesh this way."""
    from repro_torch.dist.comm import Group

    def make(axes, ranks):
        return Group(axes, ranks, ranks.index(rank) if rank in ranks else -1)

    return _mesh_of(pod, data, shard, model, rank, device, make)


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


def make_mesh(*, shard: int = 1, model: int = 1, multi_pod: bool = False,
              device="cuda") -> Mesh:
    """The ``(W / (shard * model), shard, model)`` mesh of the
    initialized world (a world of one when none is initialized);
    ``multi_pod``: the JAX production mesh's two pods,
    ``(2, W / (2 * shard * model), shard, model)``. Every rank must call
    it, in the same order as every other ``new_group``."""
    import torch.distributed as dist

    if shard < 1 or model < 1:
        raise ValueError(f"shard and model factors must be >= 1, got {shard} and {model}")
    pod = 2 if multi_pod else 1
    if not (dist.is_available() and dist.is_initialized()):
        if shard * model * pod != 1:
            raise ValueError(
                f"a pod x shard x model grid of {pod} x {shard} x {model} needs a world of "
                "ranks; no process group is initialized (launch under torchrun or "
                "init_world)")
        return Mesh(1, 1, 0, torch.device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % (shard * model * pod):
        raise ValueError(
            f"a world of {world} ranks does not split into {pod} pod(s) of shard groups "
            f"of {shard} x model groups of {model}")
    data = world // (shard * model * pod)
    from repro_torch.dist.comm import Group

    def make(axes, ranks):
        return Group(axes, ranks, ranks.index(rank) if rank in ranks else -1,
                     dist.new_group(list(ranks)))

    return _mesh_of(pod, data, shard, model, rank, device, make)


def make_test_mesh(data: int = 1, shard: int = 1, model: int = 1, *, pod: int = 1,
                   device="cpu") -> Mesh:
    """A mesh for the tests: a world of one in process (no process
    group), or the mesh of an initialized world of ``pod * data * shard
    * model`` ranks (the mismatch raises); ``pod`` 2 is the JAX test
    mesh's ``multi_pod=True`` shape."""
    import torch.distributed as dist

    n = pod * data * shard * model
    if n == 1 and not dist.is_initialized():
        return Mesh(1, 1, 0, torch.device(device))
    if pod not in (1, 2):
        raise ValueError(f"a test mesh has 1 or 2 pods, not {pod}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"a ({pod}, {data}, {shard}, {model}) test mesh needs {n} ranks, "
            f"the world has {world}")
    return make_mesh(shard=shard, model=model, multi_pod=pod == 2, device=device)


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
