"""Logical-axis sharding rules, and the node and shard counts of a mesh.

The port of ``repro.dist.sharding``. Parameters are declared with
*logical* axis names (``repro_torch.models.module``); a ``ShardingRules``
maps each name to a mesh axis or to ``None`` (replicated), and
``logical_to_pspec`` resolves a leaf's names to the port's form of a
PartitionSpec: a tuple with one mesh-axis name or ``None`` per dim.
Rule construction is config-aware, as in the JAX package: a logical dim
maps to the ``model`` axis only where the config dimension divides the
axis size, and a mesh axis is used at most once per spec (the earlier
dim wins), so ``kv_heads=2`` at ``model`` 4 stays replicated.

``use_rules`` makes rules current (a thread-local stack) and
``current_rules`` reads them: the model's one source of its
tensor-parallel context (``repro_torch.models.tp``), its parameter and
cache shapes included. ``bound`` and ``checkpoint`` carry them into code
that autograd runs later on its own thread (a checkpoint's
recomputation). The port has no GSPMD: the model runs its sharded layers
explicitly. With no rules active, or a ``model`` axis
of 1, the model runs exactly as it does on one device.

The node and shard counts (``num_nodes``, ``num_shards``,
``node_range``) are the one authority every layer asks. On the port's
mesh (``repro_torch.launch.mesh.Mesh``) the nodes are stacked per data
rank, so the node count is the run's, checked against the mesh: it must
split evenly over the data ranks. The JAX package's ``pod`` axis and
``sequence_parallel`` (the ``seq_res`` residual split) belong to the
dry run's mesh, the last item of ROADMAP queue 1, and raise here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]

NEXT_ITEM = "ROADMAP queue 1, item 15: the dry run's mesh and the collective checks"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus the logical-name -> mesh-axis mapping."""

    mesh: object
    mapping: Dict[str, AxisVal]

    def axis(self, name: Optional[str]) -> AxisVal:
        if name is None:
            return None
        return self.mapping.get(name)

    @property
    def tp(self) -> int:
        """The size of the ``model`` axis (1 on a mesh without one)."""
        return int(_shape(self.mesh).get("model", 1))


# ---------------------------------------------------------------------------
# Current-rules context (thread-local)
# ---------------------------------------------------------------------------
_STATE = threading.local()


def current_rules() -> Optional[ShardingRules]:
    """The innermost active ``use_rules`` rules, or None outside any."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` current for the model's tensor-parallel layers
    (``None`` leaves the current rules as they are)."""
    if rules is None:
        yield current_rules()
        return
    stack = _STATE.__dict__.setdefault("stack", [])
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


@contextlib.contextmanager
def no_rules():
    """Run without rules (the whole model) inside an active ``use_rules``."""
    stack = _STATE.__dict__.setdefault("stack", [])
    stack.append(None)
    try:
        yield
    finally:
        stack.pop()


def bound(fn):
    """``fn`` run under the rules current now, wherever and whenever it is
    called: autograd runs the backward of CUDA tensors, and with it the
    recomputation of a checkpointed forward, on a thread of its own, where
    the caller's thread-local rules are not current."""
    rules = current_rules()
    if rules is None:
        return fn

    def run(*args, **kwargs):
        with use_rules(rules):
            return fn(*args, **kwargs)

    return run


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)``, recomputed in the
    backward under the rules current now (``bound``)."""
    from torch.utils.checkpoint import checkpoint as remat

    return remat(bound(fn), *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------
def _shape(mesh) -> dict:
    return dict(mesh.shape)


def _axes_size(mesh, ax: AxisVal) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= _shape(mesh)[a]
        return n
    return _shape(mesh)[ax]


def logical_to_pspec(axes: Sequence[Optional[str]], rules: ShardingRules,
                     shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve a tuple of logical axis names to a spec tuple.

    When ``shape`` is given, any mapping whose shard count does not
    divide the dim is dropped (replicated). A mesh axis may appear only
    once in a spec; on conflict the earlier dim wins."""
    used: set = set()
    parts = []
    for i, name in enumerate(axes):
        ax = rules.axis(name)
        if ax is not None and shape is not None:
            if shape[i] % _axes_size(rules.mesh, ax):
                ax = None
        if ax is not None:
            flat = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
            if used & set(flat):
                ax = None
            else:
                used |= set(flat)
        parts.append(tuple(ax) if isinstance(ax, list) else ax)
    return tuple(parts)


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the ``model`` axis, or None."""
    for i, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i
    return None


def param_pspecs(axes_tree, rules: ShardingRules):
    """A logical-axes tree (leaves: tuples of names) to spec tuples."""
    if isinstance(axes_tree, dict):
        return {k: param_pspecs(v, rules) for k, v in axes_tree.items()}
    return logical_to_pspec(axes_tree, rules)


# ---------------------------------------------------------------------------
# Node and shard counts
# ---------------------------------------------------------------------------
def num_nodes(mesh, nodes: int, *, multi_pod: bool = False) -> int:
    """``nodes``, checked against ``mesh``: a multi-pod run and a node
    count that does not split over the data ranks raise."""
    if multi_pod:
        raise ValueError(f"multi_pod=True but the port's mesh has no 'pod' axis ({NEXT_ITEM})")
    if nodes < 1 or nodes % mesh.data:
        raise ValueError(
            f"{nodes} nodes do not split evenly over {mesh.data} data ranks")
    return int(nodes)


def num_shards(mesh) -> int:
    """FSDP shard count of ``mesh``: the size of its ``shard`` axis."""
    return int(mesh.shard)


def node_range(mesh, nodes: int) -> Tuple[int, int]:
    """``(lo, hi)``: the consecutive nodes this rank's data rank holds."""
    per = num_nodes(mesh, nodes) // mesh.data
    lo = mesh.data_rank * per
    return lo, lo + per


def collective(name: str):
    """``torch.distributed``'s ``all_gather_single`` /
    ``reduce_scatter_single`` where torch has them (newer releases
    deprecate the ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
    spellings), else the older names: the same collectives."""
    import torch.distributed as dist

    old = {"all_gather_single": "all_gather_into_tensor",
           "reduce_scatter_single": "reduce_scatter_tensor"}[name]
    return getattr(dist, name, None) or getattr(dist, old)


# ---------------------------------------------------------------------------
# Config-aware rule construction
# ---------------------------------------------------------------------------
def rules_for_config(mesh, cfg, *, batch_axes: AxisVal, nodes: AxisVal = None,
                     sequence_parallel: bool = False) -> ShardingRules:
    """The logical -> mesh-axis mapping of one config on one mesh (the
    JAX package's, name for name). ``mesh`` needs only ``axis_names``
    and ``shape``."""
    if sequence_parallel:
        raise ValueError(f"sequence_parallel (the seq_res split) is not ported ({NEXT_ITEM})")
    if "pod" in tuple(mesh.axis_names):
        raise ValueError(f"the 'pod' axis is not ported ({NEXT_ITEM})")
    model_ax = "model" if "model" in tuple(mesh.axis_names) else None
    tp = _shape(mesh)[model_ax] if model_ax else 1

    def div(n: int) -> bool:
        return model_ax is not None and n > 0 and n % tp == 0

    heads_ok = div(cfg.num_heads)
    kv_ok = div(cfg.num_kv_heads)
    ffn_dims = [d for d in (cfg.d_ff, cfg.moe_d_ff or cfg.d_ff) if d > 0]
    ffn_ok = bool(ffn_dims) and all(div(d) for d in ffn_dims)
    d_inner = cfg.ssm_expand * cfg.d_model
    ssm_hd = cfg.ssm_head_dim or 64
    ssm_heads = cfg.ssm_num_heads or d_inner // ssm_hd

    mapping: Dict[str, AxisVal] = {
        # activations
        "batch": batch_axes,
        "seq": None,
        "seq_res": None,
        "embed": None,
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "kv_seq": None,
        "vocab": "model" if div(cfg.padded_vocab) else None,
        "ffn": "model" if ffn_ok else None,
        "ssm_heads": "model" if cfg.ssm_state_dim and div(ssm_heads) else None,
        # parameters
        "heads_proj": "model" if heads_ok else None,
        "kv_proj": "model" if kv_ok else None,
        "q_in": "model" if (not heads_ok and div(cfg.d_model)) else None,
        "kv_in": "model" if (not kv_ok and div(cfg.d_model)) else None,
        "experts": "model" if div(cfg.moe_num_experts) else None,
        "ssm_inner": "model" if cfg.ssm_state_dim and div(d_inner) else None,
        "layers": None,
        # decentralized node axis (train only; None for serving)
        "nodes": nodes,
    }
    return ShardingRules(mesh=mesh, mapping=mapping)


def serve_rules(mesh, cfg) -> ShardingRules:
    """Serving: batch over the data axis, weights tensor-parallel."""
    return rules_for_config(mesh, cfg, batch_axes="data", nodes=None)


def train_rules(mesh, cfg, *, sequence_parallel: bool = False) -> ShardingRules:
    """Decentralized training: the stacked node dim over the data axis;
    each node's local batch stays unsharded (per-node data)."""
    return rules_for_config(mesh, cfg, batch_axes=None, nodes="data",
                            sequence_parallel=sequence_parallel)
