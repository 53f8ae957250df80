"""What a call costs, read off meta tensors: the port's counterpart of
XLA's ``memory_analysis()`` / ``cost_analysis()``.

``CostMode`` is a ``TorchDispatchMode``. Inside it, every aten op of a
call on meta tensors (shapes and dtypes, no data, no card) is seen once,
and the mode records:

* **FLOPs by dtype.** Matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, the ``_scaled_dot_product_*`` family) exactly, 2 flops a
  multiply-add; ops tagged pointwise one flop per floating output
  element; each
  hand-written kernel its own ``cost(...)``, which its wrapper's meta
  branch reports (``repro_torch.kernels.meta``). Reductions, indexing,
  copies and views count none.
* **Bytes accessed.** Each computing op's input and output bytes (views
  and allocations none); each kernel its ``cost(...)`` bytes.
* **Resident bytes** (``argument_bytes``): everything live when
  :meth:`CostMode.mark_resident` is called, the state that exists before
  the call.
* **Peak live bytes.** Every new output *storage* is added once, as the
  CUDA caching allocator books it (:func:`rounded`; views share their base's
  storage; in-place ops make none), and taken off when the storage is
  freed: a ``weakref.finalize`` on ``untyped_storage()``, which lives as
  long as any tensor over it, so what autograd saves stays live until the
  backward frees it. The peak is the largest sum seen.
* **Kernel launches** by wrapper, and the ops the step checks read
  (``float64_ops``: ops with a float64 tensor on the device, not host
  constants made in float64; ``gathers``: each ``index_select``'s dim
  and index length; ``max_fp_elements``: the largest floating output
  of an op, the memory-ladder check's intermediate).

Only tensors on the traced device (``meta``) count toward memory. The
mode itself costs nothing on the card: it runs where no card is.
"""
from __future__ import annotations

import collections
import functools
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import meta as kernel_meta

aten = torch.ops.aten
ALLOC_ROUND = 512          # the caching allocator's block granularity
LARGE_REQUEST = 10 << 20   # above it a request gets a segment of its own
SEGMENT_ROUND = 2 << 20    # such a segment's granularity
SPLIT_REMAINDER = 1 << 20  # a large block is split only when more remains

_SDPA = tuple(
    getattr(aten, name) for name in (
        "_scaled_dot_product_flash_attention",
        "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_cudnn_attention",
        "_scaled_dot_product_flash_attention_for_cpu",
    ) if hasattr(aten, name)
)
_SDPA_BWD = tuple(
    getattr(aten, name) for name in (
        "_scaled_dot_product_flash_attention_backward",
        "_scaled_dot_product_efficient_attention_backward",
        "_scaled_dot_product_cudnn_attention_backward",
        "_scaled_dot_product_flash_attention_for_cpu_backward",
    ) if hasattr(aten, name)
)
_NO_BYTES = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh"}


@functools.lru_cache(maxsize=None)
def _composite_only(func) -> bool:
    """True for an op with no kernel of its own on the card, which runs
    its composite decomposition there (``matmul``, ``einsum``); false for
    one with a CUDA kernel (``silu_backward``: one fused kernel on the
    card, whose decomposition would allocate temporaries the card does
    not)."""
    name = func.name()
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    # a build without CUDA registers no CUDA kernels: a CPU or meta kernel
    # marks an op that has a backend kernel of its own just as well
    return not any(has(name, key) for key in
                   ("CUDA", "CPU", "Meta", "CompositeExplicitAutograd"))


def rounded(nbytes: int) -> int:
    """``nbytes`` as PyTorch's CUDA caching allocator books it when it
    serves the request from a fresh segment: rounded up to 512 bytes; a
    request of more than 10 MiB gets a segment rounded up to 2 MiB, which
    it keeps whole when less than 1 MiB would be left over (the allocator
    splits a large block only when more than 1 MiB remains)."""
    size = -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND
    if size > LARGE_REQUEST:
        segment = -(-size // SEGMENT_ROUND) * SEGMENT_ROUND
        if segment - size <= SPLIT_REMAINDER:
            return segment
    return size


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def matmul_flops(func, args, out) -> int:
    """Exact flops of a matrix-product op, 0 for any other op."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet in _SDPA:
        q, k = args[0], args[1]             # (B, H, S, hd)
        return 4 * _numel(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    if packet in _SDPA_BWD:
        q, k = args[1], args[2]
        return 8 * _numel(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    return 0


class CostMode(TorchDispatchMode):
    """Record the cost of everything run inside ``with CostMode() as cm:``
    on meta tensors (see the module docstring). Build the state inside
    it, then call :meth:`mark_resident` before the call."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.flops: Dict[str, int] = collections.Counter()
        self.kernel_flops: Dict[str, int] = collections.Counter()
        self.matmul_flops = 0
        self.bytes_accessed = 0
        self.kernel_bytes = 0
        self.launches: Dict[str, int] = collections.Counter()
        self.argument_bytes = 0
        self.output_bytes = 0          # set by the caller once the call returned
        self.resident_storages = 0
        self.resident_large = 0
        self.live = 0
        self.peak = 0
        self.float64_ops: List[str] = []
        self.gathers: List[Tuple[int, int]] = []
        self.max_fp_elements = 0       # the largest floating op output (elements)
        self._sizes: Dict[int, int] = {}

    # -- storages --------------------------------------------------------
    def _own(self, t: torch.Tensor) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.device_type

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _add(self, t: torch.Tensor) -> None:
        """Book t's storage if it is new (or grew)."""
        st = t.untyped_storage()
        key, n = st._cdata, rounded(st.nbytes())
        old = self._sizes.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
        elif n <= old:
            return
        self._sizes[key] = n
        self.live += n - (old or 0)
        self.peak = max(self.peak, self.live)

    def mark_resident(self) -> int:
        """Take everything live now as the resident state and start the
        peak from it: the point where a run on the card reads
        ``memory_allocated`` and resets its peak statistics (for state
        built inside the mode). Returns the resident bytes."""
        self.argument_bytes = self.live
        self.resident_storages = len(self._sizes)
        self.resident_large = sum(n > LARGE_REQUEST for n in self._sizes.values())
        self.peak = self.live
        return self.live

    def resident_slack(self) -> int:
        """How far the card's ``memory_allocated`` may sit from the
        resident bytes by the allocator's rounding alone: 512 bytes a
        storage, and up to 1 MiB more for each large one, whose block the
        allocator keeps whole or splits depending on the cached blocks it
        finds."""
        return ALLOC_ROUND * self.resident_storages + SPLIT_REMAINDER * self.resident_large

    def clear_counts(self) -> None:
        """Forget the ops and launches seen so far (FLOPs, bytes,
        launches, the step checks' lists) and keep the live storages: the
        counts then cover what runs next alone, as a steady step's do
        after a warm-up step."""
        for counter in (self.flops, self.kernel_flops, self.launches):
            counter.clear()
        self.matmul_flops = self.bytes_accessed = self.kernel_bytes = 0
        self.float64_ops.clear()
        self.gathers.clear()
        self.max_fp_elements = 0

    # -- kernels ---------------------------------------------------------
    def _kernel(self, kernel: str, flops: int, nbytes: int, dtype: torch.dtype) -> None:
        self.launches[kernel] += 1
        self.flops[str(dtype).replace("torch.", "")] += flops
        self.kernel_flops[str(dtype).replace("torch.", "")] += flops
        self.bytes_accessed += nbytes
        self.kernel_bytes += nbytes

    def __enter__(self):
        kernel_meta.listen(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_meta.unlisten(self._kernel)
        return super().__exit__(*exc)

    # -- ops -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite_only(func):
            # reaches the mode whole under inference_mode: run its
            # decomposition, as the card does, whose ops come back through here
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if any(t.dtype == torch.float64 and self._own(t) for t in ins + outs):
            self.float64_ops.append(str(func))      # host constants made in float64 are not
        if func.overloadpacket is aten.index_select and len(args) >= 3:
            self.gathers.append((int(args[1]), int(args[2].numel())))
        mm = matmul_flops(func, args, out)
        if mm:
            self.flops[str(ins[0].dtype).replace("torch.", "")] += mm
            self.matmul_flops += mm
        elif torch.Tag.pointwise in func.tags and outs and outs[0].is_floating_point():
            self.flops[str(outs[0].dtype).replace("torch.", "")] += sum(
                t.numel() for t in outs)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            if self._own(t):
                self._add(t)
                if t.is_floating_point() and not func.is_view:
                    self.max_fp_elements = max(self.max_fp_elements, t.numel())
        return out
