"""CUDA graphs: the port's counterpart of the JAX package's compiled programs.

The JAX package runs a sampling run as one XLA program (a `lax.scan` over the
steps, jitted per server bucket and per CLI run) and a train step as one
jitted function (K of them in one `lax.scan` with `steps_per_dispatch`). The
port keeps its loops in Python and captures the body of each, one sampler
step or one train step, as a CUDA graph: the host writes the step's inputs
into static buffers and replays one graph where it launched a few hundred
kernels.

`CudaGraph` holds one capture:

  * `fn()` reads and writes static buffers that its caller owns and returns
    its outputs;
  * the first call runs `fn` eagerly on a side stream (the warm-up: the
    kernels are built and their driver entry points resolved, lazy state such
    as an optimizer's moments is made; its result is the call's result), then
    captures `fn` on that stream with capture_error_mode="thread_local" into
    the memory pool it was given (`torch.cuda.graph_pool_handle()`, one per
    pipeline, shared by its buckets);
  * later calls replay the graph;
  * each capture is recorded as the span `graph.capture` (utils/tracing.py),
    so that a capture again in a serving process shows;
  * its validity key is the `weight_key` (ops/weight_cache.py) of every
    parameter and buffer of `modules` and the implementation in force
    (`implementation_key`). A call with `check=True` compares it and captures
    again when it changed: a graph never runs stale weights, and no call
    falls back to running `fn` eagerly. A failed capture raises.

The kernels' launch counters are host Python, which a replay does not run. A
capture records what each counter gained while `fn` was captured and puts the
counters back (a capture launches nothing); every replay then adds those
gains, so that the counts stay the launches the card ran.

Only for CUDA: a CPU caller runs its function itself and builds no holder.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Iterable, Optional

import torch
from torch import nn

from condmdi_tpu_torch.ops.weight_cache import generation, weight_key
from condmdi_tpu_torch.utils import tracing

# what chip_smoke.py and the tests swap for the plain versions: a graph captured on one
# of them must not replay under another
_IMPLEMENTATIONS = (
    ("condmdi_tpu_torch.models.unet", "fused_conv_gn_mish"),
    ("condmdi_tpu_torch.ops.resblock", "_launch"),
    ("condmdi_tpu_torch.ops.attention", "_launch"),
    ("condmdi_tpu_torch.ops.quant", "_launch"),
    ("condmdi_tpu_torch.ops.dense", "_launch"),
)


def implementation_key() -> tuple:
    """Which function each swappable kernel entry is bound to right now."""
    key = []
    for module, name in _IMPLEMENTATIONS:
        mod = sys.modules.get(module)
        key.append(None if mod is None else id(getattr(mod, name, None)))
    return tuple(key)


def _counters() -> tuple:
    from condmdi_tpu_torch.ops.attention import fused_self_attention
    from condmdi_tpu_torch.ops.dense import dense
    from condmdi_tpu_torch.ops.quant import int8_conv1d
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish

    return fused_conv_gn_mish, fused_self_attention, int8_conv1d, dense


def launch_counts() -> tuple[int, ...]:
    """The four kernels' launch counters."""
    return tuple(c.launches for c in _counters())


def _add_launches(counts: Iterable[int]) -> None:
    for counter, n in zip(_counters(), counts):
        counter.launches += n


def tensors_of(modules: Iterable[nn.Module]) -> list[torch.Tensor]:
    """Every parameter and buffer of `modules`, each once."""
    seen, out = set(), []
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


class CudaGraph:
    """One captured function over static buffers (see the module's docstring).

    `modules` are the modules whose weights the graph reads; `pool` a memory
    pool handle shared with other graphs that never run at the same time;
    `advances_generation` marks a graph that steps an optimizer: each replay
    counts one optimizer step (`weight_cache.advance`), as the eager step's
    hook does, and the graph stays valid across the steps it counts itself.
    `watch_generation=False` leaves the optimizer generation out of the key,
    for a graph that re-packs the weights it reads at every replay
    (`weight_cache.repack_on_every_call`) beside another graph that steps the
    optimizer.
    """

    def __init__(self, fn: Callable[[], Any], modules: Iterable[nn.Module] = (),
                 pool=None, advances_generation: bool = False, watch_generation: bool = True):
        self.fn = fn
        self.modules = tuple(modules)
        self.pool = pool
        self.advances_generation = advances_generation
        self.watch_generation = watch_generation
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.key = None
        self.launches = (0, 0, 0, 0)  # each counter's gain per replay
        self.captures = 0
        self.replays = 0
        self._stream: Optional[torch.cuda.Stream] = None

    def validity_key(self) -> tuple:
        tensors = tuple(weight_key(t)[1:] for t in tensors_of(self.modules))
        return implementation_key(), generation() if self.watch_generation else None, tensors

    def __call__(self, check: bool = True):
        """Replay, or capture where there is no graph yet or (with `check`) its key
        changed; returns `fn`'s outputs (a replay's are the graph's static tensors)."""
        if self.graph is None or (check and self.validity_key() != self.key):
            return self._capture()
        self.graph.replay()
        self.replays += 1
        _add_launches(self.launches)
        if self.advances_generation:
            from condmdi_tpu_torch.ops.weight_cache import advance

            advance()
            self.key = (self.key[0], generation(), self.key[2])
        return self.outputs

    def _capture(self):
        """The warm-up call and the capture, recorded as the span `graph.capture`
        (attr cause: "first", or "key changed" for a capture again); nothing
        inside the capture's body is recorded."""
        cause = "first" if self.graph is None else "key changed"
        with tracing.span("graph.capture", cause=cause):
            return self._capture_body()

    def _capture_body(self):
        self.graph = self.outputs = None
        current = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=current.device)
        stream = self._stream
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            result = self.fn()  # the warm-up is a real call: its launches count
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with tracing.paused(), torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                                capture_error_mode="thread_local"):
            outputs = self.fn()
        gained = tuple(a - b for a, b in zip(launch_counts(), before))
        _add_launches(-n for n in gained)  # the capture launched nothing
        current.wait_stream(stream)
        self.graph, self.outputs, self.launches = graph, outputs, gained
        self.captures += 1
        self.key = self.validity_key()
        return result
