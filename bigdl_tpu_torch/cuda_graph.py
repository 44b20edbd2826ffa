"""One step function captured as a CUDA graph and replayed: the port's
counterpart of the JAX package's resident decode step, one dispatch a
step.

``StepGraph(name, fn, device)`` wraps ``fn()``, a step that reads only
tensors which keep their addresses (static inputs that the caller fills
with ``copy_`` before each call, the KV cache, the weights) and writes its
results into static outputs. On a CUDA device the first call runs the
step once eagerly on a side stream: that is the call's step, and it also
builds every kernel at its first launch, fills the wrappers' host-side
caches (occupancy, SM counts, lookup tables) and sizes their scratch
buffers, none of which may happen inside a capture. Then the step is
captured on the same stream with ``capture_error_mode="thread_local"`` (a
CUDA call of another thread, such as an HTTP handler's, cannot break it),
and every later call replays the graph on the current stream. On any
other device every call runs ``fn()``.

A graph holds the addresses it captured: the owner drops it and makes a
new one when the cache or the weights move (``addresses`` tells), and
lends the buffers it reads to one caller at a time. It keeps the
kernels' scratch buffers it captured (``ops/cuda/dequant_matmul
.scratch_buffers``) alive, and its launches are counted through
``ops/cuda.capturing_launches`` / ``replayed``. A capture or a replay that
fails raises with its cause; nothing falls back to the eager step.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bigdl_tpu_torch.ops.cuda import capturing_launches, replayed
from bigdl_tpu_torch.ops.cuda.dequant_matmul import scratch_buffers
from bigdl_tpu_torch.ops.quant import QTensor


def addresses(*trees) -> Tuple[int, ...]:
    """The data addresses of every tensor in `trees` (dicts, lists,
    QTensors, dataclasses such as a KVCache, tensors), in one order: equal
    tuples mean a captured graph still reads the right memory."""
    out: List[int] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t.data_ptr())
        elif isinstance(t, QTensor):
            for p in (t.data, t.scale, t.zero):
                walk(p)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif hasattr(t, "__dataclass_fields__"):
            for k in t.__dataclass_fields__:
                walk(getattr(t, k))

    for tree in trees:
        walk(tree)
    return tuple(out)


class GraphPool:
    """A memory pool and a capture stream on `device` for the graphs of
    one owner, which never replay at the same time. The caching
    allocator hands a block back only to the stream that freed it, so
    the graphs capture on one stream: a later capture reuses the blocks
    that the earlier ones freed, and the pool holds about the largest
    graph's memory rather than their sum."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)


class StepGraph:
    """``fn()`` as a CUDA graph on `device` (see the module docstring).
    `name` is the replay counter's key (``ops/cuda.REPLAYS``); `keep`
    holds tensors the graph reads or writes, alive as long as it is;
    `pool` is the ``GraphPool`` it shares with the other graphs of its
    owner (None: a pool and a stream of its own)."""

    def __init__(self, name: str, fn: Callable[[], None],
                 device: torch.device, keep=(),
                 pool: Optional[GraphPool] = None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}     # wrapper launches a replay
        self.capture_ms: Optional[float] = None
        # device memory the capture added to its pool
        self.pool_bytes: Optional[int] = None
        self.replays = 0
        self._keep = list(keep)
        self._pool = pool

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif self.graph is None:
            self._run_and_capture()
        else:
            replayed(self.name, self.launches)
            self.replays += 1
            self.graph.replay()

    def _run_and_capture(self) -> None:
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = (self._pool.stream if self._pool is not None
                else torch.cuda.Stream(dev))
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()                    # this call's step, run eagerly
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        pool = None if self._pool is None else self._pool.handle
        t0 = time.perf_counter()
        try:
            with capturing_launches() as launches:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    self.fn()
        except Exception as e:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed: "
                               f"{type(e).__name__}: {e}") from e
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = launches
        self._keep += scratch_buffers(dev)
        self.graph = graph

    def stats(self) -> dict:
        """Capture time, pool bytes, replays and launches a replay."""
        return {"name": self.name, "captured": self.graph is not None,
                "capture_ms": self.capture_ms, "pool_bytes": self.pool_bytes,
                "replays": self.replays,
                "launches_per_replay": dict(self.launches)}
