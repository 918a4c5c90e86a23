"""Captured executables: the port's counterpart of the reference's jit cache.

The reference compiles each plan once per (plan shape, caps) with
``jax.jit`` and reuses the executable after that.  On the card the port
captures the eager walker once per key in a ``torch.cuda.CUDAGraph``
over static input buffers and replays the graph:

* a call copies its host arrays (lookup ranges, or opcodes and step
  ranges) into the graph's static input buffers, replays the graph and
  clones the graph's outputs, all enqueued on the current stream, so a
  dispatch owns its outputs even when another dispatch of the same key
  replays before it is harvested;
* before a capture the function runs once on a side stream (PyTorch's
  rule: lazy initialisation stays out of the capture), and the capture
  then records it on that stream;
* the bindings count their launches in Python, which a replay never
  reaches: each graph records the launches of its capture and adds them
  at every replay (``kernels.ops.add_launches``), so the counts stay the
  counts of the kernels that ran;
* a graph reads the index arrays and its static buffers by address: it
  keeps the function it captured, and so the arrays, alive, and its
  owner drops it before the arrays change (``ExecutableCache.clear``);
* a graph fixes the threads of every block it launches: the cache drops
  all its graphs when ``kernels.ops.tuned_generation`` moves, that is
  when a cost table was activated.

The graphs of one cache share one memory pool.  That is safe here because
each replay's outputs are cloned before anything else is enqueued on the
stream, and the static inputs live outside the pool.  A new graph is
captured before the least recently used ones are evicted, so the pool
always has a live graph while the cache is not empty; once the cache is
emptied, the next capture opens a new pool.  The cache is
bounded in bytes and evicts the least recently used graph; a graph larger
than the bound on its own is still captured and replayed, and leaves at
the next insertion.  A failed capture or replay raises: nothing reruns
eagerly instead.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..kernels import ops as kops

#: A cache holds graphs of at most this share of the card's memory.
MEMORY_SHARE = 1 / 8


class CapturedGraph:
    """``fn(*inputs)`` captured in one CUDA graph.

    ``inputs`` are the static device tensors the graph reads; ``outputs``
    the tensors it writes, which every :meth:`replay` overwrites.
    ``launches`` is {kernel: launches} of one replay, ``bytes`` what the
    graph holds: its static inputs and the pool memory its capture added.
    """

    def __init__(self, fn, inputs: tuple, pool=None, stream=None):
        dev = inputs[0].device
        stream = stream if stream is not None else torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn(*inputs)  # the warm-up: its launches ran and stay counted
        torch.cuda.synchronize(dev)
        before = kops.launch_counts()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = tuple(fn(*inputs))
            finally:
                graph.capture_end()
        after = kops.launch_counts()
        # the capture recorded these launches; they run at each replay
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        kops.add_launches({k: -n for k, n in self.launches.items()})
        self.fn = fn
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.bytes = (torch.cuda.memory_reserved(dev) - reserved
                      + sum(t.nbytes for t in inputs))

    def replay(self) -> tuple:
        self.graph.replay()
        kops.add_launches(self.launches)
        return self.outputs


class ExecutableCache:
    """Captured executables of one backend, keyed by their static shape
    (the backend names the key), least recently used first out once their
    bytes pass ``max_bytes``.

    ``capture(fn, inputs, pool, stream)`` makes an entry with ``inputs``,
    ``bytes`` and ``replay()``: :class:`CapturedGraph` on the card.
    Counters: ``captures``, ``capture_s`` (seconds spent capturing,
    warm-ups included), ``replays``, ``evictions``."""

    def __init__(self, device, max_bytes: int | None = None,
                 capture=CapturedGraph):
        self.device = torch.device(device)
        if max_bytes is None:
            max_bytes = int(MEMORY_SHARE * torch.cuda.get_device_properties(
                self.device).total_memory)
        self.max_bytes = int(max_bytes)
        self._capture = capture
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._generation = kops.tuned_generation
        self._pool = None
        self._stream = None
        self.bytes = 0
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.evictions = 0

    def __len__(self) -> int:
        self._check_generation()
        return len(self._entries)

    def __contains__(self, key) -> bool:
        self._check_generation()
        return key in self._entries

    def keys(self) -> list:
        self._check_generation()
        return list(self._entries)

    def stats(self) -> dict:
        return dict(graphs=len(self), bytes=self.bytes,
                    max_bytes=self.max_bytes, captures=self.captures,
                    capture_s=self.capture_s, replays=self.replays,
                    evictions=self.evictions)

    def clear(self) -> None:
        """Drop every graph (the arrays they read are about to change, or
        their block sizes are stale).  A pool that no graph holds any more
        cannot take another capture, so the next capture opens a new one."""
        self._entries.clear()
        self.bytes = 0
        self._pool = None

    def _check_generation(self) -> None:
        if self._generation != kops.tuned_generation:
            self.clear()
            self._generation = kops.tuned_generation

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
        if self.device.type == "cuda":
            # a pageable copy would wait for the stream's earlier batches;
            # a pinned one is enqueued behind them and returns at once
            host = host.pin_memory()
        return host

    def _insert(self, key, fn, host_inputs):
        inputs = tuple(self._host(h).to(self.device) for h in host_inputs)
        if self.device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        t0 = time.perf_counter()
        entry = self._capture(fn, inputs, self._pool, self._stream)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        while self._entries and self.bytes + entry.bytes > self.max_bytes:
            _, old = self._entries.popitem(last=False)
            self.bytes -= old.bytes
            self.evictions += 1
        self._entries[key] = entry
        self.bytes += entry.bytes
        return entry

    def run(self, key, fn, host_inputs) -> tuple:
        """Outputs of ``fn`` on ``host_inputs`` (int32 host arrays), owned
        by the caller: the entry of ``key`` replayed, captured first from
        ``fn`` if the cache has none."""
        self._check_generation()
        entry = self._entries.get(key)
        if entry is None:
            entry = self._insert(key, fn, host_inputs)
        else:
            self._entries.move_to_end(key)
        for buf, arr in zip(entry.inputs, host_inputs):
            buf.copy_(self._host(arr), non_blocking=True)
        outputs = entry.replay()
        self.replays += 1
        return tuple(t.clone() for t in outputs)
