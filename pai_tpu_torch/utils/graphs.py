"""CUDA graphs: the card's counterpart of one compiled ``lax.scan`` dispatch.

The JAX package folds ``--scan-steps K`` training steps, and the 100-step DDPM
chain, into one compiled dispatch each. Here the same work is recorded once
as a ``torch.cuda.CUDAGraph`` and then replayed with one launch, so the host
no longer enqueues every kernel of every step. A graph fixes its kernels,
their arguments and every address they read or write, so:

* what changes between replays is written, before each replay, into
  buffers the graph owns: the inputs are copied into its input buffers, the
  per-step host values (a learning rate, an EMA weight) into a device
  tensor, and each random stream's seed into a generator state registered
  with the graph (at replay torch reads the state's seed and offset into
  the graph, and advances the offset by what the graph draws);
* the recorded function must not synchronise with the host: the capture
  runs under ``torch.cuda.set_sync_debug_mode("error")``, so a host read
  raises there, at its line;
* the recorded function must have run once before on the same stream, so
  that lazily built state (the kernels' libraries and attributes, cuBLAS
  workspaces, optimizer moments) exists before the capture: the callers
  run such a warm-up on ``GraphStream``'s stream first;
* what the recorded function allocates lives in the graph's private memory
  pool, which stays reserved while the graph lives (``pool_bytes``).

The hand-written kernels' wrappers count their launches in Python, which a
replay does not run: the capture's counts are taken back and added again at
every replay (``kernels.captured_launches``, ``kernels.add_launches``).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from pai_tpu_torch import kernels


class CapturedGraph:
    """``fn()`` recorded once on ``stream`` as one CUDA graph; ``replay()``
    runs it. ``generators`` are the generator states ``fn`` draws from
    (each registered with the graph). ``output`` is what ``fn`` returned:
    tensors in the graph's pool, rewritten by every replay. Kept for the
    record: ``capture_seconds``, ``instantiate_seconds``, ``pool_bytes``
    (the memory the capture reserved) and ``launches`` (the hand-written
    kernels' launches per replay)."""

    def __init__(self, fn: Callable[[], object], stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in generators:
            self.graph.register_generator_state(generator)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        start = time.perf_counter()
        with kernels.captured_launches() as self.launches, \
                torch.cuda.graph(self.graph, stream=stream):
            torch.cuda.set_sync_debug_mode("error")
            self.output = fn()
            torch.cuda.set_sync_debug_mode("default")
        self.capture_seconds = time.perf_counter() - start
        start = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_seconds = time.perf_counter() - start
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.replays = 0

    def replay(self) -> None:
        """One launch of the graph on the current stream."""
        self.graph.replay()
        kernels.add_launches(self.launches)
        self.replays += 1

    def stats(self) -> dict:
        return {"capture_seconds": self.capture_seconds,
                "instantiate_seconds": self.instantiate_seconds,
                "pool_bytes": self.pool_bytes, "replays": self.replays,
                "launches_per_replay": dict(self.launches)}


class GraphStream:
    """The side stream a graph is warmed up and recorded on (recording on
    the default stream is not allowed). ``with side:`` runs the block on it,
    ordered after the work enqueued before on the current stream, and orders
    the current stream's later work after the block."""

    def __init__(self):
        self.stream = torch.cuda.Stream()

    def __enter__(self):
        self._caller = torch.cuda.current_stream()
        self.stream.wait_stream(self._caller)
        self._context = torch.cuda.stream(self.stream)
        self._context.__enter__()
        return self.stream

    def __exit__(self, *exc):
        self._context.__exit__(*exc)
        self._caller.wait_stream(self.stream)
