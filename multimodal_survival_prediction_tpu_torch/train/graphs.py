"""A train step replayed as one CUDA graph.

:class:`CapturedStep` is how ``Trainer.train_epoch`` (``train/engine.py``)
and the fold-parallel epoch (``train/cv_parallel.py``) run their steps.
Each caller keys a ``CapturedStep`` on what its graph bakes in (the
objects, tensor addresses and shapes its body reads, ending in
:func:`backend_flags`), gives it the step's static inputs and its body,
and keeps a new one whenever the key changes: the old graph goes with the
old ``CapturedStep``.

On a card the first call runs the body eagerly on a side stream (the
warm-up: kernel libraries load, cuBLAS and cuDNN set up for that stream,
and the bf16 ``moments`` counters of that stream are made outside the
graph's pool). The second call captures it (span ``setup.capture``; the
capture runs nothing on the device) and then replays it, as does every
later call: each copies its row into the static inputs, replays the graph
and clones its output (span ``train.step`` around ``train.replay``). The
dropout generators are registered with the graph, so each replay draws the
next numbers of their Philox streams, as an eager step would. Counters
kept on the host inside a body (the fused kernels' wrapper calls,
``utils/profiling.py:count``) count the warm-up's and the capture's calls
and no replay's; a device trace counts the replayed kernels. On the CPU
each call copies its row and runs the body.

The host counters (the step, Adam's count) are the caller's: a body may
advance them when it runs, a replay does not run it, and a capture runs it
without taking the step. So the caller sets them after a call that
:meth:`CapturedStep.__call__` says replayed (a call that captures also
replays), which puts back what the capture advanced.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..utils.profiling import span


def backend_flags() -> tuple:
    """The TF32 and cuDNN flags a captured step bakes in: the last entries
    of every key."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)


class CapturedStep:
    """One step's static inputs and, on a card, its CUDA graph.

    Args:
      key: what the graph bakes in (the caller compares it).
      held: the keyed objects, kept alive with the graph so that their ids
          do not pass to others.
      inputs: ``{name: tensor or dict of tensors}``, the shapes, strides
          and dtypes of the static inputs (made empty like them, on their
          device).
      generators: the dropout generators the body draws from.
    """

    def __init__(self, key: tuple, held: tuple, inputs: dict,
                 generators=()):
        self.key = key
        self._held = held
        self.inputs = tree_map(torch.empty_like, inputs)
        dev = tree_leaves(self.inputs)[0].device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._generators = [g for g in generators if g.device.type == "cuda"]
        self.warm = False  # the warm-up has run
        self.graph = self.out = None

    def fill(self, **row):
        """Copy each ``row[name]`` into the static input ``name``."""
        for name, value in row.items():
            for dst, src in zip(tree_leaves(self.inputs[name]),
                                tree_leaves(value)):
                dst.copy_(src)

    def __call__(self, body: Callable[[dict], torch.Tensor],
                 **row) -> tuple[torch.Tensor, bool]:
        """One step: ``row`` copied into the static inputs, then
        ``body(inputs)`` run, warmed up, or captured and replayed. Returns
        its output and whether it was replayed."""
        if self.stream is None:
            self.fill(**row)
            return body(self.inputs), False
        if self.graph is None and self.warm:
            self._capture(body)
        if self.graph is not None:
            with span("train.step"), span("train.replay"):
                self.fill(**row)
                self.graph.replay()
                return self.out.clone(), True
        self.fill(**row)
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = body(self.inputs)
        main.wait_stream(self.stream)
        out.record_stream(main)
        self.warm = True
        return out, False

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        for g in self._generators:
            graph.register_generator_state(g)
        with span("setup.capture"):
            # thread_local: a streaming epoch's prefetcher thread goes on
            # pinning and copying batches on its own stream meanwhile
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.out = body(self.inputs)
        self.graph = graph
