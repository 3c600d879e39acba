"""The K-step dispatch as one captured CUDA graph.

``steps_per_dispatch=K`` runs K optimizer steps per dispatch
(``train/trainer.py``). On the card a dispatch of the full group shape is
one ``torch.cuda.CUDAGraph`` replay: the graph holds every launch of the
K steps (preprocessing, forward, backward, the guard, the update, the
EMA), so the host pays one ``cudaGraphLaunch`` per dispatch in place of
thousands of launches. It is the counterpart of the JAX trainer's
``lax.scan`` of K single-step bodies in one XLA program.

:func:`capture` follows torch's recipe for capturing a whole network:

1. the state the program changes in place (parameters, optimizer slots,
   EMA, batch statistics) is copied;
2. the program runs once eagerly on a side stream on the static inputs,
   which builds the kernel libraries, lets cuDNN and cuBLAS choose their
   algorithms and set up their handles, makes every ``cudaFuncSetAttribute``
   of a kernel wrapper and warms the allocator, all outside the capture;
3. the copies are written back, so the warm-up leaves no trace;
4. the program is captured into the graph, with its own memory pool.

A replay reads the static inputs' addresses and writes the state's
tensors, so the caller fills the inputs in place before each replay
(:meth:`CapturedDispatch.replay`). What the program returns lives in the
graph's pool and is overwritten by the next replay; ``replay`` returns
copies of it.

Nothing here falls back: an error in the warm-up, the capture or a replay
propagates, so a run asked for K steps per dispatch never turns into an
eager loop of full groups on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

Program = Callable[[], Dict[str, torch.Tensor]]


class CapturedDispatch:
  """One captured dispatch: the graph and the tensors it returned."""

  def __init__(self, graph: 'torch.cuda.CUDAGraph',
               outputs: Dict[str, torch.Tensor], capture_ms: float):
    self.graph = graph
    self.outputs = outputs
    self.capture_ms = capture_ms
    self.replays = 0

  def replay(self) -> Dict[str, torch.Tensor]:
    """Replays the graph on the current stream; returns copies of its
    outputs (enqueued after the replay, so they stay valid after the next
    one)."""
    self.graph.replay()
    self.replays += 1
    return {k: v.clone() for k, v in self.outputs.items()}


@torch.no_grad()
def _restore(tensors: List[torch.Tensor], copies: List[torch.Tensor]) -> None:
  for live, old in zip(tensors, copies):
    live.copy_(old)


def capture(program: Program, state: List[torch.Tensor],
            device: torch.device) -> CapturedDispatch:
  """Warms ``program`` up, restores ``state`` and captures it (module
  doc). ``program`` reads only static tensors that the caller keeps and
  refills; ``state`` lists every tensor it changes in place."""
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  with torch.no_grad():
    copies = [t.detach().clone() for t in state]
  current = torch.cuda.current_stream(device)
  side = torch.cuda.Stream(device)
  side.wait_stream(current)
  with torch.cuda.stream(side):
    program()
  current.wait_stream(side)
  _restore(state, copies)
  torch.cuda.synchronize(device)
  del copies
  graph = torch.cuda.CUDAGraph()
  # thread_local: the input pipeline's threads (pinned allocations, the
  # checkpoint writer) keep running while this thread captures.
  with torch.cuda.graph(graph, capture_error_mode='thread_local'):
    outputs = program()
  end.record()
  end.synchronize()
  return CapturedDispatch(graph, outputs, start.elapsed_time(end))
