"""A streaming step replayed as one CUDA graph: the port's counterpart of
the JAX package's ``jax.jit`` of the receiver step, whose data-dependent
choices (the AGC's sequential fallback, the PLL tiers) are made on the
device as its ``lax.cond``s are, so the step reads nothing on the host
and can be captured.

``StepGraph(step, params, state, block, device)`` captures ``step(params,
state, re, im) -> (state', out)`` once for the float32 planes of a
complex64 block of ``block`` samples (the real and imaginary views of one
static buffer: K1 reads them as interleaved pairs):

* a warm-up step runs first, on a copy of the state, so that what is made
  at first use (cuFFT plans, cuDNN algorithms, cached tables, the kernel
  library, look-back memory, device counters) is made outside the
  capture; its launches and counts are set-up (``kernels.uncounted``);
* the state lives in static buffers: the graph's last nodes copy the new
  carry into them, and ``load_state`` copies a state in;
* ``run(iq)`` and ``run_planes(re, im)`` copy the input into the static
  block (one copy, or one a plane), replay, and return the outputs
  cloned, so that a returned output stays valid after the next call (as
  JAX's fresh arrays do);
* the graph owns its look-back memory (``kernels/scan.own_lookback``),
  and ``kernels.LAUNCHES`` gains the captured launches on every replay;
* a capture that fails raises: nothing falls back to the eager step.

``params`` are captured by reference: a caller changes a value between
replays by writing the tensor in place (``Receiver`` does, for the tune,
the volume and a banded resample ratio).
"""

from __future__ import annotations

import torch

from cutesdr_tpu_torch.demod import fm, sam
from cutesdr_tpu_torch.kernels import LAUNCHES, scan, uncounted
from cutesdr_tpu_torch.ops import agc
from cutesdr_tpu_torch.types import CDTYPE

# the counts a step decides on the device, put back after the warm-up
COUNTS = (agc.STATS, fm.STATS, sam.STATS)


# --------------------------------------------------------------- trees ---

def walk(tree, path=()):
    """(path, leaf) of every leaf of a tree of (Named)tuples, in order."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, sub in zip(names, tree):
            yield from walk(sub, path + (name,))
    else:
        yield path, tree


def tree_map(fn, tree, path=()):
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        subs = [tree_map(fn, sub, path + (name,))
                for name, sub in zip(names, tree)]
        return type(tree)(*subs) if hasattr(tree, "_fields") else tuple(subs)
    return fn(path, tree)


def clone(tree):
    """The tree with every tensor cloned."""
    return tree_map(lambda _, t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def tensors(tree) -> list[torch.Tensor]:
    return [t for _, t in walk(tree) if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------- graph ---

def _copy_into(dst, src) -> None:
    """Each tensor of ``src`` into the same place of ``dst``; a source
    that shares memory with another of ``dst``'s buffers is cloned first,
    so no copy reads a buffer that an earlier copy overwrote."""
    pairs = [(d, s) for d, s in zip(tensors(dst), tensors(src)) if d is not s]
    mine = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in mine else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


class StepGraph:
    """One captured step on a CUDA device (module notes)."""

    def __init__(self, step, params, state, block: int,
                 device: torch.device):
        self.device = device
        self.iq = torch.zeros(block, dtype=CDTYPE, device=device)
        self.state = clone(state)
        self.lookback = scan.Lookback(device)
        re, im = self.iq.real, self.iq.imag
        with uncounted(*COUNTS), scan.own_lookback(self.lookback):
            step(params, clone(self.state), re, im)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        try:
            with scan.own_lookback(self.lookback), torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                new, out = step(params, self.state, re, im)
                _copy_into(self.state, new)
        finally:
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        self.out = out

    def run(self, iq: torch.Tensor):
        """One complex64 block: copied in, the graph replayed; returns the
        step's output (fresh tensors)."""
        self.iq.copy_(iq)
        return self._replay()

    def run_planes(self, re: torch.Tensor, im: torch.Tensor):
        """``run`` of a block given as planes (int16 planes are cast by the
        copies)."""
        self.iq.real.copy_(re)
        self.iq.imag.copy_(im)
        return self._replay()

    def _replay(self):
        self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v
        return clone(self.out)

    def load_state(self, state) -> None:
        """Copy ``state`` (the captured structure) into the static
        buffers."""
        _copy_into(self.state, state)
