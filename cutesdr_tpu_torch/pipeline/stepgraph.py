"""A streaming step replayed as one CUDA graph: the port's counterpart of
the JAX package's ``jax.jit`` of the receiver step, whose data-dependent
choices (the AGC's sequential fallback, the PLL tiers) are made on the
device as its ``lax.cond``s are, so the step reads nothing on the host
and can be captured.

``StepGraph(step, params, state, block, device)`` captures ``step(params,
state, re, im) -> (state', out)`` once for the float32 planes of a
complex64 block of ``block`` samples (an int, or a shape: a
StackedReceiver's [C, block_size], a diversity receiver's [M,
block_size]; the real and imaginary views of one static buffer: K1 reads
them as interleaved pairs), on ``device`` (made the current device for
the capture and each replay, so a sub-bank on another card of a mesh
captures there).  With ``planes=False`` the step takes the complex
block itself, ``step(params, state, x)``.  ``block`` may also be a
tensor, which then is the static input as it stands (the pipeline's back
stage reads the block its front stage's graph leaves), and ``share``
another graph whose static state (and, without a tensor ``block``, whose
static input) this one uses, so that two captures of one stream take
turns (the pipeline's ping-pong):

* a warm-up step runs first, on a copy of the state, so that what is made
  at first use (cuFFT plans, cuDNN algorithms, cached tables, the kernel
  library, look-back memory, device counters) is made outside the
  capture; its launches and counts are set-up (``kernels.uncounted``);
* the state lives in static buffers: the graph's last nodes copy the new
  carry into them, and ``load_state`` copies a state in; an output that
  is a strided view (USB's audio, the real part of a complex block) is
  made dense inside the graph;
* ``run(iq)`` and ``run_planes(re, im)`` copy the input into the static
  block (one copy, or one a plane), replay, and return the outputs
  cloned (the probe taps' dict too), so that a returned output stays
  valid after the next call (as JAX's fresh arrays do); ``replay()``
  replays alone and returns the static outputs themselves;
* the graph owns its look-back memory (``kernels/scan.own_lookback``),
  and ``kernels.LAUNCHES`` gains the captured launches on every replay;
* the warm-up step and the capture are set-up spans (``metrics``:
  ``setup.warmup``, ``setup.capture``; the kernel library is loaded
  before them, ``setup.kernels``); ``run_traced`` is ``run`` or
  ``run_planes`` with the entry's spans, its input copies timed on the
  card too, and nothing added inside the graph;
* a capture that fails raises: nothing falls back to the eager step.

``params`` are captured by reference, and the graph keeps them (a graph
reads its params' memory at every replay, so a params tree dropped by
its caller must not go back to the allocator): a caller changes a value
between replays by writing the tensor in place (``Receiver`` does, for
the tune, the volume and a banded resample ratio).
"""

from __future__ import annotations

import torch

from cutesdr_tpu_torch import metrics
from cutesdr_tpu_torch.demod import fm, sam
from cutesdr_tpu_torch.kernels import LAUNCHES, _build, scan, uncounted
from cutesdr_tpu_torch.ops import agc
from cutesdr_tpu_torch.types import CDTYPE

# the counts a step decides on the device, put back after the warm-up
COUNTS = (agc.STATS, fm.STATS, sam.STATS)


# --------------------------------------------------------------- trees ---

def walk(tree, path=()):
    """(path, leaf) of every leaf of a tree of (Named)tuples and dicts, in
    order."""
    if isinstance(tree, dict):
        for name, sub in tree.items():
            yield from walk(sub, path + (name,))
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, sub in zip(names, tree):
            yield from walk(sub, path + (name,))
    else:
        yield path, tree


def tree_map(fn, tree, path=()):
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {name: tree_map(fn, sub, path + (name,))
                for name, sub in tree.items()}
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

    def __init__(self, step, params, state, block, device: torch.device,
                 planes: bool = True, share: "StepGraph | None" = None):
        self.device = device
        self.params = params       # read by pointer: kept alive with the graph
        if isinstance(block, torch.Tensor):
            self.iq = block
        elif share is not None:
            self.iq = share.iq
        else:
            self.iq = torch.zeros(block, dtype=CDTYPE, device=device)
        self.state = clone(state) if share is None else share.state
        self.lookback = scan.Lookback(device)
        x = (self.iq.real, self.iq.imag) if planes else (self.iq,)
        if device.type == "cuda":
            _build.library()       # its own set-up span, not the warm-up's
        with metrics.span("setup.warmup"):
            with uncounted(*COUNTS), scan.own_lookback(self.lookback):
                step(params, clone(self.state), *x)
            torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        try:
            with metrics.span("setup.capture"), torch.cuda.device(
                    device), scan.own_lookback(self.lookback), \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                new, out = step(params, self.state, *x)
                _copy_into(self.state, new)
                # dense outputs, so that a replay's clones are memcpys
                out = tree_map(lambda _, t: t.contiguous()
                               if isinstance(t, torch.Tensor) else t, out)
        finally:
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        self.out = out

    def _fits(self, *ts: torch.Tensor) -> None:
        """A block must fill the static one exactly: the copy would
        broadcast a shared block over a stack's rows where the eager
        step refuses it."""
        for t in ts:
            if t.shape != self.iq.shape:
                raise ValueError(f"graphed step: expected a block of "
                                 f"{tuple(self.iq.shape)}, got "
                                 f"{tuple(t.shape)}")

    def run(self, iq: torch.Tensor):
        """One complex64 block: copied in (``non_blocking`` from pinned
        host memory: its caller keeps the block until the copy has run),
        the graph replayed; returns the step's output (fresh tensors)."""
        self._fits(iq)
        self.iq.copy_(iq, non_blocking=True)
        return clone(self.replay())

    def run_planes(self, re: torch.Tensor, im: torch.Tensor):
        """``run`` of a block given as planes (int16 planes are cast by the
        copies)."""
        self._fits(re, im)
        self.iq.real.copy_(re)
        self.iq.imag.copy_(im)
        return clone(self.replay())

    def run_traced(self, *x: torch.Tensor):
        """``run`` (one complex block) or ``run_planes`` (two planes)
        with the entry's spans: ``entry.input`` (the fit and the copies,
        which a pair of timing events also times on the compute stream,
        back to back), ``entry.replay`` and ``entry.outputs``."""
        with metrics.span("entry.input"):
            self._fits(*x)
            marks = metrics.device_marks("entry.input", self.iq.device)
            pair = marks.start()
            if len(x) == 2:
                self.iq.real.copy_(x[0])
                self.iq.imag.copy_(x[1])
            else:
                self.iq.copy_(x[0], non_blocking=True)
            marks.stop(pair)
        with metrics.span("entry.replay"):
            out = self.replay()
        with metrics.span("entry.outputs"):
            return clone(out)

    def replay(self):
        """The graph replayed on the static input as it stands; returns the
        static outputs, which the next replay overwrites."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v
        return self.out

    def load_state(self, state) -> None:
        """Copy ``state`` (the captured structure) into the static
        buffers."""
        _copy_into(self.state, state)
