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
captures there).  With ``wire=True`` the static block is int16 [2,
*block] instead, the radio's planes (re row, im row) as they come, which
the step takes as two contiguous int16 planes (K1 reads them as they
are).  With ``planes=False`` the step takes the complex block itself,
``step(params, state, x)``.  ``block`` may also be a
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
  carry into them, and ``load_state`` copies a state in; then they copy
  every output, dense, into one static buffer (``Packed``: a strided one,
  such as USB's audio, the real part of a complex block, is made dense
  there);
* ``run(iq)`` and ``run_planes(re, im)`` copy the input into the static
  block (one copy, or one a plane: into an int16 block a same-dtype copy,
  into a complex one a cast), replay, and return the outputs as views of
  one clone of that buffer (the probe taps' dict too), so that a returned
  output stays valid after the next call (as JAX's fresh arrays do), at
  the host's cost of one copy a block; ``replay()`` replays alone and
  returns the static outputs themselves;
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

WIRE = torch.int16        # the radio's planes, a wire graph's static block
ALIGN = 16                # bytes: where each output starts in the packed one

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


def unflatten(tree):
    """A function that builds ``tree`` anew from an iterator over tensors
    in ``walk`` order, each in place of the tensor there: the tree's walk
    made once, not at every call."""
    if isinstance(tree, dict):
        subs = [(name, unflatten(sub)) for name, sub in tree.items()]
        return lambda it: {name: f(it) for name, f in subs}
    if isinstance(tree, tuple):
        subs = [unflatten(sub) for sub in tree]
        make = type(tree)._make if hasattr(tree, "_fields") else tuple
        return lambda it: make([f(it) for f in subs])
    if isinstance(tree, torch.Tensor):
        return next
    return lambda it: tree


def _dense_strides(shape: tuple) -> tuple:
    strides, size = [], 1
    for n in reversed(shape):
        strides.append(size)
        size *= max(n, 1)
    return tuple(reversed(strides))


class Packed:
    """A tree's tensors, dense, in one byte buffer, each at an
    ``ALIGN``-byte offset.  ``Packed(tree, device)`` copies them in (in a
    capture, as the graph's last nodes); ``static`` is the tree over the
    buffer's places, and ``fresh()`` the tree over a clone of the buffer:
    one copy a call and a view a tensor, where a clone each would cost
    the host an allocation and a copy each."""

    def __init__(self, tree, device: torch.device):
        leaves = tensors(tree)
        self.layout, end = [], 0     # (dtype, shape, strides, offset) a leaf
        for t in leaves:
            shape = tuple(t.shape)
            self.layout.append((t.dtype, shape, _dense_strides(shape),
                                end // t.element_size()))
            end += -(-t.numel() * t.element_size() // ALIGN) * ALIGN
        self.buf = torch.empty(max(end, ALIGN), dtype=torch.uint8,
                               device=device)
        self.dtypes = list(dict.fromkeys(dt for dt, *_ in self.layout))
        self._build = unflatten(tree)
        places = self._places(self.buf)
        for place, t in zip(places, leaves):
            place.copy_(t)
        self.static = self._build(iter(places))

    def _places(self, buf: torch.Tensor) -> list[torch.Tensor]:
        views = {dt: buf.view(dt) for dt in self.dtypes}
        return [torch.as_strided(views[dt], shape, strides, offset)
                for dt, shape, strides, offset in self.layout]

    def fresh(self):
        """The tree over a copy of the buffer as it stands."""
        return self._build(iter(self._places(self.buf.clone())))


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
                 planes: bool = True, share: "StepGraph | None" = None,
                 wire: bool = False):
        self.device = device
        self.params = params       # read by pointer: kept alive with the graph
        if isinstance(block, torch.Tensor):
            self.iq = block
        elif share is not None:
            self.iq = share.iq
        elif wire:
            self.iq = torch.zeros((2, *block), dtype=WIRE, device=device)
        else:
            self.iq = torch.zeros(block, dtype=CDTYPE, device=device)
        self.state = clone(state) if share is None else share.state
        self.lookback = scan.Lookback(device)
        # the planes' views, made once (a copy into them at every block)
        self._dst = self._planes() if planes else None
        x = self._dst if planes else (self.iq,)
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
                # the outputs dense in one buffer: a replay's come back
                # in one clone, a memcpy
                self.packed = Packed(out, device)
        finally:
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                             if LAUNCHES[k] != before[k]}
            LAUNCHES.update(before)
        self.out = self.packed.static

    @property
    def wire(self) -> bool:
        """Whether the static block is the int16 planes."""
        return self.iq.dtype == WIRE

    def _planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The static block's two planes: the int16 rows, or the complex
        block's float32 views."""
        return (tuple(self.iq) if self.wire
                else (self.iq.real, self.iq.imag))

    def _fits(self, *ts: torch.Tensor) -> None:
        """A block must fill the static one exactly: the copy would
        broadcast a shared block over a stack's rows where the eager
        step refuses it; an int16 block takes int16 planes alone (the
        copy would wrap float values)."""
        shape = self.iq.shape[1:] if self.wire else self.iq.shape
        for t in ts:
            if t.shape != shape:
                raise ValueError(f"graphed step: expected a block of "
                                 f"{tuple(shape)}, got {tuple(t.shape)}")
            if self.wire and t.dtype != WIRE:
                raise ValueError(f"graphed step: expected int16 planes, "
                                 f"got {t.dtype}")

    def _copy_planes(self, re: torch.Tensor, im: torch.Tensor) -> None:
        dst_re, dst_im = self._dst
        dst_re.copy_(re)
        dst_im.copy_(im)

    def run(self, iq: torch.Tensor):
        """One complex64 block: copied in (``non_blocking`` from pinned
        host memory: its caller keeps the block until the copy has run),
        the graph replayed; returns the step's output (fresh tensors)."""
        self._fits(iq)
        self.iq.copy_(iq, non_blocking=True)
        self.replay()
        return self.packed.fresh()

    def run_planes(self, re: torch.Tensor, im: torch.Tensor):
        """``run`` of a block given as planes (into a complex block the
        copies cast them)."""
        self._fits(re, im)
        self._copy_planes(re, im)
        self.replay()
        return self.packed.fresh()

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
                self._copy_planes(*x)
            else:
                self.iq.copy_(x[0], non_blocking=True)
            marks.stop(pair)
        with metrics.span("entry.replay"):
            self.replay()
        with metrics.span("entry.outputs"):
            return self.packed.fresh()

    def replay(self):
        """The graph replayed on the static input as it stands; returns the
        static outputs, which the next replay overwrites.  (The device is
        made current only where another one is: a switch costs the host
        about as much as the replay's launch.)"""
        index = self.device.index
        if index is None or index == torch.cuda.current_device():
            self.graph.replay()
        else:
            with torch.cuda.device(index):
                self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v
        return self.out

    def load_state(self, state) -> None:
        """Copy ``state`` (the captured structure) into the static
        buffers."""
        _copy_into(self.state, state)
