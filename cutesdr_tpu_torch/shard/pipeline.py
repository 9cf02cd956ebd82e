"""The receiver's two stages as a pipeline (port of
``cutesdr_tpu/shard/pipeline.py``).

The front end (blanker, mix + decimate, channel filter) runs on
``device_front`` and the decimated-rate back end (S-meter, AGC, demod,
resampler) on ``device_back``, one block apart: ``process(x_t)`` queues the
front end of block t, then the back end of block t-1, and returns its
output; ``flush()`` runs the back end of the block still staged.  Neither
stage reads the host (the step's choices are made on the card), so the
order only decides which stage the card has queued first: on one card the
front of block t can run beside the back of block t-1.

On two devices each stage runs eagerly on its device's current stream and
the staged block moves by a device copy.  On one card each stage replays
a CUDA graph, the JAX package's two jits: the front graph on a stream of
its own, the back graph on the caller's stream, the staged block handed
over with an event (``wait_event``).  A graph writes its output into the
same static buffer at every replay, and front(t) is queued before
back(t-1) reads the block front(t-1) left, so the front is captured
twice, writing two static blocks in turn (a ping-pong), and the back
twice, one capture reading each; the two captures of a stage share its
static state.  The graphs are captured at the first block.  Each stage
reads its own params (``params`` the front, ``back_params`` the back, as
in the JAX package), held in device tensors (``rx.device_params``): an
assignment writes them in place, after the front stream's queued work,
where ``rx.graph_key`` is unchanged, and otherwise captures the four
graphs anew at the next block, from their static state, with the staged
block carried over.  Two cards stay eager, as the time shard does: the
machine that checks the port has one card, so nothing there could hold
a cross-card capture to its eager step.  On the CPU the two stages
simply run in turn.  The outputs equal the single receiver's one block
late, bitwise: the same operations run in the same order.
"""

from __future__ import annotations

import contextlib

import torch

from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.pipeline import stepgraph
from cutesdr_tpu_torch.shard.mesh import cuda_devices
from cutesdr_tpu_torch.shard.timeshard import tree_to
from cutesdr_tpu_torch.types import CDTYPE, resolve_device

FRONT = ("blanker", "dec", "chan_filter")
BACK = ("agc", "smeter", "demod", "resamp")


def _front(cfg: rx.ReceiverConfig, params, state: rx.ReceiverState, re, im):
    """The front stage as a step: (state with its front carries, block)."""
    nb_c, dec_c, ff_c, filt = rx.front(cfg, params, state, re, im)
    return state._replace(blanker=nb_c, dec=dec_c, chan_filter=ff_c), filt


def _back(cfg: rx.ReceiverConfig, params, state: rx.ReceiverState, filt):
    """The back stage as a step: (state with its back carries, output)."""
    sm_c, agc_c, dm_c, rs_c, out = rx.back_end(cfg, params, state, filt)
    return state._replace(agc=agc_c, smeter=sm_c, demod=dm_c,
                          resamp=rs_c), out


class PipelinedReceiver:
    """A two-stage receiver: ``process(iq)`` returns the previous block's
    ``StepOutput`` (None on the first call) and ``flush()`` the last one.
    The devices default to the first and the last CUDA device; without
    one it raises.  Probe taps are not carried across the stages: the
    outputs' ``probes`` are None, as in the JAX package's pipeline.  On
    one card each stage replays CUDA graphs (``graphed``; module
    notes)."""

    def __init__(self, cfg: rx.ReceiverConfig, device_front=None,
                 device_back=None):
        if device_front is None or device_back is None:
            devs = cuda_devices()
            device_front = devs[0] if device_front is None else device_front
            device_back = devs[-1] if device_back is None else device_back
        self.cfg = cfg
        self.device_front = resolve_device(device_front)
        self.device_back = resolve_device(device_back)
        self._graphs = None          # ([front 0, 1], [back 0, 1]) one card
        self._held = None            # their device params (front, back)
        self._stale = False          # a params key moved: capture anew
        params, state = rx.init(self.cfg, self.device_front)
        self._params = params
        self._back_params = tree_to(params, self.device_back)
        self._front_state = {k: getattr(state, k) for k in FRONT}
        self._back_state = {k: tree_to(getattr(state, k), self.device_back)
                            for k in BACK}
        one_card = (self.device_front == self.device_back
                    and self.device_front.type == "cuda")
        self._stream = (torch.cuda.Stream(self.device_front) if one_card
                        else None)
        self._staged = None          # the filtered block on device_back
                                     # (graphed: the slot of the front
                                     # capture that wrote it)
        self._ready = None           # its event (one card)
        self._turn = 0               # the front capture of the next block

    @property
    def graphed(self) -> bool:
        """Whether the stages replay CUDA graphs: both on one card."""
        return self._stream is not None

    @property
    def params(self) -> rx.ReceiverParams:
        """The front stage's params (assigning them reaches the graphs in
        place, or captures anew: module notes)."""
        return self._params

    @params.setter
    def params(self, value: rx.ReceiverParams) -> None:
        old, self._params = self._params, value
        self._hold(0, old, value)

    @property
    def back_params(self) -> rx.ReceiverParams:
        """The back stage's params (as ``params``)."""
        return self._back_params

    @back_params.setter
    def back_params(self, value: rx.ReceiverParams) -> None:
        old, self._back_params = self._back_params, value
        self._hold(1, old, value)

    def _hold(self, stage: int, old: rx.ReceiverParams,
              new: rx.ReceiverParams) -> None:
        """A stage's new params into its graphs' device params, in place,
        where the key holds; else a capture at the next block."""
        if self._graphs is None or self._stale:
            return
        if rx.graph_key(self.cfg, new) != rx.graph_key(self.cfg, old):
            self._stale = True
            return
        self._after_front()
        rx._update_params(self._held[stage], old, new)

    def _after_front(self) -> None:
        """The caller's stream waits for the front's queued replays (which
        read the front's params and state)."""
        if self._stream is not None:
            torch.cuda.current_stream(self.device_front).wait_stream(
                self._stream)

    def _stage_state(self, which: int, names) -> dict:
        if self._graphs is None:
            return (self._front_state, self._back_state)[which]
        self._after_front()
        st = self._graphs[which][0].state
        return {k: stepgraph.clone(getattr(st, k)) for k in names}

    @property
    def front_state(self) -> dict:
        """The front stage's carries (copies of a graph's buffers where
        the graphs hold them; assigning loads them)."""
        return self._stage_state(0, FRONT)

    @front_state.setter
    def front_state(self, value: dict) -> None:
        if self._graphs is None:
            self._front_state = value
        else:
            self._after_front()
            self._graphs[0][0].load_state(rx.ReceiverState(
                **value, **dict.fromkeys(BACK)))

    @property
    def back_state(self) -> dict:
        return self._stage_state(1, BACK)

    @back_state.setter
    def back_state(self, value: dict) -> None:
        if self._graphs is None:
            self._back_state = value
        else:
            self._graphs[1][0].load_state(rx.ReceiverState(
                **dict.fromkeys(FRONT), **value))

    def _front_stream(self):
        """The front's stream, after the caller's (none: the current
        one)."""
        if self._stream is None:
            return contextlib.nullcontext()
        # the front reads what the caller's stream wrote (its input)
        self._stream.wait_stream(torch.cuda.current_stream(self.device_front))
        return torch.cuda.stream(self._stream)

    def _capture(self) -> None:
        """The two front and the two back captures (module notes), from
        the stages' carries (the last graphs' static state, whose staged
        block the new graphs take over) and their params."""
        cfg, dev = self.cfg, self.device_front
        staged = None
        if self._graphs is None:
            front_state = rx.ReceiverState(**self._front_state,
                                           **dict.fromkeys(BACK))
            back_state = rx.ReceiverState(**dict.fromkeys(FRONT),
                                          **self._back_state)
        else:
            if self._stream is not None:
                torch.cuda.synchronize(dev)
            front_state = self._graphs[0][0].state
            back_state = self._graphs[1][0].state
            if self._staged is not None:
                staged = self._graphs[0][self._staged].out
        held = (rx.device_params(cfg, self._params, dev),
                rx.device_params(cfg, self._back_params, dev))
        front = lambda p, st, re, im: _front(cfg, p, st, re, im)
        back = lambda p, st, filt: _back(cfg, p, st, filt)
        f0 = stepgraph.StepGraph(front, held[0], front_state,
                                 (cfg.block_size,), dev)
        f1 = stepgraph.StepGraph(front, held[0], None, None, dev, share=f0)
        for f in (f0, f1):
            f.out.zero_()             # the back captures' warm-up input
        b0 = stepgraph.StepGraph(back, held[1], back_state, f0.out, dev,
                                 planes=False)
        b1 = stepgraph.StepGraph(back, held[1], None, f1.out, dev,
                                 planes=False, share=b0)
        if staged is not None:
            (f0, f1)[self._staged].out.copy_(staged)
            self._ready = None
        self._graphs, self._held = ([f0, f1], [b0, b1]), held
        self._stale = False
        self._front_state = self._back_state = None

    def process(self, iq) -> rx.StepOutput | None:
        """Queue the front end of ``iq`` (one block of complex samples),
        then run the back end of the block staged before it."""
        if not self.graphed:
            x = torch.as_tensor(iq).to(self.device_front, CDTYPE)
            st = rx.ReceiverState(**self._front_state, **dict.fromkeys(BACK))
            st, filt = _front(self.cfg, self._params, st, x.real, x.imag)
            self._front_state = {k: getattr(st, k) for k in FRONT}
            out = self.flush()
            self._staged = filt.to(self.device_back)
            return out
        if self._graphs is None or self._stale:
            self._capture()
        front, ready = self._graphs[0][self._turn], None
        with self._front_stream():
            x = torch.as_tensor(iq).to(self.device_front, CDTYPE)
            front._fits(x)
            front.iq.copy_(x)
            front.replay()
            if self._stream is not None:
                # the caller's block, read on the front's stream
                x.record_stream(self._stream)
                ready = torch.cuda.Event()
                ready.record(self._stream)
        out = self.flush()
        self._staged, self._ready = self._turn, ready
        self._turn ^= 1
        return out

    def flush(self) -> rx.StepOutput | None:
        """Run the back end of the staged block (None when nothing is
        staged)."""
        if self._staged is None:
            return None
        if self._graphs is None:
            st = rx.ReceiverState(**dict.fromkeys(FRONT), **self._back_state)
            st, out = _back(self.cfg, self._back_params, st, self._staged)
            self._back_state = {k: getattr(st, k) for k in BACK}
        else:
            if self._stale:
                self._capture()
            if self._ready is not None:
                torch.cuda.current_stream(self.device_back).wait_event(
                    self._ready)
            out = stepgraph.clone(self._graphs[1][self._staged].replay())
        self._staged = self._ready = None
        return out
