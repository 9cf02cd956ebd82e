"""The receiver's two stages as a pipeline (port of
``cutesdr_tpu/shard/pipeline.py``).

The front end (blanker, mix + decimate, channel filter) runs on
``device_front`` and the decimated-rate back end (S-meter, AGC, demod,
resampler) on ``device_back``, one block apart: ``process(x_t)`` queues the
front end of block t, then runs the back end of block t-1 and returns its
output.  The front is queued first because the back end reads the host
once a block (the AGC's convergence flag): while the host waits for that
read, the card already holds the next block's front end.

On two devices each stage runs on its device's current stream and the
staged block moves by a device copy.  On one card the front end runs on a
stream of its own and the back end on the caller's stream: the staged
block is handed over with an event (``wait_event``) and marked with
``record_stream`` for the stream that reads it.  On the CPU the two
stages simply run in turn.  The outputs equal the single receiver's one
block late, bitwise: the same operations run in the same order.
"""

from __future__ import annotations

import contextlib

import torch

from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.shard.mesh import cuda_devices
from cutesdr_tpu_torch.shard.timeshard import tree_to
from cutesdr_tpu_torch.types import CDTYPE, resolve_device

FRONT = ("blanker", "dec", "chan_filter")
BACK = ("agc", "smeter", "demod", "resamp")


def _record(tree, stream) -> None:
    """``record_stream`` on every tensor of a (nested) tuple."""
    if isinstance(tree, torch.Tensor):
        tree.record_stream(stream)
    elif isinstance(tree, tuple):
        for t in tree:
            _record(t, stream)


class PipelinedReceiver:
    """A two-stage receiver: ``process(iq)`` returns the previous block's
    ``StepOutput`` (None on the first call) and ``flush()`` the last one.
    The devices default to the first and the last CUDA device; without
    one it raises.  Probe taps are not carried across the stages: the
    outputs' ``probes`` are None, as in the JAX package's pipeline."""

    def __init__(self, cfg: rx.ReceiverConfig, device_front=None,
                 device_back=None):
        if device_front is None or device_back is None:
            devs = cuda_devices()
            device_front = devs[0] if device_front is None else device_front
            device_back = devs[-1] if device_back is None else device_back
        self.cfg = cfg
        self.device_front = resolve_device(device_front)
        self.device_back = resolve_device(device_back)
        params, state = rx.init(self.cfg, self.device_front)
        self.params = params
        self.back_params = tree_to(params, self.device_back)
        self.front_state = {k: getattr(state, k) for k in FRONT}
        self.back_state = {k: tree_to(getattr(state, k), self.device_back)
                           for k in BACK}
        one_card = (self.device_front == self.device_back
                    and self.device_front.type == "cuda")
        self._stream = (torch.cuda.Stream(self.device_front) if one_card
                        else None)
        if self._stream is not None:
            # made on the caller's stream, read and freed on the front's
            _record(params, self._stream)
            _record(tuple(self.front_state.values()), self._stream)
        self._staged = None          # the filtered block on device_back
        self._ready = None           # its event (one card)

    def _front_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        # the front reads what the caller's stream wrote (its input)
        self._stream.wait_stream(torch.cuda.current_stream(self.device_front))
        return torch.cuda.stream(self._stream)

    def process(self, iq) -> rx.StepOutput | None:
        """Queue the front end of ``iq`` (one block of complex samples),
        then run the back end of the block staged before it."""
        with self._front_stream():
            x = torch.as_tensor(iq).to(self.device_front, CDTYPE)
            if self._stream is not None:
                x.record_stream(self._stream)
            st = rx.ReceiverState(**self.front_state,
                                  **dict.fromkeys(BACK))
            nb_c, dec_c, ff_c, filt = rx.front(self.cfg, self.params, st,
                                               x.real, x.imag)
            self.front_state = dict(blanker=nb_c, dec=dec_c, chan_filter=ff_c)
            filt = filt.to(self.device_back)
            ready = None
            if self._stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        out = self.flush()
        self._staged, self._ready = filt, ready
        return out

    def flush(self) -> rx.StepOutput | None:
        """Run the back end of the staged block (None when nothing is
        staged)."""
        if self._staged is None:
            return None
        filt = self._staged
        if self._ready is not None:
            stream = torch.cuda.current_stream(self.device_back)
            stream.wait_event(self._ready)
            filt.record_stream(stream)
        st = rx.ReceiverState(**dict.fromkeys(FRONT), **self.back_state)
        sm_c, agc_c, dm_c, rs_c, out = rx.back_end(self.cfg, self.back_params,
                                                   st, filt)
        self.back_state = dict(agc=agc_c, smeter=sm_c, demod=dm_c,
                               resamp=rs_c)
        self._staged = self._ready = None
        return out
