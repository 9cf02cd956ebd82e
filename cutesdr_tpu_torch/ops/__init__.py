"""Streaming DSP blocks of the port: ``process(params, carry, x) ->
(carry, y)`` on torch tensors, as in ``cutesdr_tpu.ops``."""
