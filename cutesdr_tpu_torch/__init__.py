"""cutesdr_tpu_torch — the receiver of ``cutesdr_tpu`` ported to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package stays the reference; module names follow it so each
counterpart is easy to find.  This package imports ``torch`` and never
``jax`` or any module of ``cutesdr_tpu``: the numpy design code it needs
has its own copies under ``design/``.

Ported so far: the receiver chain (``pipeline.receiver``) in all seven
demod modes, mono and stereo, with the noise blanker, migrated state
across mode and rate changes, the channel banks, the spectrum display,
the live session (``session.ReceiverSession``) and its serving surface
(the probe taps and scope, ``session.DiversitySession`` over
``shard.coherent``, ``bank.BankSession``, ``serve.SpectrumServer``), with
the kernels
``mixdec``, ``fastfir``, ``scan`` (two modes), ``smeter``, ``seqloop``
(the FM and SAM PLL loops) and ``resamp`` (the banded resampler).
"""

__version__ = "0.1.0"

from cutesdr_tpu_torch.types import K_2PI, MAX_AMPLITUDE  # noqa: F401
