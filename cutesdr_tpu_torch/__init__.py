"""cutesdr_tpu_torch — the receiver of ``cutesdr_tpu`` ported to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package stays the reference; module names follow it so each
counterpart is easy to find.  This package imports ``torch`` and never
``jax``; it reuses only the numpy layers of ``cutesdr_tpu`` (types,
coefficients, design, the demod mode table, the test-signal generators).

Ported so far: the receiver chain (``pipeline.receiver``) in all seven
demod modes, mono and stereo, with its kernels ``mixdec``, ``fastfir``,
``scan`` (two modes), ``smeter`` and ``seqloop`` (the FM and SAM PLL
loops).
"""

__version__ = "0.1.0"

from cutesdr_tpu_torch.types import K_2PI, MAX_AMPLITUDE  # noqa: F401
