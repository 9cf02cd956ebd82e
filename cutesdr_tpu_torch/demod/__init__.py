"""Demodulators of the port: AM, SAM, FM and SSB/CW, mono and stereo.  The
mode registry is the JAX package's (``cutesdr_tpu.demod``, plain
constants)."""

from cutesdr_tpu.demod import MODE_IDS, MODE_NAMES  # noqa: F401
