"""Demodulators of the port.  Only SSB/CW (usb, lsb, cwu, cwl) is ported;
the mode registry is the JAX package's (``cutesdr_tpu.demod``, numpy-free
constants)."""

from cutesdr_tpu.demod import MODE_IDS, MODE_NAMES  # noqa: F401
