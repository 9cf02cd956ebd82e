"""Host-side filter design of the port (numpy only): its own copies of the
JAX package's design functions that it uses, so the port imports nothing
of ``cutesdr_tpu``."""
