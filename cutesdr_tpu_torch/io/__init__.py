"""Host-side input/output of the port: the rate-locked audio queue."""
