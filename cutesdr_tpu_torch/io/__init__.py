"""Host-side I/O plane of the port: ASCP protocol, device discovery, radio
client, AD6620 loader, file sources/sinks, SigMF recording, the native UDP
ingest and the rate-locked audio output (the counterparts of
``cutesdr_tpu/io/``; numpy and the standard library, no torch tensors).
"""

from cutesdr_tpu_torch.io.ascp import AscpMessage, ci  # noqa: F401
from cutesdr_tpu_torch.io.filesource import (  # noqa: F401
    FileSource, RawIQWriter, WavSink)
