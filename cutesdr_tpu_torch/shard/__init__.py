"""Many receiver chains in one step, and one stream over many devices:
channel banks (``channels``), the diversity combiner (``coherent``), the
device mesh (``mesh``), time sharding with halo exchange (``timeshard``,
across processes ``multihost``) and the two-stage pipeline
(``pipeline``)."""

from cutesdr_tpu_torch.shard.channels import ChannelBank, StackedReceiver
from cutesdr_tpu_torch.shard.mesh import make_mesh
from cutesdr_tpu_torch.shard.pipeline import PipelinedReceiver
from cutesdr_tpu_torch.shard.timeshard import ShardedReceiver

__all__ = ["ChannelBank", "PipelinedReceiver", "ShardedReceiver",
           "StackedReceiver", "make_mesh"]
