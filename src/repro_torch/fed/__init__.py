"""The federated cohort engine, ported to PyTorch:

  * :mod:`repro_torch.fed.partition`  -- IID / label-shard / Dirichlet(alpha)
    / paper partitioners over labeled datasets;
  * :mod:`repro_torch.fed.scheduler`  -- full / uniform-sampling /
    staleness-weighted async participation plus straggler dropout;
  * :mod:`repro_torch.fed.channel`    -- the ``ChannelFamily`` registry (ideal,
    awgn, rayleigh, mimo_mac);
  * :mod:`repro_torch.fed.server_opt` -- FedAvg / FedAvgM / FedAdam;
  * :mod:`repro_torch.fed.engine`     -- the vmapped (optionally chunked)
    cohort round, with the per-client loop oracle, over a flat parameter
    dict or a registry model's nested tree, and the array and token
    (``TokenClientData``) federations;
  * :mod:`repro_torch.fed.stream`     -- the streaming round mode:
    arrival-ordered sub-cohort batches through a bounded ingest buffer into
    a carry-save tree of partial Bussgang/EA sufficient statistics, with a
    deadline cutoff that degrades into the non-participation contract.
"""

from repro_torch.fed.channel import (
    CHANNEL_FAMILIES,
    ChannelConfig,
    ChannelFamily,
    ChannelRealization,
    get_channel_family,
    realize_uplink,
    register_channel_family,
)
from repro_torch.fed.engine import ArrayClientData, CohortConfig, CohortEngine, TokenClientData
from repro_torch.fed.partition import PartitionConfig, partition_indices
from repro_torch.fed.scheduler import SchedulerConfig, SchedulerState, select_cohort
from repro_torch.fed.server_opt import ServerOptConfig
from repro_torch.fed.stream import BoundedIngestBuffer, StreamConfig, StreamingPS, stream_decode

__all__ = [
    "ArrayClientData",
    "BoundedIngestBuffer",
    "CHANNEL_FAMILIES",
    "ChannelConfig",
    "ChannelFamily",
    "ChannelRealization",
    "CohortConfig",
    "CohortEngine",
    "PartitionConfig",
    "SchedulerConfig",
    "SchedulerState",
    "ServerOptConfig",
    "StreamConfig",
    "StreamingPS",
    "TokenClientData",
    "get_channel_family",
    "partition_indices",
    "realize_uplink",
    "register_channel_family",
    "select_cohort",
    "stream_decode",
]
