"""Single-device execution of the aggregation round: the one-shot round
(``single_chip_round``) and the streamed round for workloads larger than
device memory (``StreamingAggregator``), with the device-tile landing and
clerk fold (``mesh.devscale``)."""

from .devscale import (
    DeviceTileCombiner,
    DeviceTileSink,
    stream_schedule,
)
from .simpod import single_chip_round
from .streaming import (
    StreamingAggregator,
    array_block_provider,
    synthetic_block_provider,
    synthetic_block_provider32,
    synthetic_device_block_provider32,
)
