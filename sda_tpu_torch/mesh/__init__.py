"""Execution of the aggregation round on devices: one device
(``single_chip_round``, ``StreamingAggregator``), a ``('p', 'd')`` mesh of
devices in one process (``SimulatedPod``, ``StreamedPod``,
``ModelScaleRound``), and several processes over ``torch.distributed``
(``multihost``), with the device-tile landing and clerk fold
(``mesh.devscale``)."""

from . import multihost
from .devscale import (
    DeviceTileCombiner,
    DeviceTileSink,
    ModelScaleRound,
    bytes_per_dim_column,
    stream_schedule,
    watermark_dim_tile,
)
from .simpod import (
    Mesh,
    SimulatedPod,
    default_mesh_shape,
    make_mesh,
    make_multislice_mesh,
    single_chip_round,
)
from .streaming import (
    StreamedPod,
    StreamingAggregator,
    array_block_provider,
    synthetic_block_provider,
    synthetic_block_provider32,
    synthetic_device_block_provider32,
)
