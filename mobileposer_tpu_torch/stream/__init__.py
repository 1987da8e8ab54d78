"""Streaming layer of the port: the multi-stream pose server and its
realtime pacing. The JAX package's sensor ingest, calibration and live
runtime (`mobileposer_tpu/stream/`) are not ported (ROADMAP.md queue A
item 18)."""

from mobileposer_tpu_torch.stream.pacing import Pacer  # noqa: F401
from mobileposer_tpu_torch.stream.server import (  # noqa: F401
    REPLY_STRUCT,
    REPLY_STRUCT_F16,
    REQUEST_STRUCT,
    PoseClient,
    PoseServer,
)
