"""Streaming layer of the port: sensor ingest, calibration, the live
inference runtime, the multi-stream pose server and its realtime pacing
(counterpart of `mobileposer_tpu/stream/`). Everything but the model step
is host code; `LivePoser` and `PoseServer` run the step on the net's
device."""

from mobileposer_tpu_torch.stream.sensor import (  # noqa: F401
    BUFFER_SIZE,
    KEYS,
    MIN_TIME_DIFF,
    OUT_UDP_IP,
    OUT_UDP_PORT,
    PORTS,
    SensorData,
    encode_packet,
    process_message,
    sensor2global,
)
from mobileposer_tpu_torch.stream.calibration import (  # noqa: F401
    Calibration,
    calibrate_frames,
    compute_device_calibration,
    compute_smpl2imu,
    identity_calibration,
    normalize_frames,
)
from mobileposer_tpu_torch.stream.receiver import (  # noqa: F401
    DataReceiver,
    PerformanceLogger,
    SensorFrontend,
    encode_rebroadcast,
    init_sockets,
)
from mobileposer_tpu_torch.stream.imuset import (  # noqa: F401
    Clock,
    IMUSet,
    decode_frame_packet,
)
from mobileposer_tpu_torch.stream.replayer import (  # noqa: F401
    DeviceReplayer,
    FrameReplayer,
    synthetic_device_stream,
)
from mobileposer_tpu_torch.stream.live import (  # noqa: F401
    LivePoser,
    UnityExporter,
    save_session,
)
from mobileposer_tpu_torch.stream.pacing import Pacer  # noqa: F401
from mobileposer_tpu_torch.stream.server import (  # noqa: F401
    REPLY_STRUCT,
    REPLY_STRUCT_F16,
    REQUEST_STRUCT,
    PoseClient,
    PoseServer,
)
