r"""Streaming runtime: the native datapath, the wire formats, IMU-camera
sync, the live server, the latency harness, the Unity viewer and the
multiplexer (the detector process is ``streaming.detector``)."""

from .native import (RingBuffer, ImuResampler, encode_imu_packet,  # noqa: F401
                     parse_imu_packet, native_available)
from .protocol import (encode_detector_packet,  # noqa: F401
                       encode_unity_frame, parse_detector_packet,
                       parse_unity_frame)
from .sync import (tpose_calibration, detect_jump_sync,  # noqa: F401
                   detect_spikes, CalibrationResult, ImuCamStream)
from .server import LiveServer, run_live_demo  # noqa: F401
from .latency import measure_streaming_latency  # noqa: F401
from .unity import MotionViewer  # noqa: F401
from .multiplex import StreamingMultiplexer  # noqa: F401

__all__ = ["RingBuffer", "ImuResampler", "encode_imu_packet",
           "parse_imu_packet", "native_available", "encode_detector_packet",
           "parse_detector_packet", "encode_unity_frame", "parse_unity_frame",
           "tpose_calibration", "detect_jump_sync", "detect_spikes",
           "CalibrationResult", "ImuCamStream", "LiveServer",
           "run_live_demo", "measure_streaming_latency", "MotionViewer",
           "StreamingMultiplexer"]
