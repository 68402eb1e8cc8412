r"""Streaming runtime: the wire formats, the live server, the latency
harness and the multiplexer. (The JAX package's native datapath, sync,
Unity viewer and detector are not ported yet.)"""

from .latency import measure_streaming_latency  # noqa: F401
from .multiplex import StreamingMultiplexer  # noqa: F401
from .protocol import (encode_detector_packet,  # noqa: F401
                       encode_unity_frame, parse_detector_packet,
                       parse_unity_frame)
from .server import LiveServer, run_live_demo  # noqa: F401

__all__ = ["encode_detector_packet", "parse_detector_packet",
           "encode_unity_frame", "parse_unity_frame", "LiveServer",
           "run_live_demo", "measure_streaming_latency",
           "StreamingMultiplexer"]
