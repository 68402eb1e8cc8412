r"""Live sensor drivers: the Xsens DOT BLE stack, the MVNX reader, the
Noitom MocapApi, camera calibration and capture, and the IMU bridge."""

from .xsens import (XsensDotSet, parse_complete_quaternion,  # noqa: F401
                    encode_complete_quaternion, CompleteQuaternionPayload)
from .xdc_codec import (UUIDS, PayloadMode, PAYLOAD_FORMATS,  # noqa: F401
                        payload_size, parse_payload, encode_payload,
                        DeviceInfo, DeviceControl, DeviceReport,
                        MeasurementControl, Battery, DotClient,
                        FakeDotTransport, parse_device_info,
                        parse_device_control, encode_device_control,
                        parse_device_report, parse_battery)
from .mvnx import read_mvnx  # noqa: F401
from .bridge import run_imu_bridge, SyntheticImuSource  # noqa: F401
from .capture import record_video, read_dot_export_csvs  # noqa: F401
from .calibration import (calibrate_intrinsics_zhang,  # noqa: F401
                          calibrate_camera_chessboard)
from .noitom import MocapApi, NoitomFrame  # noqa: F401

__all__ = ["XsensDotSet", "parse_complete_quaternion",
           "encode_complete_quaternion", "CompleteQuaternionPayload", "UUIDS",
           "PayloadMode", "PAYLOAD_FORMATS", "payload_size", "parse_payload",
           "encode_payload", "DeviceInfo", "DeviceControl", "DeviceReport",
           "MeasurementControl", "Battery", "DotClient", "FakeDotTransport",
           "parse_device_info", "parse_device_control",
           "encode_device_control", "parse_device_report", "parse_battery",
           "read_mvnx", "run_imu_bridge", "SyntheticImuSource",
           "record_video", "read_dot_export_csvs",
           "calibrate_intrinsics_zhang", "calibrate_camera_chessboard",
           "MocapApi", "NoitomFrame"]
