r"""Network feature flags and skeleton constants of the SigMP path.

The port's own copy of what it needs from ``robustcap_tpu/config.py`` (same
field names, defaults and values), so that the port never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

__all__ = [
    "Paths", "paths", "AmassSplits", "HUMBIBody33", "SigMPConfig",
    "EVAL_PROFILES", "LiveConfig",
    "PW3D_OCCLUDED_SEQUENCES", "VEL_SCALE", "TRAN_OFFSET", "MP_VERTEX_MASK",
    "IMU_VERTEX_MASK", "IMU_JOINT_MASK", "SMPL_PARENT",
]


@dataclasses.dataclass(frozen=True)
class Paths:
    r"""Where the data lives: ``ROBUSTCAP_DATA`` or ``data`` by default."""
    data_root: str = os.environ.get("ROBUSTCAP_DATA", "data")

    @property
    def smpl_file(self):
        return os.path.join(self.data_root, "models/SMPL_male.pkl")

    @property
    def smpl_file_female(self):
        return os.path.join(self.data_root, "models/SMPL_female.pkl")

    @property
    def work_dir(self):
        return os.path.join(self.data_root, "dataset_work")

    @property
    def aist_dir(self):
        return os.path.join(self.work_dir, "AIST")

    @property
    def amass_dir(self):
        return os.path.join(self.work_dir, "AMASS")

    @property
    def totalcapture_dir(self):
        return os.path.join(self.work_dir, "TotalCapture")

    @property
    def pw3d_dir(self):
        return os.path.join(self.work_dir, "3DPW")

    @property
    def weight_dir(self):
        return os.path.join(self.data_root, "weights")

    @property
    def j_regressor_file(self):
        return os.path.join(self.work_dir, "J_regressor_h36m.npy")

    @property
    def gmm_prior_file(self):
        return os.path.join(self.work_dir, "gmm_08.pkl")

    @property
    def syn_conf_file(self):
        return os.path.join(self.work_dir, "syn_c.pt")

    @property
    def temp_dir(self):
        return os.path.join(self.data_root, "temp")


paths = Paths()


class AmassSplits:
    r"""The AMASS sub-corpora of each split (the reference's)."""
    train = ["ACCAD", "BioMotionLab_NTroje", "BMLhandball", "BMLmovi", "CMU",
             "DanceDB", "DFaust67", "EKUT", "Eyes_Japan_Dataset", "GRAB",
             "HUMAN4D", "KIT", "MPI_Limits", "TCD_handMocap", "TotalCapture"]
    val = ["HumanEva", "MPI_HDM05", "MPI_mosh", "SFU", "SOMA", "WEIZMANN",
           "Transitions_mocap", "SSM_synced"]
    test = []


class HUMBIBody33:
    r"""33-keypoint body skeleton matching MediaPipe Pose landmark layout."""
    n_keypoints = 33

    labels = [
        "pelvis",
        "left_hip", "right_hip",
        "lowerback",
        "left_knee", "right_knee",
        "upperback",
        "left_ankle", "right_ankle",
        "thorax",
        "left_toes", "right_toes",
        "lowerneck",
        "left_clavicle", "right_clavicle",
        "upperneck",
        "left_shoulder", "right_shoulder",
        "left_elbow", "right_elbow",
        "left_wrist", "right_wrist",
        "head_top", "left_eye", "right_eye",
        "left_hand_I0", "left_hand_L0",
        "right_hand_I0", "right_hand_L0",
        "left_foot_T0", "left_foot_L0",
        "right_foot_T0", "right_foot_L0",
    ]

    parents = [None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
               16, 17, 18, 19, 15, 15, 15, 20, 20, 21, 21, 7, 7, 8, 8]

    # SMPL mesh vertex ids realizing the extended (non-SMPL-joint) keypoints
    extended_keypoints = {
        22: 411, 23: 2800, 24: 6260,
        25: 2135, 26: 2062,
        27: 5595, 28: 5525,
        29: 3292, 30: 3318,
        31: 6691, 32: 6718,
    }


# Root-velocity scale used when training/integrating rnn3
VEL_SCALE = 3
# SMPL root offset in mean shape
TRAN_OFFSET = (0.0, 0.25, 5.0)

# SMPL mesh vertex for each of the 33 MediaPipe landmarks
MP_VERTEX_MASK = [332, 2809, 2800, 455, 6260, 3634, 3621, 583, 4071, 45, 3557,
                  1873, 4123, 1652, 5177, 2235, 5670, 2673, 6133, 2319, 5782,
                  2746, 6191, 3138, 6528, 1176, 4662, 3381, 6727, 3387, 6787,
                  3226, 6624]
# SMPL vertices whose synthetic acceleration stands in for the 6 IMUs
# (L/R forearm, L/R lower leg, head, pelvis)
IMU_VERTEX_MASK = [1961, 5424, 1176, 4662, 411, 3021]
# SMPL joints whose global orientation stands in for the 6 IMU orientations
# (L/R elbow, L/R knee, head, pelvis)
IMU_JOINT_MASK = [18, 19, 4, 5, 15, 0]

# SMPL 24-joint kinematic tree (kintree_table row 0 of the official model)
SMPL_PARENT = [None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
               16, 17, 18, 19, 20, 21]


@dataclasses.dataclass(frozen=True)
class SigMPConfig:
    r"""Fusion-network feature flags (the JAX package's ``SigMPConfig``).

    ``pallas_inertial`` runs the rnn2/rnn3 chunk pre-scan through the
    LSTM-scan kernel (``ops/lstm_scan.py``), ``pallas_tail`` the per-frame
    geometry tail through the tail kernel (``ops/geometry_tail.py``), and
    ``pallas_serve`` the whole steady step of ``forward_offline`` and
    ``StreamingNet.forward_chunk`` through the serve kernel
    (``ops/serve_scan.py``, one launch per chunk, in the weights' mode).
    The names are kept from the JAX package so one config value means the
    same thing in both. ``int8_compute`` runs the gate products of int8
    weight records on int8 activations (``nn/rnn.py``).
    """
    hidden_size: int = 512
    imu_num: int = 6
    conf_range: Tuple[float, float] = (0.7, 0.8)
    contact_threshold: float = 0.7
    smooth: float = 1.0
    use_flat_floor: bool = True
    use_reproj_opt: bool = False
    use_vision_updater: bool = True
    use_imu_updater: bool = True
    height_threshold: float = 0.15
    distance_threshold: float = 10.0
    tran_filter_num: float = 0.05
    live: bool = False
    update_vision_freq: int = 30
    name: str = "sig_mp"
    int8_compute: bool = False
    pallas_inertial: bool = False
    pallas_tail: bool = False
    pallas_serve: bool = False

    @staticmethod
    def offline() -> "SigMPConfig":
        return SigMPConfig()

    @staticmethod
    def live_mode() -> "SigMPConfig":
        r"""Live-demo flag set."""
        return SigMPConfig(live=True, conf_range=(0.85, 0.9),
                           tran_filter_num=0.01)


# Per-dataset evaluation profiles: 3DPW disables the flat-floor constraint;
# TotalCapture seeds with first_frame=True instead of a ground-truth first
# translation.
EVAL_PROFILES = {
    "aist": dict(config=SigMPConfig(), first_tran_mode="gt", num_cameras=9),
    "totalcapture": dict(config=SigMPConfig(), first_tran_mode="first_frame",
                         num_cameras=8),
    "pw3d": dict(config=SigMPConfig(use_flat_floor=False),
                 first_tran_mode="gt", num_cameras=1),
    "pw3d_occ": dict(config=SigMPConfig(use_flat_floor=False),
                     first_tran_mode="gt", num_cameras=1),
}



@dataclasses.dataclass(frozen=True)
class LiveConfig:
    r"""Live capture hardware and the live pipeline's ports (the JAX
    package's ``LiveConfig``)."""
    camera_intrinsic: Tuple = ((623.79949084, 0.0, 313.69863974),
                               (0.0, 623.09646347, 236.76807598),
                               (0.0, 0.0, 1.0))
    camera_height: int = 480
    camera_width: int = 640
    camera_id: int = 0
    imu_addrs: Tuple[str, ...] = (
        "D4:22:CD:00:36:03", "D4:22:CD:00:44:6E", "D4:22:CD:00:45:E6",
        "D4:22:CD:00:45:EC", "D4:22:CD:00:46:0F", "D4:22:CD:00:32:32")
    fps: int = 60
    imu_udp_port: int = 8777
    detector_udp_port: int = 9999
    unity_tcp_port: int = 8888


# 3DPW sequences with significant occlusion
PW3D_OCCLUDED_SEQUENCES = [
    "courtyard_backpack", "courtyard_basketball",
    "courtyard_bodyScannerMotions", "courtyard_box", "courtyard_golf",
    "courtyard_jacket", "courtyard_laceShoe", "downtown_stairs",
    "flat_guitar", "flat_packBags", "outdoors_climbing",
    "outdoors_crosscountry", "outdoors_fencing", "outdoors_freestyle",
    "outdoors_golf", "outdoors_parcours", "outdoors_slalom",
]
