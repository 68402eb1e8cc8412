r"""Joint-id enums of the supported body armatures (a copy of
``robustcap_tpu/smpl/armature.py``)."""

import enum

__all__ = ["SMPLJoint", "MANOJoint", "SMPLHJoint"]


class SMPLJoint(enum.Enum):
    r"""SMPL 24-joint armature."""
    ROOT = 0
    PELVIS = 0
    SPINE = 0
    LHIP = 1
    RHIP = 2
    SPINE1 = 3
    LKNEE = 4
    RKNEE = 5
    SPINE2 = 6
    LANKLE = 7
    RANKLE = 8
    SPINE3 = 9
    LFOOT = 10
    RFOOT = 11
    NECK = 12
    LCLAVICLE = 13
    RCLAVICLE = 14
    HEAD = 15
    LSHOULDER = 16
    RSHOULDER = 17
    LELBOW = 18
    RELBOW = 19
    LWRIST = 20
    RWRIST = 21
    LHAND = 22
    RHAND = 23


class MANOJoint(enum.Enum):
    r"""MANO 16-joint hand armature."""
    ROOT = 0
    WRIST = 0
    INDEX1 = 1
    INDEX2 = 2
    INDEX3 = 3
    MIDDLE1 = 4
    MIDDLE2 = 5
    MIDDLE3 = 6
    PINKY1 = 7
    PINKY2 = 8
    PINKY3 = 9
    RING1 = 10
    RING2 = 11
    RING3 = 12
    THUMB1 = 13
    THUMB2 = 14
    THUMB3 = 15


class SMPLHJoint(enum.Enum):
    r"""SMPL-H 52-joint armature (body + two MANO hands)."""
    ROOT = 0
    PELVIS = 0
    LHIP = 1
    RHIP = 2
    SPINE1 = 3
    LKNEE = 4
    RKNEE = 5
    SPINE2 = 6
    LANKLE = 7
    RANKLE = 8
    SPINE3 = 9
    LFOOT = 10
    RFOOT = 11
    NECK = 12
    LCLAVICLE = 13
    RCLAVICLE = 14
    HEAD = 15
    LSHOULDER = 16
    RSHOULDER = 17
    LELBOW = 18
    RELBOW = 19
    LWRIST = 20
    RWRIST = 21
    LINDEX1 = 22
    LINDEX2 = 23
    LINDEX3 = 24
    LMIDDLE1 = 25
    LMIDDLE2 = 26
    LMIDDLE3 = 27
    LPINKY1 = 28
    LPINKY2 = 29
    LPINKY3 = 30
    LRING1 = 31
    LRING2 = 32
    LRING3 = 33
    LTHUMB1 = 34
    LTHUMB2 = 35
    LTHUMB3 = 36
    RINDEX1 = 37
    RINDEX2 = 38
    RINDEX3 = 39
    RMIDDLE1 = 40
    RMIDDLE2 = 41
    RMIDDLE3 = 42
    RPINKY1 = 43
    RPINKY2 = 44
    RPINKY3 = 45
    RRING1 = 46
    RRING2 = 47
    RRING3 = 48
    RTHUMB1 = 49
    RTHUMB2 = 50
    RTHUMB3 = 51
