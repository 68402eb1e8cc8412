r"""SMPLify fitting objective (port of ``robustcap_tpu/smplify/losses.py``).

Geman-McClure-robust reprojection, the GMM pose prior, the knee/elbow angle
prior, root-relative 3-D consistency with the network's prediction,
IMU-orientation consistency and 2-D/3-D smoothness, with the reference's
weights. The reference converts rotations to axis-angle through cv2 and so
detaches the IMU term from the autodiff graph; here both conversions run on
detached tensors, so that term has a value and no gradient.

Every tensor may carry leading lane axes before the frame axis (``[..., T,
...]``), so G sequences of one length are one call: the sums run over each
lane's own frames.
"""

from __future__ import annotations

import torch

from ..math.angular import rotation_matrix_to_axis_angle
from .prior import angle_prior

__all__ = ["gmof", "temporal_body_fitting_loss",
           "temporal_ori_tran_fitting_loss"]


def gmof(x, sigma):
    r"""Geman-McClure robustifier."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def _project(points, cam_k):
    r"""Pixel coordinates ``[..., T, J, 2]`` of camera-frame points through
    ``cam_k`` ([3, 3], or [..., 3, 3] per lane)."""
    kt = cam_k.transpose(-1, -2)
    if kt.dim() > 2:
        kt = kt.unsqueeze(-3)
    return ((points / points[..., 2:]) @ kt)[..., :2]


def _smooth(conf, x):
    r"""Confidence-weighted L1 of frame-to-frame changes, 0 on the first
    frame: [..., T, J, C] -> [..., T]."""
    s = ((conf[..., 1:, :] ** 2)
         * (x[..., 1:, :, :] - x[..., :-1, :, :]).abs().sum(-1)).sum(-1)
    return torch.cat([torch.zeros_like(s[..., :1]), s], -1)


def temporal_body_fitting_loss(body_pose, model_joints, joints_2d,
                               joints_conf, pose_prior, cam_k, body_3d_joint,
                               imu_ori, ori, sigma=100.0,
                               pose_prior_weight=0.1,
                               angle_prior_weight=15.2,
                               smooth_2d_weight=0.01, smooth_3d_weight=1.0,
                               body_3d_weight=1.0, imu_ori_weight=0.5,
                               output="sum", frame_mask=None):
    r"""Sequence fitting loss.

    body_pose [..., T, 72] axis-angle, model_joints [..., T, 33, 3]
    synthesized landmarks (camera frame, with translation), joints_2d
    [..., T, 33, 2] pixels, joints_conf [..., T, 33], body_3d_joint
    [..., T, 33, 3] the network's initial landmarks (consistency target),
    imu_ori [..., T, 6, 3, 3] measured, ori [..., T, 6, 3, 3] FK
    orientations at the IMU joints, cam_k [3, 3] or [..., 3, 3].

    ``output="sum"`` gives the objective of each sequence ([...]);
    ``frame_mask`` [..., T] removes padded frames from it entirely (priors,
    3-D and IMU terms included, which confidence weighting alone would
    leave in). ``output="reprojection"`` gives the per-joint reprojection
    term [..., T, 33].
    """
    lead = body_pose.shape[:-1]
    # root-relative 3-D consistency with the initial prediction
    tgt = body_3d_joint[..., 1:, :] - body_3d_joint[..., :1, :]
    pred = model_joints[..., 1:, :] - model_joints[..., :1, :]
    body_3d_loss = (body_3d_weight ** 2) * ((pred - tgt) ** 2).sum(-1)

    projected = _project(model_joints, cam_k)

    # IMU orientation consistency: value only (see the module docstring)
    aa_meas = rotation_matrix_to_axis_angle(imu_ori.detach()).reshape(
        *lead, -1)
    aa_pred = rotation_matrix_to_axis_angle(ori.detach()).reshape(*lead, -1)
    imu_loss = (imu_ori_weight ** 2) * ((aa_meas - aa_pred) ** 2).sum(-1)

    reproj = (joints_conf ** 2) * gmof(projected - joints_2d, sigma).sum(-1)

    pose_axis = body_pose[..., 3:]
    prior_loss = (pose_prior_weight ** 2) * pose_prior(pose_axis, None)
    ang_loss = (angle_prior_weight ** 2) * angle_prior(pose_axis).sum(-1)

    total = (reproj.sum(-1) + prior_loss + ang_loss + body_3d_loss.sum(-1)
             + imu_loss)
    total = total + (smooth_2d_weight ** 2) * _smooth(joints_conf, projected) \
        + (smooth_3d_weight ** 2) * _smooth(joints_conf, model_joints)

    if output == "sum":
        if frame_mask is not None:
            total = total * frame_mask
        return total.sum(-1)
    if output == "reprojection":
        return reproj
    raise ValueError(output)


def temporal_ori_tran_fitting_loss(model_joints, joints_2d, joints_conf,
                                   body_3d_joint, body_3d_loss_weight=1000.0):
    r"""Shoulders/hips-only orientation and translation objective (unused
    by the main path, kept for parity): [..., T, 33, *] -> [...]."""
    projected = (model_joints / model_joints[..., 2:])[..., :2]
    smpl_ind = [16, 17, 1, 2]
    mp_ind = [11, 12, 23, 24]
    err = (joints_2d[..., mp_ind, :] - projected[..., smpl_ind, :]) ** 2
    valid = (torch.amin(joints_conf[..., mp_ind], -1)[..., None, None] > 0
             ).to(err.dtype)
    reproj = (valid * err).sum((-2, -1))
    b3d = (body_3d_joint[..., smpl_ind, :]
           - model_joints[..., smpl_ind, :]) ** 2
    return (reproj + body_3d_loss_weight * b3d.sum((-2, -1))).sum(-1)
