r"""Motion metrics on torch tensors (port of
``robustcap_tpu/eval/evaluator.py``, the reference's
``articulate/evaluator.py`` family): every metric over a whole sequence at
once, on the body model's device.

Inputs may be numpy arrays or tensors; results are tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..math.angular import (RotationRepresentation, angle_between,
                            radian_to_degree, svd_rotate, to_rotation_matrix)
from ..smpl.model import ParametricModel

__all__ = [
    "BinaryConfusionMatrixEvaluator", "BinaryClassificationErrorEvaluator",
    "PositionErrorEvaluator", "RotationErrorEvaluator",
    "PerJointErrorEvaluator", "MeanPerJointErrorEvaluator",
    "MeshErrorEvaluator", "FullMotionEvaluator",
]


def _t(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class BinaryConfusionMatrixEvaluator:
    r"""2x2 confusion matrix; entry (i, j) counts class i classified as j,
    with the positive class encoded as 0 as in the reference."""

    def __init__(self, is_after_sigmoid: bool = False):
        self.is_after_sigmoid = is_after_sigmoid

    def __call__(self, p, t):
        p, t = _t(p), _t(t)
        pred = (p > 0.5) if self.is_after_sigmoid else (p > 0)
        pos = t == 0
        tp = ((pred == 0) & pos).sum()
        fn = ((pred != 0) & pos).sum()
        fp = ((pred == 0) & ~pos).sum()
        tn = ((pred != 0) & ~pos).sum()
        return torch.stack([torch.stack([tp, fn]), torch.stack([fp, tn])])


class BinaryClassificationErrorEvaluator:
    r"""Precision, recall and F1 of the positive (1) and negative samples,
    ``[3, 2]``."""

    def __init__(self, is_after_sigmoid: bool = False):
        self.is_after_sigmoid = is_after_sigmoid

    def __call__(self, p, t):
        p, t = _t(p), _t(t)
        pred = ((p > 0.5) if self.is_after_sigmoid else (p > 0)).float()
        tp = ((pred == 1) & (t == 1)).sum().float()
        fn = ((pred == 0) & (t == 1)).sum().float()
        fp = ((pred == 1) & (t == 0)).sum().float()
        tn = ((pred == 0) & (t == 0)).sum().float()
        prec_p, rec_p = tp / (tp + fp), tp / (tp + fn)
        prec_n, rec_n = tn / (tn + fn), tn / (tn + fp)
        f1_p = 2 / (1 / prec_p + 1 / rec_p)
        f1_n = 2 / (1 / prec_n + 1 / rec_n)
        return torch.stack([torch.stack([prec_p, prec_n]),
                            torch.stack([rec_p, rec_n]),
                            torch.stack([f1_p, f1_n])])


class PositionErrorEvaluator:
    r"""Mean p-norm distance between two point sets."""

    def __init__(self, dimension: int = 3, p: int = 2):
        self.dimension = dimension
        self.p = p

    def __call__(self, pred, true):
        d = (_t(pred).reshape(-1, self.dimension)
             - _t(true).reshape(-1, self.dimension))
        return torch.linalg.vector_norm(d, ord=self.p, dim=1).mean()


class RotationErrorEvaluator:
    r"""Mean angle in degrees between two sets of rotations."""

    def __init__(self, rep=RotationRepresentation.ROTATION_MATRIX):
        self.rep = rep

    def __call__(self, p, t):
        return radian_to_degree(angle_between(_t(p), _t(t), self.rep).mean())


class _BasePoseEvaluator:
    def __init__(self, official_model_file=None,
                 rep=RotationRepresentation.ROTATION_MATRIX,
                 use_pose_blendshape=False,
                 model: Optional[ParametricModel] = None, device="cuda"):
        self.model = model or ParametricModel(
            official_model_file, use_pose_blendshape=use_pose_blendshape,
            device=device)
        self.rep = rep

    def _pose(self, pose):
        pose = _t(pose, self.model.device)
        return to_rotation_matrix(pose, self.rep).reshape(pose.shape[0], -1,
                                                          3, 3)

    def _opt(self, x):
        return None if x is None else _t(x, self.model.device)


def _aligned(points_p, points_t, joint_p, joint_t, align_joint: int):
    r"""``align_joint >= 0`` moves the prediction so that joint coincides;
    -1..-5 apply subsets of a Procrustes alignment (R, t, s)."""
    if align_joint >= 0:
        offset = (joint_t[:, align_joint] - joint_p[:, align_joint])[:, None]
        return points_p + offset
    calc_R, calc_t, calc_s = {-1: (True, True, True), -2: (True, True, False),
                              -3: (False, True, True),
                              -4: (False, True, False),
                              -5: (False, False, True)}[align_joint]
    return svd_rotate(points_p, points_t, calc_R=calc_R, calc_t=calc_t,
                      calc_s=calc_s)[3]


def _align_value(align_joint):
    return align_joint if isinstance(align_joint, int) else align_joint.value


class PerJointErrorEvaluator(_BasePoseEvaluator):
    r"""Per-joint position error and local and global angle errors,
    ``[3, J]``."""

    def __init__(self, official_model_file=None, align_joint=0,
                 rep=RotationRepresentation.ROTATION_MATRIX, model=None,
                 device="cuda"):
        super().__init__(official_model_file, rep, model=model, device=device)
        self.align_joint = _align_value(align_joint)

    def __call__(self, pose_p, pose_t):
        pose_p, pose_t = self._pose(pose_p), self._pose(pose_t)
        glb_p, joint_p = self.model.forward_kinematics(pose_p)
        glb_t, joint_t = self.model.forward_kinematics(pose_t)
        joint_aligned = _aligned(joint_p, joint_t, joint_p, joint_t,
                                 self.align_joint)
        B = pose_p.shape[0]
        pos_err = torch.linalg.vector_norm(joint_aligned - joint_t,
                                           dim=2).mean(0)
        lae = angle_between(pose_p, pose_t).reshape(B, -1).mean(0)
        gae = angle_between(glb_p, glb_t).reshape(B, -1).mean(0)
        return torch.stack((pos_err, radian_to_degree(lae),
                            radian_to_degree(gae)))


class MeanPerJointErrorEvaluator(PerJointErrorEvaluator):
    r"""The mean over joints of :class:`PerJointErrorEvaluator`, ``[3]``."""

    def __call__(self, pose_p, pose_t):
        return super().__call__(pose_p, pose_t).mean(1)


class MeshErrorEvaluator(_BasePoseEvaluator):
    r"""Mean mesh vertex position error."""

    def __init__(self, official_model_file=None, align_joint=0,
                 rep=RotationRepresentation.ROTATION_MATRIX,
                 use_pose_blendshape=False, model=None, device="cuda"):
        super().__init__(official_model_file, rep, use_pose_blendshape, model,
                         device)
        self.align_joint = _align_value(align_joint)

    def __call__(self, pose_p, pose_t, shape_p=None, shape_t=None):
        pose_p, pose_t = self._pose(pose_p), self._pose(pose_t)
        _, joint_p, mesh_p = self.model.forward_kinematics(
            pose_p, self._opt(shape_p), calc_mesh=True)
        _, joint_t, mesh_t = self.model.forward_kinematics(
            pose_t, self._opt(shape_t), calc_mesh=True)
        mesh_aligned = _aligned(mesh_p, mesh_t, joint_p, joint_t,
                                self.align_joint)
        return torch.linalg.vector_norm(mesh_aligned - mesh_t, dim=2).mean()


class FullMotionEvaluator(_BasePoseEvaluator):
    r"""The full-motion battery, ``[11, 2]`` (mean, std):

      0 joint position error    1 vertex error       2 local angle error
      3 global angle error      4 predicted jerk     5 true jerk
      6 1-s translation drift   7-9 masked variants  10 tracking error
    """

    def __init__(self, official_model_file=None, align_joint=0,
                 rep=RotationRepresentation.ROTATION_MATRIX,
                 use_pose_blendshape=False, fps: int = 60,
                 joint_mask: Optional[list] = None, model=None,
                 device="cuda"):
        super().__init__(official_model_file, rep, use_pose_blendshape, model,
                         device)
        self.align_joint = _align_value(align_joint)
        self.fps = fps
        self.joint_mask = joint_mask

    def __call__(self, pose_p, pose_t, shape_p=None, shape_t=None,
                 tran_p=None, tran_t=None):
        f = self.fps
        pose_p, pose_t = self._pose(pose_p), self._pose(pose_t)
        glb_p, joint_p, vert_p = self.model.forward_kinematics(
            pose_p, self._opt(shape_p), self._opt(tran_p), calc_mesh=True)
        glb_t, joint_t, vert_t = self.model.forward_kinematics(
            pose_t, self._opt(shape_t), self._opt(tran_t), calc_mesh=True)

        def norm(x):
            return torch.linalg.vector_norm(x, dim=2)

        offset = (joint_t[:, self.align_joint]
                  - joint_p[:, self.align_joint])[:, None]
        B = pose_p.shape[0]
        tre = norm(joint_p - joint_t)
        ve = norm(vert_p + offset - vert_t)
        je = norm(joint_p + offset - joint_t)
        lae = radian_to_degree(angle_between(pose_p, pose_t).reshape(B, -1))
        gae = radian_to_degree(angle_between(glb_p, glb_t).reshape(B, -1))
        jkp = norm((joint_p[3:] - 3 * joint_p[2:-1] + 3 * joint_p[1:-2]
                    - joint_p[:-3]) * f ** 3)
        jkt = norm((joint_t[3:] - 3 * joint_t[2:-1] + 3 * joint_t[1:-2]
                    - joint_t[:-3]) * f ** 3)
        te = norm((joint_p[f:, :1] - joint_p[:-f, :1])
                  - (joint_t[f:, :1] - joint_t[:-f, :1]))
        if self.joint_mask is not None:
            mask = list(self.joint_mask)
            mje, mlae, mgae = je[:, mask], lae[:, mask], gae[:, mask]
        else:
            mje = mlae = mgae = je.new_zeros((1, 1))

        def ms(x):
            if x.numel() == 0 or x.shape[0] < 2:
                # shorter than the metric's window (e.g. under fps frames
                # for the 1-s drift): zeros rather than NaN
                return x.new_zeros(2)
            return torch.stack([x.mean(), x.std(0).mean()])

        return torch.stack([ms(je), ms(ve), ms(lae), ms(gae), ms(jkp),
                            ms(jkt), ms(te), ms(mje), ms(mlae), ms(mgae),
                            ms(tre)])
