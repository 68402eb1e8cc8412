r"""Temporal SMPLify refinement (port of ``robustcap_tpu/smplify/runner.py``).

Refines a sequence's axis-angle pose and translation against its 2-D
keypoints, the network's own 3-D prediction, a GMM pose prior and the IMU
orientations, with L-BFGS and a strong-Wolfe line search
(``ops/lbfgs.py``). The objective skins only the 33 landmark vertices.
Same-length sequences refine together as the lanes of one batched
optimization (each lane independent, finished lanes frozen); sequences are
padded to bucket lengths with a frame mask that removes the padding from the
objective.

As in the reference:

* the entry gate keeps the network's output when frame 0's reprojection
  loss exceeds ``loss_threshold``;
* the ignored landmarks (1..9, 31, 32 without the head; 31, 32 with it) get
  confidence 0;
* ``smplify_runner`` returns an ``update`` mask of the frames whose
  reprojection loss improved, and the refined values regardless.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import IMU_JOINT_MASK, MP_VERTEX_MASK, paths
from ..device import resolve_device
from ..math.angular import (axis_angle_to_rotation_matrix,
                            rotation_matrix_to_axis_angle)
from ..ops.lbfgs import lbfgs_minimize, lbfgs_minimize_lanes
from ..smpl.model import ParametricModel, default_body_model
from .losses import temporal_body_fitting_loss
from .prior import MaxMixturePrior

__all__ = ["TemporalSMPLify", "smplify_runner", "make_smplify_fit",
           "refine_sequences_batched"]

IGN_MP_JOINTS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 31, 32]
IGN_MP_JOINTS_HEAD = [31, 32]


def _sync_mp3d_batch(verts_mp, joints):
    r"""The 33 landmarks from the landmark vertices ``verts_mp`` [..., 33, 3]
    and the joints [..., 24, 3]: shoulders to wrists, hips, knees and ankles
    taken from the joints (built out of place, so autograd holds)."""
    return torch.cat([verts_mp[..., :11, :], joints[..., 16:22, :],
                      verts_mp[..., 17:23, :], joints[..., 1:3, :],
                      joints[..., 4:6, :], joints[..., 7:9, :],
                      verts_mp[..., 29:, :]], -2)


def _confidence(kp_px, ign):
    r"""The keypoints' confidence with the ignored landmarks set to 0."""
    conf = kp_px[..., 2].clone()
    conf[..., ign] = 0.0
    return conf


def _landmarks(model, pose_R, tran, shape):
    r"""(global rotations, the 33 landmarks) of frames [N, 24, 3, 3]."""
    gp, joints, verts = model.forward_kinematics(
        pose_R, shape=shape, tran=tran, calc_mesh=True,
        vertex_ids=MP_VERTEX_MASK)
    return gp, _sync_mp3d_batch(verts, joints)


class TemporalSMPLify:
    r"""Sequence SMPLify optimizer, the reference's stateful object."""

    def __init__(self, cam_k, imu_ori, step_size: float = 1.0,
                 num_iters: int = 1, use_lbfgs: bool = True,
                 batch_size: int = 1, max_iter: int = 20, shape=None,
                 use_head: bool = False,
                 model: Optional[ParametricModel] = None,
                 prior: Optional[MaxMixturePrior] = None,
                 prior_folder: Optional[str] = None, device="cuda"):
        dev = resolve_device(device)
        self.device = dev
        self.model = model or default_body_model(dev)
        self.prior = prior or MaxMixturePrior(prior_folder, num_gaussians=8,
                                              device=dev)
        self.cam_k = torch.as_tensor(cam_k, dtype=torch.float32, device=dev)
        self.imu_ori = torch.as_tensor(imu_ori, dtype=torch.float32,
                                       device=dev)
        self.step_size = step_size
        self.num_iters = num_iters
        self.use_lbfgs = use_lbfgs
        self.max_iter = max_iter
        self.shape = None if shape is None else torch.as_tensor(
            np.asarray(shape, np.float32), device=dev)
        self.ign = IGN_MP_JOINTS_HEAD if use_head else IGN_MP_JOINTS

    def _as(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _loss(self, body_pose_aa, tran, joints_2d, joints_conf, imu_ori,
              mask, output="sum"):
        B = body_pose_aa.shape[0]
        pose_R = axis_angle_to_rotation_matrix(
            body_pose_aa.reshape(-1, 3)).reshape(B, 24, 3, 3)
        gp, model_joints = _landmarks(self.model, pose_R, tran, self.shape)
        return temporal_body_fitting_loss(
            body_pose_aa, model_joints, joints_2d,
            joints_conf * mask[:, None], self.prior, self.cam_k,
            self._target_3d, imu_ori, gp[:, IMU_JOINT_MASK], output=output,
            frame_mask=mask)

    def get_fitting_loss(self, pose, tran, keypoints_2d, mask=None):
        r"""Per-frame, per-landmark reprojection loss [B, 33] of the given
        motion; it also sets the 3-D consistency target."""
        pose_R = self._as(pose)
        B = pose_R.shape[0]
        pose_R = pose_R.reshape(B, 24, 3, 3)
        kp = self._as(keypoints_2d)
        mask = (torch.ones(B, device=self.device) if mask is None
                else self._as(mask))
        conf = _confidence(kp, self.ign)
        gp, model_joints = _landmarks(self.model, pose_R, self._as(tran),
                                      self.shape)
        self._target_3d = model_joints.detach()
        body_pose = rotation_matrix_to_axis_angle(pose_R).reshape(B, -1)
        return temporal_body_fitting_loss(
            body_pose, model_joints, kp[..., :2], conf * mask[:, None],
            self.prior, self.cam_k, self._target_3d, self.imu_ori,
            gp[:, IMU_JOINT_MASK], output="reprojection")

    def __call__(self, init_pose, init_tran, keypoints_2d, mask=None):
        r"""Optimize (pose, tran); returns (pose_R [B, 24, 3, 3], tran
        [B, 3], reprojection loss [B, 33])."""
        pose_R0 = self._as(init_pose)
        B = pose_R0.shape[0]
        pose_R0 = pose_R0.reshape(B, 24, 3, 3)
        tran0 = self._as(init_tran).reshape(B, 3)
        kp = self._as(keypoints_2d)
        mask = (torch.ones(B, device=self.device) if mask is None
                else self._as(mask))
        conf = _confidence(kp, self.ign)
        joints_2d = kp[..., :2]

        # consistency target: the network's own landmarks (frozen)
        _, lm0 = _landmarks(self.model, pose_R0, tran0, self.shape)
        self._target_3d = lm0.detach()
        body_pose0 = rotation_matrix_to_axis_angle(pose_R0).reshape(B, -1)
        x = torch.cat([body_pose0.reshape(-1), tran0.reshape(-1)])

        def loss_flat(x):
            return self._loss(x[:B * 72].reshape(B, 72),
                              x[B * 72:].reshape(B, 3), joints_2d, conf,
                              self.imu_ori, mask)

        if self.use_lbfgs:
            for _ in range(self.num_iters):
                x, _, _ = lbfgs_minimize(loss_flat, x,
                                         max_iter=self.max_iter,
                                         lr=self.step_size)
        else:
            # the reference's other branch: plain Adam steps (betas 0.9,
            # 0.999, eps 1e-8), written out in optax's order of operations
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu = torch.zeros_like(x)
            nu = torch.zeros_like(x)
            for i in range(1, self.num_iters + 1):
                with torch.enable_grad():
                    xg = x.detach().requires_grad_(True)
                    (g,) = torch.autograd.grad(loss_flat(xg), xg)
                mu = (1 - b1) * g + b1 * mu
                nu = (1 - b2) * g ** 2 + b2 * nu
                # the bias corrections in float32, as optax computes them
                n = np.float32(i)
                mu_hat = mu / float(1 - np.float32(b1) ** n)
                nu_hat = nu / float(1 - np.float32(b2) ** n)
                x = x + mu_hat / (torch.sqrt(nu_hat) + eps) * -self.step_size
        body_pose = x[:B * 72].reshape(B, 72)
        tran = x[B * 72:].reshape(B, 3)
        with torch.no_grad():
            reproj = self._loss(body_pose, tran, joints_2d, conf,
                                self.imu_ori, mask, output="reprojection")
        pose_R = axis_angle_to_rotation_matrix(
            body_pose.reshape(-1, 3)).reshape(B, 24, 3, 3)
        return pose_R, tran, reproj


def _pad_to(x, L):
    pad = L - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


def _fit_problem(model, prior, ign, shape, pose0_R, tran0, kp_px, imu_ori,
                 cam_k, mask):
    r"""The fitting problem of G same-length lanes (the inputs of ``fit``
    in :func:`make_smplify_fit`): ``(x0 [G, n], objective, loss_before
    [G, T], finish)``, where ``objective(x [G, n]) -> [G]`` and
    ``finish(x) -> (pose_R, tran, loss_after)``. A lane's ``x`` is its
    axis-angle pose [T, 72] then its translation [T, 3], flattened."""
    G, T = mask.shape
    conf = _confidence(kp_px, ign) * mask[..., None]
    imu_joints = torch.as_tensor(IMU_JOINT_MASK, device=mask.device)

    def landmarks(pose_R, tran):
        gp, lm = _landmarks(model, pose_R.reshape(G * T, 24, 3, 3),
                            tran.reshape(G * T, 3), shape)
        return (gp[:, imu_joints].reshape(G, T, 6, 3, 3),
                lm.reshape(G, T, 33, 3))

    def reproj_loss(body_pose, model_joints, ori):
        return temporal_body_fitting_loss(
            body_pose, model_joints, kp_px[..., :2], conf, prior, cam_k,
            target_3d, imu_ori, ori, output="reprojection").mean(-1)

    def split(x):
        return x[:, :T * 72].reshape(G, T, 72), x[:, T * 72:].reshape(G, T, 3)

    def rotations(bp):
        return axis_angle_to_rotation_matrix(bp.reshape(-1, 3)).reshape(
            G, T, 24, 3, 3)

    def objective(x):
        bp, tr = split(x)
        ori, mj = landmarks(rotations(bp), tr)
        return temporal_body_fitting_loss(
            bp, mj, kp_px[..., :2], conf, prior, cam_k, target_3d, imu_ori,
            ori, output="sum", frame_mask=mask)

    def finish(x):
        bp, tr = split(x)
        pose_R = rotations(bp)
        ori, mj = landmarks(pose_R, tr)
        return pose_R, tr, reproj_loss(bp, mj, ori)

    ori0, target_3d = landmarks(pose0_R, tran0)
    body_pose0 = rotation_matrix_to_axis_angle(pose0_R).reshape(G, T, 72)
    x0 = torch.cat([body_pose0.reshape(G, -1), tran0.reshape(G, -1)], 1)
    return x0, objective, reproj_loss(body_pose0, target_3d, ori0), finish


def make_smplify_fit(model: ParametricModel, prior: MaxMixturePrior,
                     use_head: bool = False, max_iter: int = 20,
                     lr: float = 1.0, num_iters: int = 1, shape=None):
    r"""The refinement of G same-length sequences as the lanes of one
    optimization.

    ``fit(pose0_R [G, T, 24, 3, 3], tran0 [G, T, 3], kp_px [G, T, 33, 3],
    imu_ori [G, T, 6, 3, 3], cam_k [G, 3, 3], mask [G, T]) -> (pose_R,
    tran, loss_before [G, T], loss_after [G, T])``, tensors on the model's
    device. Unlike :class:`TemporalSMPLify`, everything (camera, IMUs,
    targets) is an argument. A lane with mask 0 everywhere has objective 0
    and costs no line search."""
    ign = IGN_MP_JOINTS_HEAD if use_head else IGN_MP_JOINTS
    shape = None if shape is None else torch.as_tensor(
        np.asarray(shape, np.float32), device=model.device)

    def fit(pose0_R, tran0, kp_px, imu_ori, cam_k, mask):
        x, objective, loss_before, finish = _fit_problem(
            model, prior, ign, shape, pose0_R, tran0, kp_px, imu_ori, cam_k,
            mask)
        for _ in range(num_iters):
            x, _, _, _ = lbfgs_minimize_lanes(objective, x,
                                              max_iter=max_iter, lr=lr)
        pose_R, tran, loss_after = finish(x)
        return pose_R, tran, loss_before, loss_after

    return fit


_DEFAULT_PRIOR = {}


def _default_prior(folder: Optional[str] = None,
                   device="cuda") -> MaxMixturePrior:
    r"""The process-wide GMM prior of ``folder`` (by default
    ``config.paths.work_dir``) on ``device``, built once."""
    key = (folder or paths.work_dir, resolve_device(device))
    if key not in _DEFAULT_PRIOR:
        _DEFAULT_PRIOR[key] = MaxMixturePrior(key[0], num_gaussians=8,
                                              device=key[1])
    return _DEFAULT_PRIOR[key]


def refine_sequences_batched(results, seqs, lr: float = 0.001,
                             opt_steps: int = 1, use_head: bool = False,
                             model=None, prior=None,
                             pad_to_multiple: int = 128,
                             loss_threshold: float = 20000.0,
                             group_size: int = 16, device="cuda",
                             mesh=None):
    r"""Refine many sequences, ``group_size`` lanes at a time.

    Sequences are grouped by their length padded to ``pad_to_multiple``; a
    group's last lanes, where it has fewer sequences, repeat its last one
    with mask 0 and finish at once. A sequence whose frame-0 reprojection
    loss exceeds ``loss_threshold`` keeps the network's output. Returns
    ``[(pose [T, 24, 3, 3], tran [T, 3])]`` as numpy arrays, in input
    order. The model and prior must be on ``device``; the fit runs in the
    model's dtype.

    With ``mesh`` (``parallel.make_mesh``; ``device`` is then the mesh's)
    each rank fits its share of every group's lanes, so the ranks must
    divide ``group_size``, and every rank gathers and returns the whole
    list. Lanes are independent, so the split changes no lane's problem;
    a float32 fit at a small ``lr`` may still move with the lane count,
    through the order of the products' sums."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None and group_size % mesh.size:
        raise ValueError(f"group_size {group_size} must divide over the "
                         f"mesh's {mesh.size} ranks")
    model = model or default_body_model(dev)
    prior = prior or _default_prior(device=dev)
    dtype = model._v_template.dtype
    fit = make_smplify_fit(model, prior, use_head=use_head, max_iter=20,
                           lr=lr, num_iters=opt_steps)

    lengths = {}
    for i, s in enumerate(seqs):
        L = -(-s.length // pad_to_multiple) * pad_to_multiple
        lengths.setdefault(L, []).append(i)

    def stack(arrays, L=0):
        return torch.as_tensor(np.stack([_pad_to(np.asarray(a, np.float32),
                                                 L) for a in arrays]),
                               dtype=dtype, device=dev)

    out = [None] * len(seqs)
    for L, idxs in lengths.items():
        for g in range(0, len(idxs), group_size):
            group = idxs[g:g + group_size]
            n_real = len(group)
            lanes = group + [group[-1]] * (group_size - n_real)
            mask = np.stack([(np.arange(L) < seqs[i].length)
                             .astype(np.float32) for i in lanes])
            mask[n_real:] = 0.0
            if mesh is not None:
                rows = mesh.rows(group_size)
                lanes, mask = lanes[rows], mask[rows]
            pose_R, tr, before, _ = fit(
                stack([results[i][0] for i in lanes], L),
                stack([results[i][1] for i in lanes], L),
                stack([seqs[i].j2dc_px for i in lanes], L),
                stack([seqs[i].oric for i in lanes], L),
                stack([seqs[i].cam_K for i in lanes]),
                torch.as_tensor(mask, dtype=dtype, device=dev))
            if mesh is not None:
                pose_R, tr = mesh.gather(pose_R), mesh.gather(tr)
                before = mesh.gather(before)
            pose_R, tr = pose_R.cpu().numpy(), tr.cpu().numpy()
            before = before.cpu().numpy()
            for k, i in enumerate(group):
                T = seqs[i].length
                if before[k, 0] > loss_threshold:
                    out[i] = results[i]
                else:
                    out[i] = (pose_R[k, :T], tr[k, :T])
    return out


def smplify_runner(pred_pose, pred_tran, j2dc, imu_ori, batch_size, cam_k,
                   lr: float = 1.0, opt_steps: int = 1,
                   use_lbfgs: bool = True, loss_threshold: float = 20000.0,
                   shape=None, use_head: bool = False, model=None,
                   prior=None, pad_to_multiple: int = 64, device="cuda"):
    r"""Gate, optimize and update mask of one sequence.

    The sequence is padded (its last frame repeated, with mask 0) to a
    multiple of ``pad_to_multiple``. Returns ``(pose [T, 24, 3, 3], tran
    [T, 3], update [T])`` as numpy arrays; ``update`` marks the frames
    whose reprojection loss improved, and is ``None`` with the network's
    output where the gate keeps it."""
    dev = resolve_device(device)
    model = model or default_body_model(dev)
    prior = prior or _default_prior(device=dev)
    T = int(np.asarray(pred_pose).shape[0])
    L = -(-T // pad_to_multiple) * pad_to_multiple
    pose = _pad_to(np.asarray(pred_pose, np.float32).reshape(T, 24, 3, 3), L)
    tran = _pad_to(np.asarray(pred_tran, np.float32).reshape(T, 3), L)
    kp = _pad_to(np.asarray(j2dc, np.float32).reshape(T, 33, 3), L)
    ori = _pad_to(np.asarray(imu_ori, np.float32).reshape(T, 6, 3, 3), L)
    mask = (np.arange(L) < T).astype(np.float32)

    def gated_out():
        return (np.asarray(pred_pose).reshape(-1, 24, 3, 3),
                np.asarray(pred_tran).reshape(-1, 3), None)

    if shape is not None or not use_lbfgs:
        # fixed betas and the Adam branch keep the stateful object; the
        # evaluation only ever takes the L-BFGS default
        smplify = TemporalSMPLify(cam_k=cam_k, imu_ori=ori, step_size=lr,
                                  batch_size=L, num_iters=opt_steps,
                                  use_lbfgs=use_lbfgs, shape=shape,
                                  use_head=use_head, model=model, prior=prior,
                                  device=dev)
        before = smplify.get_fitting_loss(pose, tran, kp, mask).mean(-1)
        if float(before[0]) > loss_threshold:
            return gated_out()
        pose_R, tran_new, new_loss = smplify(pose, tran, kp, mask)
        update = (new_loss.mean(-1) < before).cpu().numpy()[:T]
        return (pose_R.detach().cpu().numpy()[:T],
                tran_new.detach().cpu().numpy()[:T], update)

    def lane(x):
        return torch.as_tensor(x[None], device=dev)

    fit = make_smplify_fit(model, prior, use_head=use_head, max_iter=20,
                           lr=lr, num_iters=opt_steps)
    pose_R, tran_new, before, after = fit(
        lane(pose), lane(tran), lane(kp), lane(ori),
        lane(np.asarray(cam_k, np.float32)), lane(mask))
    if float(before[0, 0]) > loss_threshold:
        return gated_out()
    update = (after[0] < before[0]).cpu().numpy()[:T]
    return (pose_R[0].cpu().numpy()[:T], tran_new[0].cpu().numpy()[:T],
            update)
