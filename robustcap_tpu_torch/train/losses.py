r"""Masked sequence losses of the per-RNN trainers (port of
``robustcap_tpu/train/losses.py``).

Every loss takes ``(ys [T, B, D], labels [T, B, D], lengths [B])`` and
counts only the frames before each row's length: masked equivalents of the
reference's MSE over the concatenated batch, its rnn3 multi-horizon
velocity loss, rnn7's FK-weighted pose loss and rnn8's pos-weighted BCE.
``lengths`` may lie on the host (it is uploaded without waiting for the
device). rnn3's horizon windows are taken per sequence, where the
reference's concatenated batch lets them straddle two sequences.

Each loss is a sum over valid frames divided by a count of valid frames,
and every count is a function of the lengths alone. ``count_lengths``
(default ``lengths``) gives the lengths the counts are taken over: under
data parallelism a rank passes its own rows and the global batch's
lengths, so the ranks' losses sum to the loss of the whole batch (a mean
of the ranks' means would weight each rank alike, whatever its number of
valid frames).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..math.angular import r6d_to_rotation_matrix_nd

__all__ = ["masked_mse", "masked_distance", "velocity_horizon_loss",
           "make_fk_pose_loss", "masked_bce_pos_weight"]


def _lengths(ys, lengths):
    return torch.as_tensor(lengths).to(ys.device, non_blocking=True)


def _mask(ys, lengths):
    r"""[T, B] in ``ys``' dtype: 1 where frame t < the row's length."""
    T = ys.shape[0]
    return (torch.arange(T, device=ys.device)[:, None]
            < _lengths(ys, lengths)[None]).to(ys.dtype)


def _count_lengths(ys, lengths, count_lengths):
    r"""The lengths the denominators count: ``count_lengths`` where given
    (the global batch's), else ``lengths``."""
    return _lengths(ys, lengths if count_lengths is None else count_lengths)


def _count(ys, lengths, count_lengths):
    r"""The number of valid frames the denominators count."""
    return _count_lengths(ys, lengths, count_lengths).sum().to(ys.dtype)


def masked_mse(ys, labels, lengths, count_lengths=None):
    r"""Mean squared error over the valid frames (= MSE over the batch's
    sequences concatenated)."""
    m = _mask(ys, lengths)[..., None]
    return (((ys - labels) ** 2) * m).sum() \
        / (_count(ys, lengths, count_lengths) * ys.shape[-1])


def masked_distance(ys, labels, lengths, dim: int = 3, count_lengths=None):
    r"""Mean distance of ``dim``-D points over the valid frames."""
    T, B = ys.shape[:2]
    dist = torch.linalg.vector_norm((ys - labels).reshape(T, B, -1, dim),
                                    dim=-1)
    m = _mask(ys, lengths)[..., None]
    return (dist * m).sum() \
        / (_count(ys, lengths, count_lengths) * dist.shape[-1])


def velocity_horizon_loss(ys, labels, lengths, count_lengths=None):
    r"""Per-frame MSE plus the MSE of velocity sums over windows of 6, 20
    and 60 frames. A row's windows start at ``length % w``, so its first
    ``length % w`` frames are left out, like the reference's
    ``x[l % w:].view(-1, w, 3).sum(1)``."""
    T, B, D = ys.shape
    lengths = _lengths(ys, lengths)
    m2 = _mask(ys, lengths)
    total = masked_mse(ys, labels, lengths, count_lengths)
    count_lengths = _count_lengths(ys, lengths, count_lengths)
    zero = torch.zeros((1, B, D), dtype=ys.dtype, device=ys.device)
    cs_p = torch.cat([zero, torch.cumsum(ys * m2[..., None], 0)])
    cs_t = torch.cat([zero, torch.cumsum(labels * m2[..., None], 0)])

    def window_sums(cs, starts, ends):
        idx = lambda i: i[..., None].expand(-1, -1, D)  # noqa: E731
        return cs.gather(0, idx(ends)) - cs.gather(0, idx(starts))

    for w in (6, 20, 60):
        n_win = T // w + 1
        starts = (lengths % w)[None] + (torch.arange(
            n_win, device=ys.device) * w)[:, None]            # [n, B]
        ends = starts + w
        valid = (ends <= lengths[None]).to(ys.dtype)
        starts, ends = starts.clamp_max(T), ends.clamp_max(T)
        err = ((window_sums(cs_p, starts, ends)
                - window_sums(cs_t, starts, ends)) ** 2) * valid[..., None]
        # a row of length L has L // w whole windows
        n_valid = (count_lengths // w).sum().to(ys.dtype)
        total = total + err.sum() / torch.clamp_min(n_valid * D, 1.0)
    return total


def make_fk_pose_loss(body_model, fk_weight: float = 100.0):
    r"""r6d pose loss with a joint-position term through the light FK:
    ``mse(r6d) + fk_weight * mse(FK(r6d))``, FK being each joint's rotated
    bone summed along its ancestors, on ``body_model``'s device. Only the
    feature axis is reshaped, so the batch axis stays as it is."""
    dev = body_model.device
    parent = torch.as_tensor(body_model.tree.parent_clamped, device=dev)
    ancestor = torch.as_tensor(body_model.tree.ancestor_matrix,
                               dtype=torch.float32, device=dev)
    bone = body_model._bone_vector.to(dev, torch.float32)

    def fk(r6d):
        R = r6d_to_rotation_matrix_nd(r6d.reshape(r6d.shape[:-1] + (24, 6)))
        pb = torch.einsum("tbjrc,jc->tbjr", R.index_select(2, parent),
                          bone.to(r6d.dtype))
        pb = torch.cat([torch.zeros_like(pb[:, :, :1]), pb[:, :, 1:]], 2)
        return torch.einsum("ij,tbjk->tbik", ancestor.to(r6d.dtype), pb)

    def loss(ys, labels, lengths, count_lengths=None):
        m = _mask(ys, lengths)
        err = ((fk(ys) - fk(labels)) ** 2) * m[..., None, None]
        return masked_mse(ys, labels, lengths, count_lengths) \
            + fk_weight * err.sum() / (_count(ys, lengths, count_lengths)
                                       * 72)

    return loss


def masked_bce_pos_weight(pos_weight):
    r"""Binary cross-entropy with logits over the valid frames, positives
    weighted per class by ``pos_weight [D]``."""
    pw_host = torch.as_tensor(pos_weight, dtype=torch.float32)

    def loss(ys, labels, lengths, count_lengths=None):
        pw = pw_host.to(ys.device, ys.dtype, non_blocking=True)
        m = _mask(ys, lengths)[..., None]
        l = -(pw * labels * F.logsigmoid(ys) + (1 - labels) * F.logsigmoid(-ys))
        return (l * m).sum() \
            / (_count(ys, lengths, count_lengths) * ys.shape[-1])

    return loss
