r"""Per-RNN trainers of the SigMP fusion network (port of
``robustcap_tpu/train/trainers.py``).

Each trainer builds its feature datasets from AIST++- and/or AMASS-schema
dicts, keeps the reference's hyperparameters (chunks of 200 frames, batch
256, Adam, gradient clipping at 1, the module's dropout from ``RNN_SPECS``,
its learning rate, validation interval, plateau patience and augmentation
noise) and runs the generic ``train`` loop on ``device`` (keyword, default
the card). ``merge_weights`` gathers the six best checkpoints into the
parameter tree that ``forward_offline``, ``eval`` and ``export`` load.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import paths
from ..convert import params_from_numpy
from ..device import resolve_device
from ..models.sig_mp import RNN_SPECS
from ..nn.rnn import init_net_apply, init_rnn_params, rnn_forward_padded
from ..smpl.model import ParametricModel, default_body_model
from . import features as F
from .data import SeqDataset
from .loop import NumpyTreeUnpickler, load_pytree, save_pytree, train
from .losses import (make_fk_pose_loss, masked_bce_pos_weight,
                     masked_distance, masked_mse, velocity_horizon_loss)

__all__ = ["train_rnn2", "train_rnn3", "train_rnn4", "train_rnn6",
           "train_rnn7", "train_rnn8", "train_all", "merge_weights",
           "make_forward_fn"]


def make_forward_fn(dropout: float, with_init: bool = False):
    r"""Padded-batch forward of one module for ``train``: dropout when a
    generator is given (training), none without (validation); with
    ``with_init`` (RNNWithInit) the first label seeds (h0, c0)."""

    def forward(params, xs, lengths, init, generator):
        state0 = None
        if with_init and init is not None:
            state0 = init_net_apply(params, init)
        ys, _ = rnn_forward_padded(params, xs, lengths, state0,
                                   dropout=dropout, generator=generator)
        return ys

    return forward


def _noise_tail(sigma, tail):
    def aug(rng, x):
        out = x.copy()
        out[:, -tail:] = out[:, -tail:] + rng.normal(0, sigma,
                                                     out[:, -tail:].shape)
        return out.astype(np.float32)
    return aug


def _noise_all(sigma):
    def aug(rng, x):
        return (x + rng.normal(0, sigma, x.shape)).astype(np.float32)
    return aug


def _init_module(name, seed=0):
    r"""Random parameters of one module, on the CPU (``train`` moves
    them)."""
    i, o, h, _, with_init = RNN_SPECS[name]
    return init_rnn_params(torch.Generator().manual_seed(seed), i, o, h, 2,
                           with_init)


def _forward(name):
    return make_forward_fn(RNN_SPECS[name][3], with_init=RNN_SPECS[name][4])


def _concat(a, b):
    return ([*a[0], *b[0]], [*a[1], *b[1]])


def train_rnn2(aist_train: Dict, aist_val: Dict, amass_train: Dict = None,
               amass_val: Dict = None, save_dir: Optional[str] = None,
               num_epoch: int = 150, **kw):
    r"""Inertial pose branch: RNNWithInit, MSE loss, distance at
    validation."""
    save_dir = save_dir or os.path.join(paths.weight_dir, "sig_mp", "rnn2")
    d, l = F.rnn2_features(aist_train)
    if amass_train is not None:
        d, l = _concat((d, l), F.rnn2_features(amass_train))
    dv, lv = F.rnn2_features(aist_val)
    if amass_val is not None:
        dv, lv = _concat((dv, lv), F.rnn2_features(amass_val))
    return train(
        _init_module("rnn2"), _forward("rnn2"), masked_mse,
        SeqDataset(d, l, split_size=200, with_init=True),
        SeqDataset(dv, lv, with_init=True), save_dir,
        eval_fn=masked_distance, num_epoch=num_epoch,
        num_iter_between_vald=20, clip_grad_norm=1.0, **kw)


def train_rnn3(aist_train: Dict, aist_val: Dict, amass_train: Dict = None,
               amass_val: Dict = None, save_dir: Optional[str] = None,
               num_epoch: int = 200, **kw):
    r"""Inertial velocity branch: multi-horizon loss, sigma 0.04 noise on
    the joints."""
    save_dir = save_dir or os.path.join(paths.weight_dir, "sig_mp", "rnn3")
    d, l = F.rnn3_features(aist_train)
    if amass_train is not None:
        d, l = _concat((d, l), F.rnn3_features(amass_train))
    dv, lv = F.rnn3_features(aist_val)
    if amass_val is not None:
        dv, lv = _concat((dv, lv), F.rnn3_features(amass_val))
    return train(
        _init_module("rnn3"), _forward("rnn3"), velocity_horizon_loss,
        SeqDataset(d, l, split_size=200, augment_fn=_noise_tail(0.04, 69)),
        SeqDataset(dv, lv), save_dir, num_epoch=num_epoch,
        num_iter_between_vald=20, clip_grad_norm=1.0, **kw)


class _AmassCameraDataset(SeqDataset):
    r"""AMASS world-frame chunks with a fresh random camera, translation and
    keypoint confidence per chunk at each :meth:`resample`, drawn on
    ``device`` from a generator seeded with ``seed``."""

    def __init__(self, base, split_size, conf_pool, target, yaw, seed=0,
                 device="cuda"):
        super().__init__(base[0], base[1], split_size=split_size)
        self._base = (self.data, self.label)
        self.device = resolve_device(device)
        self.conf_pool = torch.as_tensor(conf_pool).to(self.device)
        self.target = target
        self.yaw = yaw
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)

    def resample(self):
        r"""Draw a fresh camera for every chunk (once per epoch)."""
        data, label = [], []
        for d, l in zip(*self._base):
            dd, ll = F.amass_camera_augment(
                self._generator, torch.from_numpy(d).to(self.device),
                torch.from_numpy(l).to(self.device), self.conf_pool,
                target=self.target, yaw=self.yaw)
            data.append(dd.cpu().numpy())
            label.append(ll.cpu().numpy())
        self.data, self.label = data, label


def _load_conf_pool():
    r"""The empirical keypoint-confidence pool (``paths.syn_conf_file``), or
    a beta(5, 1) fallback from ``RandomState(0)`` when it is absent."""
    if os.path.exists(paths.syn_conf_file):
        return np.asarray(torch.load(paths.syn_conf_file, map_location="cpu"),
                          np.float32)
    rng = np.random.RandomState(0)
    return np.clip(rng.beta(5, 1, 4096), 0, 1).astype(np.float32)


def _amass_dataset(amass_train, target, yaw, kw):
    am = _AmassCameraDataset(F.amass_mp_base(amass_train), 200,
                             _load_conf_pool(), target, yaw,
                             device=kw.get("device", "cuda"))
    am.resample()
    return am


def train_rnn4(aist_train: Dict, aist_val: Dict, amass_train: Dict = None,
               amass_val: Dict = None, save_dir: Optional[str] = None,
               num_epoch: int = 200, **kw):
    r"""Visual-inertial pose branch: lr 1e-4, the occluded keypoint
    variants, and the AMASS random-camera chunks redrawn each epoch."""
    save_dir = save_dir or os.path.join(paths.weight_dir, "sig_mp", "rnn4")
    d, l = F.rnn4_features_aist(aist_train)
    dv, lv = F.rnn4_features_aist(aist_val, include_occ=False)
    merged, hook = SeqDataset(d, l, split_size=200), None
    if amass_train is not None:
        am = _amass_dataset(amass_train, "rnn4", (-180.0, 180.0), kw)
        n_aist = len(merged.data)
        merged = SeqDataset([*merged.data, *am.data],
                            [*merged.label, *am.label])

        def hook(_epoch):
            am.resample()
            merged.data[n_aist:] = am.data
            merged.label[n_aist:] = am.label

    return train(
        _init_module("rnn4"), _forward("rnn4"), masked_mse,
        merged, SeqDataset(dv, lv), save_dir, eval_fn=masked_distance,
        learning_rate=1e-4, num_epoch=num_epoch, num_iter_between_vald=60,
        clip_grad_norm=1.0, epoch_hook=hook, **kw)


def train_rnn6(aist_train: Dict, aist_val: Dict, amass_train: Dict = None,
               amass_val: Dict = None, save_dir: Optional[str] = None,
               num_epoch: int = 100, **kw):
    r"""Visual translation branch: sigma 0.03 noise on the joints,
    ReduceLROnPlateau patience 5, the AMASS random-camera chunks redrawn
    each epoch."""
    save_dir = save_dir or os.path.join(paths.weight_dir, "sig_mp", "rnn6")
    d, l = F.rnn6_features_aist(aist_train)
    dv, lv = F.rnn6_features_aist(aist_val)
    hook = None
    if amass_train is not None:
        am = _amass_dataset(amass_train, "rnn6", (-90.0, 90.0), kw)
        d, l = [*d, *am.data], [*l, *am.label]
    ds = SeqDataset(d, l, split_size=200, augment_fn=_noise_tail(0.03, 69))
    if amass_train is not None:
        n_amass = len(am.data)

        def hook(_epoch):
            # the AMASS chunks are at most 200 frames, so they map one to
            # one onto the dataset's tail after the split
            am.resample()
            ds.data[-n_amass:] = am.data
            ds.label[-n_amass:] = am.label

    return train(
        _init_module("rnn6"), _forward("rnn6"), masked_mse,
        ds, SeqDataset(dv, lv), save_dir, num_epoch=num_epoch,
        num_iter_between_vald=60, clip_grad_norm=1.0,
        lr_scheduler_patience=5, epoch_hook=hook, **kw)


def train_rnn7(aist_train: Dict, aist_val: Dict, amass_train: Dict = None,
               amass_val: Dict = None, save_dir: Optional[str] = None,
               num_epoch: int = 120, body_model: ParametricModel = None,
               **kw):
    r"""Global-pose head: FK-weighted r6d loss, sigma 0.03 noise on the
    whole input, plateau patience 5."""
    save_dir = save_dir or os.path.join(paths.weight_dir, "sig_mp", "rnn7")
    body_model = body_model or default_body_model(kw.get("device", "cuda"))
    d, l = F.rnn7_features(aist_train, body_model)
    if amass_train is not None:
        d, l = _concat((d, l), F.rnn7_features(amass_train, body_model))
    dv, lv = F.rnn7_features(aist_val, body_model)
    return train(
        _init_module("rnn7"), _forward("rnn7"), make_fk_pose_loss(body_model),
        SeqDataset(d, l, split_size=200, augment_fn=_noise_all(0.03)),
        SeqDataset(dv, lv), save_dir, num_epoch=num_epoch,
        num_iter_between_vald=20, clip_grad_norm=1.0,
        lr_scheduler_patience=5, **kw)


def train_rnn8(amass_train: Dict, amass_val: Dict,
               save_dir: Optional[str] = None, num_epoch: int = 80, **kw):
    r"""Foot-contact head: AMASS only, BCE with positives weighted by the
    negative/positive ratio per foot, plateau patience 10."""
    save_dir = save_dir or os.path.join(paths.weight_dir, "sig_mp", "rnn8")
    d, l = F.rnn8_features(amass_train)
    dv, lv = F.rnn8_features(amass_val)
    all_labels = np.concatenate(l)
    pos_weight = ((1 - all_labels).sum(0) /
                  np.maximum(all_labels.sum(0), 1.0))
    return train(
        _init_module("rnn8"), _forward("rnn8"),
        masked_bce_pos_weight(pos_weight),
        SeqDataset(d, l, split_size=200, augment_fn=_noise_tail(0.03, 69)),
        SeqDataset(dv, lv), save_dir, num_epoch=num_epoch,
        num_iter_between_vald=20, clip_grad_norm=1.0,
        lr_scheduler_patience=10, **kw)


def merge_weights(weight_dir: Optional[str] = None, out_file: str = None,
                  device="cuda"):
    r"""The six modules' ``best_weights.pkl`` merged into one parameter tree,
    saved to ``out_file`` (``weight_dir/best_weights.pkl`` by default) and
    returned on ``device``."""
    weight_dir = weight_dir or os.path.join(paths.weight_dir, "sig_mp")
    params = {}
    for name in RNN_SPECS:
        with open(os.path.join(weight_dir, name, "best_weights.pkl"),
                  "rb") as f:
            params[name] = NumpyTreeUnpickler(f).load()
    save_pytree(params, out_file or os.path.join(weight_dir,
                                                  "best_weights.pkl"))
    return params_from_numpy(params, device)


def train_all(aist_train, aist_val, amass_train, amass_val, **kw):
    r"""Train the six modules, then merge their best weights. With a
    ``mesh`` rank 0 writes the merged file and every rank reads it after a
    barrier."""
    train_rnn2(aist_train, aist_val, amass_train, amass_val, **kw)
    train_rnn3(aist_train, aist_val, amass_train, amass_val, **kw)
    train_rnn4(aist_train, aist_val, amass_train, amass_val, **kw)
    train_rnn6(aist_train, aist_val, amass_train, amass_val, **kw)
    train_rnn7(aist_train, aist_val, amass_train, amass_val, **kw)
    train_rnn8(amass_train, amass_val, **kw)
    mesh = kw.get("mesh")
    if mesh is None:
        return merge_weights(device=kw.get("device", "cuda"))
    if mesh.rank == 0:
        merge_weights(device="cpu")
    mesh.barrier()
    return load_pytree(os.path.join(paths.weight_dir, "sig_mp",
                                    "best_weights.pkl"), mesh.device)
