r"""Detector-failure frames through the port, mirroring
``tests/test_robustness.py``: when the detector finds nobody, the live
path's ``KeypointNormalizer`` sends all-zero keypoints at confidence 0
(and the offline preprocessing writes the same placeholders). The division
by a zero bounding-box scale must not poison the carried state or the
outputs: the confidence gate masks the visual branch. Checked on every
path that takes such frames: ``forward_offline`` (plain, tail kernel,
LSTM-scan pre-scan, serve kernel; on the CPU each wrapper runs its plain
version), ``StreamingNet.forward_online`` (plain, and with the tail
kernel as the live server runs it: there the kernel's own source,
``csrc/geometry_tail.cu``, runs on the CPU through the host build of
``tests/cuda_standin/``), ``forward_offline_batched``, and the per-frame
step's whole carry.
"""

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.math.angular import axis_angle_to_rotation_matrix
from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.ops import geometry_tail as G
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
from robustcap_tpu_torch.streaming.detector import KeypointNormalizer
from cuda_standin import standin
from test_torch_tail import SMALL_SPECS

T = 12
FAILED = slice(4, 8)


@pytest.fixture(scope="module")
def world():
    model = ParametricModel(data=synthetic_smpl_data(num_verts=300),
                            device="cpu")
    params = sig_mp.init_params(torch.Generator().manual_seed(0),
                                SMALL_SPECS, device="cpu")
    rng = np.random.RandomState(0)
    j2dc = np.concatenate([rng.randn(T, 33, 2) * 0.1,
                           np.full((T, 33, 1), 0.9)], 2).astype(np.float32)
    # frames 4..7: total detector failure, as the live normalizer sends it
    norm = KeypointNormalizer(np.eye(3), 640, 480)
    j2dc[FAILED] = norm(None)
    accc = rng.randn(T, 6, 3).astype(np.float32)
    aa = torch.from_numpy((rng.randn(T * 6, 3) * 0.2).astype(np.float32))
    oric = axis_angle_to_rotation_matrix(aa).reshape(T, 6, 3, 3).numpy()
    return model, params, (j2dc, accc, oric)


def _finite(*xs):
    return all(bool(torch.isfinite(torch.as_tensor(x)).all()) for x in xs)


@pytest.mark.parametrize("flag", [None, "pallas_tail", "pallas_inertial",
                                  "pallas_serve"])
def test_offline_stays_finite(world, flag):
    model, params, (j2dc, accc, oric) = world
    cfg = SigMPConfig(**({flag: True} if flag else {}))
    pose, tran = sig_mp.forward_offline(
        params, model, cfg, j2dc, accc, oric,
        first_tran=np.zeros(3, np.float32), device="cpu")
    assert tuple(pose.shape) == (T, 24, 3, 3)
    assert _finite(pose, tran)


@pytest.mark.parametrize("pallas_tail", [False, True])
def test_online_live_stays_finite(world, monkeypatch, tmp_path, pallas_tail):
    r"""With ``pallas_tail`` every frame's tail, the failed ones included,
    goes through ``geometry_tail._launch`` on the kernel's host build (on
    the CPU the wrapper itself would run its plain version), and the
    kernel's outputs are held against ``tail_plain`` on the same inputs."""
    model, params, (j2dc, accc, oric) = world
    cfg = SigMPConfig.live_mode()
    if pallas_tail:
        cfg = SigMPConfig(**{**cfg.__dict__, "pallas_tail": True})
        standin.use(monkeypatch, "geometry_tail",
                    standin.build("geometry_tail", tmp_path))
        gaps = []

        def kernel(*a):
            got, want = G._launch(*a), G.tail_plain(*a)
            gaps.append(max(float((got[k].double() - w.double()).abs().max())
                            for k, w in want.items()))
            return got
        monkeypatch.setattr(sig_mp, "geometry_tail", kernel)
        monkeypatch.setattr(G, "LAUNCHES", 0)
    net = sig_mp.StreamingNet(params, model, cfg, device="cpu")
    for t in range(T):
        pose, tran = net.forward_online(j2dc[t], accc[t], oric[t],
                                        first_frame=t == 0)
        assert _finite(pose, tran), t
    assert _finite(*[v for v in net.carry.values()
                     if isinstance(v, torch.Tensor)])
    if pallas_tail:
        # one launch a frame; the tail kernel's tolerance against its plain
        # version (tests/test_torch_tail_standin.py)
        assert G.LAUNCHES == T
        assert max(gaps) <= 1e-4, gaps


def test_batched_stays_finite(world):
    model, params, (j2dc, accc, oric) = world
    frames = {"j2dc": np.stack([j2dc, j2dc[::-1]]),
              "accc": np.stack([accc, accc]),
              "oric": np.stack([oric, oric]),
              "first_tran": np.zeros((2, T, 3), np.float32),
              "gravityc": np.zeros((2, T, 3), np.float32),
              "first_frame": np.zeros((2, T), bool),
              "first_tran_valid": np.zeros((2, T), bool)}
    frames["first_tran_valid"][:, 0] = True
    pose, tran = sig_mp.forward_offline_batched(params, model, SigMPConfig(),
                                                frames, device="cpu")
    assert tuple(pose.shape) == (2, T, 24, 3, 3)
    assert _finite(pose, tran)


def test_step_keeps_state_finite_through_failure(world):
    r"""Only failure frames, from a seeded translation: every leaf of the
    carry stays finite over three steps."""
    from robustcap_tpu_torch.nn.rnn import prepare_scan_params
    model, params, _ = world
    step = sig_mp.make_step(model, SigMPConfig())
    carry = sig_mp.init_carry(params)
    frame = sig_mp.make_frame(np.zeros((33, 3), np.float32),
                              np.zeros((6, 3), np.float32),
                              np.tile(np.eye(3, dtype=np.float32), (6, 1, 1)),
                              first_tran=np.array([0, 0, 3.0]), device="cpu")
    prepped = prepare_scan_params(params)
    for _ in range(3):
        carry, (pose, tran) = step(prepped, carry, frame)
        assert _finite(pose, tran)
    leaves = [v for v in carry.values() if isinstance(v, torch.Tensor)]
    assert leaves and all(bool(torch.isfinite(v.double()).all())
                          for v in leaves)
