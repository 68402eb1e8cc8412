r"""The port's rotation math, tree kinematics and SMPL body model against
the JAX package on the same numpy inputs.

Tolerance 1e-5 absolute: float32 math on unit-scale rotations and
positions, summed in another order by XLA and PyTorch. The procedural body
must match byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
import robustcap_tpu_torch.math as TM
from robustcap_tpu.config import MP_VERTEX_MASK as JAX_MP_MASK
from robustcap_tpu.smpl import ParametricModel as JaxModel
from robustcap_tpu.smpl import synthetic_smpl_data as jax_synthetic
from robustcap_tpu_torch import config as tconfig
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data

ATOL = 1e-5
SMPL_PARENT = [None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
               16, 17, 18, 19, 20, 21]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), atol=atol, rtol=0)


def _rotations(seed, n):
    rng = np.random.RandomState(seed)
    return np.array(JM.r6d_to_rotation_matrix(
        jnp.asarray(rng.randn(n, 6).astype(np.float32))))


def test_config_constants_match():
    from robustcap_tpu import config as jconfig
    for name in ("VEL_SCALE", "MP_VERTEX_MASK",
                 "IMU_JOINT_MASK", "SMPL_PARENT"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert (tconfig.SigMPConfig().__dict__
            == jconfig.SigMPConfig().__dict__)
    assert (tconfig.SigMPConfig.live_mode().__dict__
            == jconfig.SigMPConfig.live_mode().__dict__)
    assert set(tconfig.EVAL_PROFILES) == set(jconfig.EVAL_PROFILES)
    for k, prof in jconfig.EVAL_PROFILES.items():
        tprof = tconfig.EVAL_PROFILES[k]
        assert tprof["config"].__dict__ == prof["config"].__dict__
        assert {**tprof, "config": None} == {**prof, "config": None}


def test_r6d_and_axis_angle():
    rng = np.random.RandomState(0)
    r6d = rng.randn(64, 6).astype(np.float32)
    r6d[0, 3:] = r6d[0, :3] * 2.0        # degenerate second column
    _close(TM.r6d_to_rotation_matrix(torch.tensor(r6d)),
           JM.r6d_to_rotation_matrix(jnp.asarray(r6d)))
    aa = rng.randn(64, 3).astype(np.float32)
    aa[0] = 0.0                          # zero angle
    _close(TM.axis_angle_to_rotation_matrix(torch.tensor(aa)),
           JM.axis_angle_to_rotation_matrix(jnp.asarray(aa)))
    v = rng.randn(5, 3).astype(np.float32)
    _close(TM.normalize_tensor(torch.tensor(v), eps=1e-8),
           JM.normalize_tensor(jnp.asarray(v), eps=1e-8))
    _close(TM.lerp(torch.tensor(v), torch.tensor(2 * v), 0.3),
           JM.lerp(jnp.asarray(v), jnp.asarray(2 * v), 0.3))


def test_kinematic_tree():
    from robustcap_tpu.math.spatial import get_tree
    jt, tt = get_tree(SMPL_PARENT), TM.get_tree(SMPL_PARENT)
    assert jt.parent == tt.parent and jt.levels == tt.levels
    np.testing.assert_array_equal(jt.ancestor_matrix, tt.ancestor_matrix)
    np.testing.assert_array_equal(jt.parent_clamped, tt.parent_clamped)
    assert TM.get_tree(tt) is tt


def test_fk_ik_and_bones():
    R = _rotations(2, 3 * 24).reshape(3, 24, 3, 3)
    rng = np.random.RandomState(3)
    p = rng.randn(3, 24, 3).astype(np.float32)
    _close(TM.forward_kinematics_R(torch.tensor(R), SMPL_PARENT),
           JM.forward_kinematics_R(jnp.asarray(R), SMPL_PARENT))
    _close(TM.inverse_kinematics_R(torch.tensor(R), SMPL_PARENT),
           JM.inverse_kinematics_R(jnp.asarray(R), SMPL_PARENT))
    for a, b in zip(TM.forward_kinematics(torch.tensor(R), torch.tensor(p),
                                          SMPL_PARENT),
                    JM.forward_kinematics(jnp.asarray(R), jnp.asarray(p),
                                          SMPL_PARENT)):
        _close(a, b)
    _close(TM.bone_vector_to_joint_position(torch.tensor(p), SMPL_PARENT),
           JM.bone_vector_to_joint_position(jnp.asarray(p), SMPL_PARENT))
    _close(TM.joint_position_to_bone_vector(torch.tensor(p), SMPL_PARENT),
           JM.joint_position_to_bone_vector(jnp.asarray(p), SMPL_PARENT))
    _close(TM.mat3_mul(torch.tensor(R), torch.tensor(R)),
           JM.mat3_mul(jnp.asarray(R), jnp.asarray(R)))


@pytest.mark.parametrize("num_verts,seed", [(6890, 0), (500, 3)])
def test_synthetic_body_is_byte_identical(num_verts, seed):
    a = synthetic_smpl_data(num_verts=num_verts, seed=seed)
    b = jax_synthetic(num_verts=num_verts, seed=seed)
    for field in ("j_regressor", "skinning_weights", "posedirs", "shapedirs",
                  "v_template", "joints", "faces"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert x.tobytes() == y.tobytes(), field
    assert a.parent == b.parent


@pytest.mark.parametrize("num_verts,blendshape", [(6890, False),
                                                  (500, True)])
def test_forward_kinematics_mesh(num_verts, blendshape):
    jm = JaxModel(data=jax_synthetic(num_verts=num_verts),
                  use_pose_blendshape=blendshape)
    tm = ParametricModel(data=synthetic_smpl_data(num_verts=num_verts),
                         use_pose_blendshape=blendshape, device="cpu")
    for name in ("_bone_vector", "_zero_pose_joint", "_zero_pose_vertex"):
        _close(getattr(tm, name), getattr(jm, name), atol=0)
    pose = _rotations(4, 2 * 24).reshape(2, 24, 3, 3)
    tran = np.random.RandomState(5).randn(2, 3).astype(np.float32)
    # the MediaPipe landmark ids reach 6787: a 500-vertex body clips them
    ids = np.asarray(JAX_MP_MASK)
    want = jm.forward_kinematics(jnp.asarray(pose), tran=jnp.asarray(tran),
                                 calc_mesh=True, vertex_ids=ids)
    got = tm.forward_kinematics(torch.tensor(pose), tran=torch.tensor(tran),
                                calc_mesh=True, vertex_ids=ids)
    for a, b in zip(got, want):
        _close(a, b)
    want = jm.forward_kinematics(jnp.asarray(pose), calc_mesh=True)
    got = tm.forward_kinematics(torch.tensor(pose), calc_mesh=True)
    for a, b in zip(got, want):
        _close(a, b)


def test_shaped_body():
    jm = JaxModel(data=jax_synthetic(num_verts=500))
    tm = ParametricModel(data=synthetic_smpl_data(num_verts=500),
                         device="cpu")
    shape = np.random.RandomState(6).randn(2, 10).astype(np.float32)
    pose = _rotations(7, 2 * 24).reshape(2, 24, 3, 3)
    for a, b in zip(tm.get_zero_pose_joint_and_vertex(torch.tensor(shape)),
                    jm.get_zero_pose_joint_and_vertex(jnp.asarray(shape))):
        _close(a, b)
    for a, b in zip(tm.forward_kinematics(torch.tensor(pose),
                                          shape=torch.tensor(shape)),
                    jm.forward_kinematics(jnp.asarray(pose),
                                          shape=jnp.asarray(shape))):
        _close(a, b)
