r"""The port's rigid-body dynamics (``dynamics/``, ``torch.func``) against the
JAX package's (``jax.grad``/``jax.hessian``), on the CPU.

Mirrors ``tests/test_dynamics.py`` on the same 200-vertex body, then holds
every quantity against JAX at a seeded state (q, qdot, qddot from N(0, 0.1)):
the mass matrix, the bias force, inverse dynamics, a point Jacobian, the CoM
and the ZMP within 1e-5 of each quantity's largest magnitude (float32 FK in
another summation order, through up to second derivatives). Forward
dynamics solves with M + 1e-6 I, whose condition number is about 1.2e5 in
float32: at JAX's inverse dynamics of the state (so that qddot comes back,
|qddot| up to ~0.25) it is held against JAX within 2e-2 absolute (the JAX
test's own consistency bound is 5e-2) and by its residual within 1e-4 of
|tau - h|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu.dynamics import RigidBodyDynamics as JDynamics
from robustcap_tpu.smpl import ParametricModel as JModel
from robustcap_tpu.smpl import synthetic_smpl_data
from robustcap_tpu_torch.dynamics import RigidBodyDynamics
from robustcap_tpu_torch.smpl import ParametricModel

REL = 1e-5
FD_ATOL = 2e-2
RESIDUAL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    r"""Torch's CPU ops on one thread: the transforms run many small ops,
    which stall in OpenMP regions when the test run oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic_smpl_data(num_verts=200)


@pytest.fixture(scope="module")
def dyn(data):
    return RigidBodyDynamics(ParametricModel(data=data, device="cpu"),
                             total_mass=70.0)


def _state(n, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(0, 0.1, n).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def jax_ref(data):
    r"""Every JAX quantity at the seeded state, computed once (the JAX side
    jits each function)."""
    jd = JDynamics(JModel(data=data), total_mass=70.0)
    q, qd, qdd = (jnp.asarray(x) for x in _state(jd.num_q))
    tau = jd.inverse_dynamics(q, qd, qdd)
    out = {"M": jd.mass_matrix(q), "h": jd.bias_force(q, qd), "id": tau,
           "fd": jd.forward_dynamics(q, qd, tau),
           "J": jd.point_jacobian(q, 18), "com": jd.com(q),
           "zmp": jd.zmp(q, qd, qdd, 0.05), "tau": tau,
           "mass": jd.mass, "bone_len": jd.bone_len}
    return {k: np.array(v) for k, v in out.items()}


class TestDynamics:
    def test_mass_matrix_spd(self, dyn):
        Mm = dyn.mass_matrix(torch.zeros(dyn.num_q)).numpy()
        np.testing.assert_allclose(Mm, Mm.T, atol=1e-4)
        np.testing.assert_allclose(Mm[:3, :3], 70.0 * np.eye(3), atol=1e-3)
        eig = np.linalg.eigvalsh(Mm + 1e-6 * np.eye(dyn.num_q))
        assert eig.min() > 0

    def test_free_fall(self, dyn):
        zero = torch.zeros(dyn.num_q)
        qddot = dyn.forward_dynamics(zero, zero, zero)
        assert abs(float(qddot[1]) + 9.81) < 0.5

    def test_inverse_forward_consistency(self, dyn):
        q, qdot, qddot = _state(dyn.num_q)
        tau = dyn.inverse_dynamics(q, qdot, qddot)
        np.testing.assert_allclose(dyn.forward_dynamics(q, qdot, tau),
                                   qddot, atol=5e-2)

    def test_com_and_jacobian(self, dyn):
        q = np.zeros(dyn.num_q, np.float32)
        assert torch.isfinite(dyn.com(q)).all()
        J = dyn.point_jacobian(q, 0).numpy()
        assert J.shape == (3, dyn.num_q)
        np.testing.assert_allclose(J[:, :3], np.eye(3), atol=1e-5)

    def test_zmp_static(self, dyn):
        zero = torch.zeros(dyn.num_q)
        zmp = dyn.zmp(zero, zero, zero).numpy()
        np.testing.assert_allclose(zmp[[0, 2]], dyn.com(zero)[[0, 2]],
                                   atol=1e-4)

    def test_matches_jax(self, dyn, jax_ref):
        q, qd, qdd = _state(dyn.num_q)
        tau = jax_ref["tau"]
        for name, want in (("mass", jax_ref["mass"]),
                           ("bone_len", jax_ref["bone_len"])):
            np.testing.assert_array_equal(getattr(dyn, name).numpy(), want)
        got = {"M": dyn.mass_matrix(q), "h": dyn.bias_force(q, qd),
               "id": dyn.inverse_dynamics(q, qd, qdd),
               "J": dyn.point_jacobian(q, 18), "com": dyn.com(q),
               "zmp": dyn.zmp(q, qd, qdd, 0.05)}
        for k, v in got.items():
            want = jax_ref[k]
            assert v.dtype == torch.float32 and v.shape == want.shape, k
            np.testing.assert_allclose(v.numpy(), want,
                                       atol=REL * np.abs(want).max(),
                                       err_msg=k)
        fd = dyn.forward_dynamics(q, qd, tau)
        np.testing.assert_allclose(fd.numpy(), jax_ref["fd"], atol=FD_ATOL)
        Mm = got["M"].double() + 1e-6 * torch.eye(dyn.num_q,
                                                  dtype=torch.float64)
        rhs = torch.from_numpy(tau).double() - got["h"].double()
        assert float((Mm @ fd.double() - rhs).norm()) <= \
            RESIDUAL * float(rhs.norm())

    def test_float64_and_zero_angle(self, data):
        r"""On a float64 body every quantity is float64 and agrees with the
        float32 one; at q = 0 (the ``+1e-16`` under the Rodrigues square
        root) gradients through the bias force stay finite."""
        d64 = RigidBodyDynamics(ParametricModel(data=data, device="cpu",
                                                dtype=torch.float64))
        d32 = RigidBodyDynamics(ParametricModel(data=data, device="cpu"))
        q, qd, _ = _state(d64.num_q, seed=3)
        M64, M32 = d64.mass_matrix(q), d32.mass_matrix(q)
        assert M64.dtype == d64.gravity.dtype == torch.float64
        np.testing.assert_allclose(M32.numpy(), M64.numpy(),
                                   atol=REL * float(M64.abs().max()))
        g = torch.func.grad(lambda x: d64.bias_force(x, qd).square().sum())(
            torch.zeros(d64.num_q, dtype=torch.float64))
        assert torch.isfinite(g).all() and g.abs().max() > 0
