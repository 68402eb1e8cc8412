r"""The port's weight kinds (``nn/rnn.py``: bf16 casts, int8 records, the
``int8_compute`` gate products) against the JAX package's, mirroring
``tests/test_quantization.py``.

Both sides get the same numpy inputs and the same weights (JAX
``init_params``/``init_rnn_params``, carried across with
``params_from_numpy``, which keeps bf16 and int8 leaves). The quantizers are
held bit for bit against JAX. Steps and scans compute in bf16 on both sides,
where XLA and PyTorch round at slightly different places; they are held
with the relative bounds ``tests/test_quantization.py`` states for the
quantized path against float32, and against the float32 path with those
same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu.nn import rnn as jrnn
from robustcap_tpu_torch.convert import params_from_numpy
from robustcap_tpu_torch.nn import rnn as trnn
from test_torch_tail import CPU, assert_tree_close

jax.config.update("jax_default_matmul_precision", "highest")


def _np(x):
    return np.asarray(x, np.float32)


def _params(key=0, in_size=72, out_size=69, hidden=128, with_init=False):
    jp = jrnn.init_rnn_params(jax.random.PRNGKey(key), in_size, out_size,
                              hidden, with_init_net=with_init)
    return jp, params_from_numpy(jax.tree.map(np.array, jp), CPU)


def _carry(jp):
    return params_from_numpy(jax.tree.map(np.array, jp), CPU)


def _rel_mean(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_bitwise(jax_tree, port_tree):
    r"""Same leaves in the same order, same dtypes, same bits."""
    j, t = list(_leaves(jax_tree)), list(_leaves(port_tree))
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.astype(np.float32))
        else:
            assert b.numpy().dtype == a.dtype
            np.testing.assert_array_equal(b.numpy(), a)


class TestQuantizeTensor:
    def test_round_trip_error_bound(self):
        w = jax.random.normal(jax.random.PRNGKey(1), (64, 48)) * 0.3
        q = trnn.quantize_tensor(torch.tensor(np.array(w)))
        assert q["q"].dtype == torch.int8
        assert tuple(q["scale"].shape) == (64, 1)
        _assert_bitwise(jrnn.quantize_tensor(w), q)
        back = trnn.dequantize_tensor(q).numpy()
        row_max = np.abs(np.asarray(w)).max(axis=1, keepdims=True)
        assert np.all(np.abs(back - np.asarray(w)) <= row_max / 254 + 1e-7)

    @pytest.mark.parametrize("case", ["extreme_rows", "zero_row",
                                      "half_ties", "bf16_weights"])
    def test_matches_jax_bit_for_bit(self, case):
        if case == "extreme_rows":
            w = jnp.concatenate([jnp.ones((1, 8)) * 100.0,
                                 jnp.ones((1, 8)) * 1e-3], axis=0)
        elif case == "zero_row":
            w = jnp.zeros((3, 5))
        elif case == "half_ties":
            # entries at exact half steps of the scale: ties go to even
            w = jnp.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]])
        else:
            w = (jax.random.normal(jax.random.PRNGKey(2), (16, 24))
                 ).astype(jnp.bfloat16)
        want = jrnn.quantize_tensor(w)
        got = trnn.quantize_tensor(_carry(w))
        _assert_bitwise(want, got)
        for dtype, tdtype in ((jnp.float32, torch.float32),
                              (jnp.bfloat16, torch.bfloat16)):
            _assert_bitwise(jrnn.dequantize_tensor(want, dtype),
                            trnn.dequantize_tensor(got, tdtype))
        if case == "extreme_rows":
            back = trnn.dequantize_tensor(got).numpy()
            assert np.allclose(back[0], 100.0, rtol=1e-2)
            assert np.allclose(back[1], 1e-3, rtol=1e-2)
        if case == "zero_row":
            assert np.all(got["q"].numpy() == 0)
            assert np.all(np.isfinite(trnn.dequantize_tensor(got).numpy()))


class TestQuantizeParams:
    def test_structure_and_footprint(self):
        jp, tp = _params(with_init=True)
        qp = trnn.quantize_params(tp)
        assert trnn.is_quantized(qp)
        assert not trnn.is_quantized(tp)
        assert qp["layers"][0]["b_ih"].dtype == torch.float32

        def nbytes(t):
            return sum(x.numel() * x.element_size() for x in _leaves(t))
        assert nbytes(qp) < 0.3 * nbytes(tp)
        _assert_bitwise(jrnn.quantize_params(jp), qp)

    def test_idempotent(self):
        _, tp = _params()
        qp = trnn.quantize_params(tp)
        qp2 = trnn.quantize_params(qp)
        assert qp2["linear1"]["w"]["q"] is qp["linear1"]["w"]["q"]
        _assert_bitwise(qp, qp2)

    def test_cast_params(self):
        jp, tp = _params()
        qp = trnn.quantize_params(tp)
        assert trnn.cast_params(qp, torch.bfloat16) is qp
        _assert_bitwise(jrnn.cast_params(jp, jnp.bfloat16),
                        trnn.cast_params(tp, torch.bfloat16))

    def test_works_on_module_bank(self):
        jb = {"rnn2": _params(0, with_init=True)[0], "rnn7": _params(1)[0]}
        qb = trnn.quantize_params(_carry(jb))
        assert trnn.is_quantized(qb)
        assert qb["rnn2"]["init_net"][0]["w"]["q"].dtype == torch.int8
        _assert_bitwise(jrnn.quantize_params(jb), qb)

    def test_dequantize_params_dense_and_noop(self):
        jp, tp = _params()
        qp = trnn.quantize_params(tp)
        dq = trnn.dequantize_params(qp)
        assert not trnn.is_quantized(dq)
        assert dq["linear1"]["w"].dtype == torch.bfloat16
        assert trnn.dequantize_params(tp) is tp
        _assert_bitwise(jrnn.dequantize_params(jrnn.quantize_params(jp)), dq)

    @pytest.mark.parametrize("kind", ["bf16", "int8"])
    def test_params_from_numpy_keeps_leaf_kinds(self, kind):
        r"""A bf16 tree and an int8 tree carried across from JAX keep every
        leaf's dtype and bits: bf16 stays bf16, the int8 payload stays int8
        and its record a record."""
        jp, _ = _params(with_init=True)
        jt = (jrnn.cast_params(jp, jnp.bfloat16) if kind == "bf16"
              else jrnn.quantize_params(jp))
        tt = _carry(jt)
        _assert_bitwise(jt, tt)
        if kind == "int8":
            assert trnn.is_quantized(tt)
            assert set(tt["layers"][0]["w_ih"]) == {"q", "scale"}


class TestQuantizedForward:
    @pytest.mark.parametrize("kind", ["int8", "bf16"])
    def test_step_close_to_f32(self, kind):
        jp, tp = _params()
        if kind == "int8":
            jq, tq = jrnn.quantize_params(jp), trnn.quantize_params(tp)
        else:
            jq = jrnn.cast_params(jp, jnp.bfloat16)
            tq = trnn.cast_params(tp, torch.bfloat16)
        x = np.array(jax.random.normal(jax.random.PRNGKey(2), (4, 72)))
        y_ref, _ = trnn.rnn_step(tp, torch.tensor(x),
                                 trnn.init_state(tp, (4,)))
        y_q, (h_q, c_q) = trnn.rnn_step(tq, torch.tensor(x),
                                        trnn.init_state(tq, (4,)))
        y_j, (h_j, c_j) = jrnn.rnn_step(jq, jnp.asarray(x),
                                        jrnn.init_state(jq, (4,)))
        assert y_q.dtype == torch.float32 and h_q.dtype == torch.float32
        assert _rel_mean(y_q, y_ref) < 0.05
        a, b = y_q.numpy().ravel(), y_ref.numpy().ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.995
        for want, got in ((y_j, y_q), (h_j, h_q), (c_j, c_q)):
            assert _rel_mean(got, want) < 0.05

    def test_scan_stays_close_over_time(self):
        jp, tp = _params(hidden=96)
        jq, tq = jrnn.quantize_params(jp), trnn.quantize_params(tp)
        xs = np.array(jax.random.normal(jax.random.PRNGKey(3),
                                        (50, 2, 72))) * 0.5
        ys_ref, _ = trnn.rnn_scan(tp, torch.tensor(xs))
        ys_q, _ = trnn.rnn_scan(tq, torch.tensor(xs))
        ys_j, _ = jrnn.rnn_scan(jq, jnp.asarray(xs))
        for want in (ys_ref, ys_j):
            assert _rel_mean(ys_q, want) < 0.08
            assert _rel_mean(ys_q[-5:], _np(want)[-5:]) < 0.12

    def test_init_net_apply_quantized(self):
        jp, tp = _params(with_init=True)
        jq, tq = jrnn.quantize_params(jp), trnn.quantize_params(tp)
        lbl = np.array(jax.random.normal(jax.random.PRNGKey(4), (3, 69)))
        h, c = trnn.init_net_apply(tp, torch.tensor(lbl))
        hq, cq = trnn.init_net_apply(tq, torch.tensor(lbl))
        hj, cj = jrnn.init_net_apply(jq, jnp.asarray(lbl))
        assert hq.shape == h.shape and cq.shape == c.shape
        assert _rel_mean(hq, h) < 0.08
        # the label is float32, so the dequantized weights run in float32
        # on both sides: the same values up to the order of the sums
        assert_tree_close((hj, cj), (hq, cq), 1e-5)


class TestInt8Compute:
    def test_quantize_activation_matches_jax(self):
        x = jax.random.normal(jax.random.PRNGKey(3), (5, 97)) * \
            jnp.asarray([0.01, 1.0, 100.0, 1e-6, 3.0])[:, None]
        for dtype in (jnp.float32, jnp.bfloat16):
            xj = x.astype(dtype)
            q, s = trnn.quantize_activation(_carry(xj))
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            _assert_bitwise(jrnn.quantize_activation(xj), (q, s))
        back = q.float() * s
        row_max = np.abs(_np(x.astype(jnp.bfloat16))).max(axis=1,
                                                           keepdims=True)
        assert np.all(np.abs(back.numpy() - _np(x.astype(jnp.bfloat16)))
                      <= row_max / 254 + 1e-9)

    def test_int8_products_are_exact(self):
        r"""127 * 127 * 1280 > 2^24: the plain int8 product must not go
        through float32."""
        xq = torch.full((1, 1280), 127, dtype=torch.int8)
        wq = torch.full((3, 1280), 127, dtype=torch.int8)
        wq[1] = -127
        z = trnn._dot_i8(xq, wq)
        assert z.dtype == torch.int32
        assert z.tolist() == [[127 * 127 * 1280, -127 * 127 * 1280,
                               127 * 127 * 1280]]

    def test_scan_close_to_f32(self):
        jp, tp = _params(hidden=96)
        jq, tq = jrnn.quantize_params(jp), trnn.quantize_params(tp)
        xs = np.array(jax.random.normal(jax.random.PRNGKey(5), (48, 4, 72)))
        y_f, _ = trnn.rnn_scan(tp, torch.tensor(xs))
        y_q, _ = trnn.rnn_scan(tq, torch.tensor(xs), int8_compute=True)
        y_j, _ = jrnn.rnn_scan(jq, jnp.asarray(xs), int8_compute=True)
        for want in (y_f, y_j):
            err = np.abs(y_q.numpy() - _np(want))
            scale = np.abs(_np(want)).max()
            assert err.max() / scale < 0.05
            assert err.mean() / scale < 0.01

    def test_group_and_pair_step(self):
        r"""``rnn_group_step``/``rnn_pair_step`` with ``int8_compute``: the
        values of separate ``rnn_step`` calls (``tests/test_nn_rnn.py``'s
        ``test_int8_compute_path``), and JAX's pair step within the
        quantized step's bound."""
        keys = jax.random.split(jax.random.PRNGKey(3), 3)
        jps = [jrnn.dequantize_non_gate_params(jrnn.quantize_params(
            jrnn.init_rnn_params(k, 14, out, 16, 2))) for k, out in
            zip(keys, (9, 2, 3))]
        tps = [_carry(p) for p in jps]
        x = np.array(jax.random.normal(jax.random.PRNGKey(4), (14,)))
        sts = [trnn.init_state(p) for p in tps]
        want = [trnn.rnn_step(p, torch.tensor(x), s, int8_compute=True)
                for p, s in zip(tps, sts)]
        outs, news = trnn.rnn_group_step(tps, torch.tensor(x), sts,
                                         int8_compute=True)
        assert_tree_close((tuple(w[0] for w in want),
                           tuple(w[1] for w in want)), (outs, news), 0.0)
        oa, ob, na, nb = trnn.rnn_pair_step(tps[0], tps[1], torch.tensor(x),
                                            sts[0], sts[1], int8_compute=True)
        assert_tree_close((want[0][0], want[1][0], want[0][1], want[1][1]),
                          (oa, ob, na, nb), 0.0)
        ja, jb, _, _ = jrnn.rnn_pair_step(
            jps[0], jps[1], jnp.asarray(x), jrnn.init_state(jps[0]),
            jrnn.init_state(jps[1]), int8_compute=True)
        assert _rel_mean(oa, ja) < 0.05 and _rel_mean(ob, jb) < 0.05

    def test_requires_quantized_weights_noop_otherwise(self):
        _, tp = _params(hidden=32)
        xs = torch.tensor(np.array(jax.random.normal(jax.random.PRNGKey(6),
                                                     (4, 2, 72))))
        y_a, _ = trnn.rnn_scan(tp, xs)
        y_b, _ = trnn.rnn_scan(tp, xs, int8_compute=True)
        np.testing.assert_array_equal(y_a.numpy(), y_b.numpy())

    def test_dequantize_non_gate_params_scope(self):
        jp, tp = _params(hidden=32, with_init=True)
        qp = trnn.quantize_params(tp)
        out = trnn.dequantize_non_gate_params(qp)
        assert trnn._is_qtensor(out["layers"][0]["w_ih"])
        assert trnn._is_qtensor(out["layers"][1]["w_hh"])
        assert not trnn._is_qtensor(out["linear1"]["w"])
        assert not trnn._is_qtensor(out["linear2"]["w"])
        assert not trnn._is_qtensor(out["init_net"][0]["w"])
        _assert_bitwise(
            jrnn.dequantize_non_gate_params(jrnn.quantize_params(jp)), out)
        assert trnn.prepare_scan_params(qp, True)["layers"][0]["w_ih"] \
            is qp["layers"][0]["w_ih"]


# ---------------------------------------------------------------------------
# The fusion network on quantized and bf16 banks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fusion():
    from robustcap_tpu.models import sig_mp as jsig
    from test_torch_tail import make_models, make_params
    import robustcap_tpu.math as M
    jm, tm = make_models(num_verts=300)
    specs = {k: (i, o, 48, d, w)
             for k, (i, o, _, d, w) in jsig.RNN_SPECS.items()}
    jp, tp = make_params(0, specs)
    T = 40
    rng = np.random.RandomState(0)
    j2dc = (rng.randn(T, 33, 3) * 0.1).astype(np.float32)
    j2dc[..., 2] = np.clip(rng.uniform(0.3, 1.0, (T, 1)), 0, 1)
    accc = rng.randn(T, 6, 3).astype(np.float32)
    aa = (rng.randn(T * 6, 3) * 0.2).astype(np.float32)
    oric = np.array(M.axis_angle_to_rotation_matrix(jnp.asarray(aa))
                    ).reshape(T, 6, 3, 3).astype(np.float32)
    return jm, tm, jp, tp, (j2dc, accc, oric)


def _offline(fusion, kind, int8_compute):
    from robustcap_tpu.config import SigMPConfig as JaxConfig
    from robustcap_tpu.models import sig_mp as jsig
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.models import sig_mp as tsig
    jm, tm, jp, tp, seq = fusion
    if kind == "int8":
        jp, tp = jrnn.quantize_params(jp), trnn.quantize_params(tp)
    elif kind == "bf16":
        jp = jrnn.cast_params(jp, jnp.bfloat16)
        tp = trnn.cast_params(tp, torch.bfloat16)
    want = jsig.forward_offline(jp, jm, JaxConfig(int8_compute=int8_compute),
                                *seq, first_frame=True)
    got = tsig.forward_offline(tp, tm, SigMPConfig(int8_compute=int8_compute),
                               *seq, first_frame=True, device="cpu")
    return tuple(_np(x) for x in want), tuple(x.numpy() for x in got)


class TestQuantizedFusionNet:
    @pytest.mark.parametrize("kind,int8_compute", [("int8", False),
                                                   ("int8", True),
                                                   ("bf16", False)])
    def test_trajectory_deviation_bounded(self, fusion, kind, int8_compute):
        r"""``forward_offline`` on a quantized (weight-only or
        ``int8_compute``) or bf16 bank: within the JAX test's bounds of the
        float32 trajectory, and of the JAX package's own run of the same
        mode."""
        (pose_jf, tran_jf), (pose_f, tran_f) = _offline(fusion, "f32", False)
        (pose_j, tran_j), (pose_q, tran_q) = _offline(fusion, kind,
                                                      int8_compute)
        assert np.abs(pose_f - pose_jf).max() < 2e-4
        for pose, tran in ((pose_f, tran_f), (pose_j, tran_j)):
            assert np.abs(pose_q - pose).max() < 0.3
            assert np.abs(pose_q - pose).mean() < 0.02
            assert np.abs(tran_q - tran).max() < 0.05
        rtr = np.einsum("tjab,tjac->tjbc", pose_q, pose_q)
        assert np.abs(rtr - np.eye(3)).max() < 0.02

    def test_streaming_net_accepts_quantized(self, fusion):
        from robustcap_tpu_torch.config import SigMPConfig
        from robustcap_tpu_torch.models import sig_mp as tsig
        _, tm, _, tp, (j2dc, accc, oric) = fusion
        for cfg in (SigMPConfig(), SigMPConfig(int8_compute=True),
                    SigMPConfig(pallas_inertial=True)):
            net = tsig.StreamingNet(trnn.quantize_params(tp), tm, cfg,
                                    device="cpu")
            pose, tran = net.forward_online(
                j2dc[0], accc[0], oric[0],
                first_tran=np.zeros(3, np.float32))
            assert tuple(pose.shape) == (24, 3, 3)
            assert bool(torch.isfinite(pose).all())
            assert bool(torch.isfinite(tran).all())
            pose, tran = net.forward_chunk(j2dc[1:5], accc[1:5], oric[1:5])
            assert tuple(pose.shape) == (4, 24, 3, 3)
            assert bool(torch.isfinite(pose).all())
