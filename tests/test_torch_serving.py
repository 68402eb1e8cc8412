r"""The port's serving bundles (``robustcap_tpu_torch/serving.py``), the
serve kernel's operator ``robustcap::serve_scan`` and the CLI, against the
port's ``StreamingNet`` and the JAX package, mirroring
``tests/test_serving_bundle.py``.

Both packages get the same numpy frames and the same weights (JAX
``init_params`` at the small ``SPECS``, carried across with
``params_from_numpy``). Tolerances: the bundle's branchless step against
the port's ``StreamingNet`` 1e-5, as ``tests/test_torch_batched.py`` holds
the batched step against the single stream (the same values summed in
another order); against JAX 5e-4, as that file holds float32 against JAX
(XLA and PyTorch sum in other orders, compounded through the carried
states); the int8 bundle against JAX with the bounds that file uses for
the quantized modes; a chunk program against ``StreamingNet``'s serve path
bit for bit (the same operator on the same operands), against JAX's chunk
3e-4, the JAX test's bound. A bundle exported with ``pallas_tail`` (its
step program holds the tail operator ``robustcap::geometry_tail``) against
the JAX bundle exported with ``pallas_tail`` (its tail kernel in Pallas
interpret mode) 1e-5: both run the tail kernel's plain arithmetic on the
CPU over small widths, and differ by ~1e-6 over the stream.
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from robustcap_tpu import serving as jserving
from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu.nn import rnn as jrnn
from robustcap_tpu_torch.__main__ import main
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.nn import rnn as trnn
from robustcap_tpu_torch.ops import serve_scan as S
from robustcap_tpu_torch.ops.geometry_tail import tail_constants
from robustcap_tpu_torch.serving import (ServingBundle, _unbatch,
                                         export_serving_bundle)
from robustcap_tpu_torch.streaming import LiveServer
from test_torch_tail import (CPU, SMALL_SPECS, make_inputs, make_models,
                             make_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL_PORT = 1e-5
ATOL_JAX = 5e-4
ATOL_CHUNK_JAX = 3e-4
# occluded, mid-confidence and confident frames: the refeed, the lerp and
# the IMU updater all fire
CONF = [0.95, 0.2, 0.75, 0.1, 0.95, 0.72, 0.95, 0.3, 0.95, 0.95, 0.05]


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models(num_verts=300)
    jp, tp = make_params(3)
    return jm, tm, jp, tp


@pytest.fixture(scope="module")
def serve_bundle(world, tmp_path_factory):
    r"""A float32 bundle with a 5-frame serve-kernel chunk program."""
    _, tm, _, tp = world
    path = str(tmp_path_factory.mktemp("bundles") / "serve")
    manifest = export_serving_bundle(tp, tm, SigMPConfig(pallas_serve=True),
                                     path, chunk_len=5, device="cpu")
    return path, manifest, ServingBundle.load(path, device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol)


def test_export_writes_the_bundle(serve_bundle):
    path, manifest, bundle = serve_bundle
    assert sorted(os.listdir(path)) == ["chunk.pt2", "manifest.json",
                                        "prescan.pt2", "step.pt2",
                                        "weights.pt"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f) == json.loads(json.dumps(manifest))
    assert manifest["format_version"] == 1
    assert manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["chunk_mode"] == "pallas_serve"
    assert (manifest["chunk_len"], manifest["extra_chunk_lens"]) == (5, [])
    assert manifest["config"]["use_flat_floor"] is True
    assert bundle.cfg == SigMPConfig(pallas_serve=True)
    # the programs hold no example inputs (the weights would be among them)
    for name in ("step.pt2", "prescan.pt2", "chunk.pt2"):
        prog = torch.export.load(os.path.join(path, name))
        assert prog.example_inputs is None, name


def test_forward_online_matches_port_and_jax(world, serve_bundle):
    r"""The bundle's step against the port's ``StreamingNet`` and the JAX
    one, then after a reset with a ground-truth first translation."""
    jm, tm, jp, tp = world
    bundle = serve_bundle[2]
    j2, ac, orc = make_inputs(0, CONF[:6])
    for first_tran in (None, np.array([0.1, 0.0, 3.0], np.float32)):
        bundle.reset_states()
        net = tsig.StreamingNet(tp, tm, SigMPConfig(), device="cpu")
        jnet = jsig.StreamingNet(jp, jm, JaxConfig())
        for t in range(6):
            kw = (dict(first_frame=t == 0) if first_tran is None else
                  dict(first_tran=first_tran if t == 0 else None))
            got = bundle.forward_online(j2[t], ac[t], orc[t], **kw)
            assert tuple(got[0].shape) == (24, 3, 3)
            want = net.forward_online(j2[t], ac[t], orc[t], **kw)
            want_j = jnet.forward_online(j2[t], ac[t], orc[t], **kw)
            for g, w, wj in zip(got, want, want_j):
                _close(g, w, ATOL_PORT)
                _close(g, wj, ATOL_JAX)


def test_chunk_program_is_the_serve_path(world, serve_bundle):
    r"""Two 5-frame chunks: bit for bit the port's ``StreamingNet`` serve
    path from the same carry, and within the JAX test's bound of the JAX
    ``StreamingNet.forward_chunk``; a length without a program raises."""
    jm, tm, jp, tp = world
    bundle = serve_bundle[2]
    j2, ac, orc = make_inputs(1, CONF)
    bundle.reset_states()
    net = tsig.StreamingNet(tp, tm, SigMPConfig(pallas_serve=True),
                            device="cpu")
    jnet = jsig.StreamingNet(jp, jm, JaxConfig())
    first = bundle.forward_online(j2[0], ac[0], orc[0], first_frame=True)
    _close(first[1], jnet.forward_online(j2[0], ac[0], orc[0],
                                         first_frame=True)[1], ATOL_JAX)
    net.carry = _unbatch(bundle.carry)
    for sl in (slice(1, 6), slice(6, 11)):
        got = bundle.forward_chunk(j2[sl], ac[sl], orc[sl])
        want = net.forward_chunk(j2[sl], ac[sl], orc[sl])
        want_j = jnet.forward_chunk(j2[sl], ac[sl], orc[sl])
        for g, w, wj in zip(got, want, want_j):
            assert torch.equal(g, w)
            _close(g, wj, ATOL_CHUNK_JAX)
    with pytest.raises(ValueError, match="no chunk program for 3 frames"):
        bundle.forward_chunk(j2[:3], ac[:3], orc[:3])


@pytest.mark.parametrize("field,value,match", [
    ("format_version", 999, "format"),
    ("device", "cuda", "device type 'cuda'")])
def test_load_refuses_another_format_or_device(serve_bundle, tmp_path, field,
                                               value, match):
    path = str(tmp_path / "bundle")
    shutil.copytree(serve_bundle[0], path)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m[field] = value
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match=match):
        ServingBundle.load(path, device="cpu")


@pytest.fixture(scope="module")
def int8_bundle(world, tmp_path_factory):
    r"""An int8 bundle (``int8_compute``) with step-loop chunks of 4 and 8
    frames."""
    _, tm, _, tp = world
    tq = trnn.quantize_params(tp)
    cfg = SigMPConfig(int8_compute=True)
    path = str(tmp_path_factory.mktemp("bundles") / "int8")
    manifest = export_serving_bundle(tq, tm, cfg, path, chunk_len=4,
                                     extra_chunk_lens=(8,), device="cpu")
    return path, manifest, ServingBundle.load(path, device="cpu"), tq, cfg


def test_quantized_bundle(world, int8_bundle):
    r"""int8 records with ``int8_compute`` survive export and load: the
    port's int8 ``StreamingNet`` to 1e-5, and the JAX one within the
    quantized bounds."""
    jm, tm, jp, _ = world
    _, _, bundle, tq, cfg = int8_bundle
    assert bundle.cfg.int8_compute and trnn.is_quantized(bundle.params)
    bundle.reset_states()
    net = tsig.StreamingNet(tq, tm, cfg, device="cpu")
    jnet = jsig.StreamingNet(jrnn.quantize_params(jp), jm,
                             JaxConfig(int8_compute=True))
    j2, ac, orc = make_inputs(5, CONF[:5])
    for t in range(5):
        got = bundle.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
        want = net.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
        for g, w in zip(got, want):
            _close(g, w, ATOL_PORT)
        pose_j, tran_j = jnet.forward_online(j2[t], ac[t], orc[t],
                                             first_frame=t == 0)
        d = np.abs(_np(got[0]) - _np(pose_j))
        assert d.max() < 0.3 and d.mean() < 0.02
        assert np.abs(_np(got[1]) - _np(tran_j)).max() < 0.05


def test_step_loop_chunks(world, int8_bundle):
    r"""Without ``pallas_serve`` the chunk lengths run the step program
    frame by frame ("step_loop"), K=4 then K=8, as the port's
    ``StreamingNet.forward_chunk``; another length raises."""
    _, tm, _, _ = world
    path, manifest, bundle, tq, cfg = int8_bundle
    assert manifest["chunk_mode"] == "step_loop"
    assert (manifest["chunk_len"], manifest["extra_chunk_lens"]) == (4, [8])
    assert not any(f.startswith("chunk") for f in os.listdir(path))
    bundle.reset_states()
    net = tsig.StreamingNet(tq, tm, cfg, device="cpu")
    j2, ac, orc = make_inputs(2, (CONF + CONF)[:13])
    bundle.forward_online(j2[0], ac[0], orc[0], first_frame=True)
    net.forward_online(j2[0], ac[0], orc[0], first_frame=True)
    for sl in (slice(1, 5), slice(5, 13)):
        got = bundle.forward_chunk(j2[sl], ac[sl], orc[sl])
        want = net.forward_chunk(j2[sl], ac[sl], orc[sl])
        assert tuple(got[0].shape) == (sl.stop - sl.start, 24, 3, 3)
        for g, w in zip(got, want):
            _close(g, w, ATOL_PORT)
    with pytest.raises(ValueError, match="exported lengths: \\[4, 8\\]"):
        bundle.forward_chunk(j2[:6], ac[:6], orc[:6])


def test_weights_are_runtime_inputs(world, serve_bundle, tmp_path):
    r"""Bundle A's programs with bundle B's ``weights.pt`` (other weights of
    the same shapes) give B's ``StreamingNet``."""
    _, tm, _, _ = world
    pb = tsig.init_params(torch.Generator().manual_seed(9), SMALL_SPECS,
                          device="cpu")
    path = str(tmp_path / "swapped")
    shutil.copytree(serve_bundle[0], path)
    torch.save(pb, os.path.join(path, "weights.pt"))
    bundle = ServingBundle.load(path, device="cpu")
    ref = tsig.StreamingNet(pb, tm, SigMPConfig(), device="cpu")
    serve = tsig.StreamingNet(pb, tm, SigMPConfig(pallas_serve=True),
                              device="cpu")
    j2, ac, orc = make_inputs(6, CONF[:9])
    for t in range(4):
        got = bundle.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
        want = ref.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
        for g, w in zip(got, want):
            _close(g, w, ATOL_PORT)
    serve.carry = _unbatch(bundle.carry)
    got = bundle.forward_chunk(j2[4:9], ac[4:9], orc[4:9])
    want = serve.forward_chunk(j2[4:9], ac[4:9], orc[4:9])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("flag", ["pallas_inertial"])
def test_export_refuses_kernel_flags(world, tmp_path, flag):
    r"""No exported program runs the LSTM-scan chunk pre-scan: exporting
    with the flag raises rather than exporting a program that ignores
    it."""
    _, tm, _, tp = world
    with pytest.raises(ValueError, match=flag):
        export_serving_bundle(tp, tm, SigMPConfig(**{flag: True}),
                              str(tmp_path / "b"), device="cpu")
    assert not os.path.exists(tmp_path / "b")


def _op_case(world, mode):
    _, tm, _, tp = world
    p = trnn.quantize_params(tp) if mode == "int8" else tp
    cfg = SigMPConfig(int8_compute=mode == "int8")
    prepped = S.prepare_serve_params(p, int8_gates=mode == "int8")
    scan_p = tsig.prepare_scan_params(p, cfg.int8_compute)
    frames = tsig._sequence_frames(*make_inputs(7, [0.2, 0.95, 0.75]), None,
                                   True, None, CPU)
    carry = tsig.prescan_first_frame(scan_p, tm, tsig.init_carry(scan_p),
                                     tsig._frame_at(frames, 0), mode == "int8")
    return prepped, tail_constants(tm), cfg, frames, carry


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_serve_operator_opcheck(world, mode):
    r"""``torch.library.opcheck`` on ``robustcap::serve_scan`` at T=3: the
    schema (``timestamps`` the only argument written), the fake's shapes,
    types and strides against the CPU implementation, and tracing."""
    args = S._op_args(*_op_case(world, mode)) + (None,)
    result = torch.library.opcheck(S.serve_scan_op, args)
    assert set(result.values()) == {"SUCCESS"}, result


class _Ops(TorchDispatchMode):
    r"""Records the operators that run under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


def test_every_caller_reaches_the_operator(world, serve_bundle):
    r"""``forward_offline``, ``StreamingNet.forward_chunk`` and the
    bundle's chunk program reach the serve path through the operator, once
    a call; and what ``serve_scan`` returns is the operator's output."""
    _, tm, _, tp = world
    cfg = SigMPConfig(pallas_serve=True)
    j2, ac, orc = make_inputs(8, CONF[:5])
    net = tsig.StreamingNet(tp, tm, cfg, device="cpu")
    bundle = serve_bundle[2]
    bundle.reset_states()
    for call in (
            lambda: tsig.forward_offline(tp, tm, cfg, j2, ac, orc,
                                         first_frame=True, device="cpu"),
            lambda: net.forward_chunk(j2, ac, orc),
            lambda: bundle.forward_chunk(j2, ac, orc)):
        with _Ops() as ops:
            call()
        assert ops.names.count("robustcap::serve_scan") == 1
    case = _op_case(world, "f32")
    outs = torch.ops.robustcap.serve_scan(*S._op_args(*case), None)
    got = S.serve_scan(*case)
    for g, o in zip(got[:3], outs[:3]):
        assert torch.equal(g, o)
    assert got[3]["states"]["rnn4"][1] is not case[4]["states"]["rnn4"][1]
    assert torch.equal(got[3]["j_temp"], outs[-1])


def _op_calls(path, name):
    prog = torch.export.load(path)
    return sum(1 for n in prog.graph.nodes if n.op == "call_function"
               and f"robustcap.{name}" in str(n.target))


def test_step_programs_hold_the_cell_operator(serve_bundle, int8_bundle):
    r"""A float32 bundle's step program runs each LSTM layer of its eight
    stack evaluations (rnn2, rnn3, the speculative and the final rnn7/rnn8
    heads, rnn4, rnn6) as one ``robustcap::lstm_cell`` call, and its
    prescan program rnn4's and rnn6's; an int8 bundle's programs hold
    none (``nn.rnn.rnn_step``)."""
    path = serve_bundle[0]
    assert _op_calls(os.path.join(path, "step.pt2"), "lstm_cell") == 16
    assert _op_calls(os.path.join(path, "prescan.pt2"), "lstm_cell") == 4
    for name in ("step.pt2", "prescan.pt2"):
        assert _op_calls(os.path.join(int8_bundle[0], name),
                         "lstm_cell") == 0


def test_live_server_runs_on_bundle(serve_bundle):
    r"""The live engine takes a loaded bundle as its net."""
    engine = LiveServer(net=serve_bundle[2])
    rng = np.random.RandomState(2)
    uv = np.concatenate([rng.randn(33, 2) * 0.1,
                         np.full((33, 1), 0.95)], 1).astype(np.float32)
    ori = np.broadcast_to(np.eye(3, dtype=np.float32), (6, 3, 3)).copy()
    acc = rng.randn(6, 3).astype(np.float32)
    rcm = np.eye(3, dtype=np.float32)
    engine.reset()
    for t in range(3):
        pose_aa, tran = engine.process(uv, ori, acc, rcm)
        assert pose_aa.shape == (24, 3)
        assert np.all(np.isfinite(pose_aa)) and np.all(np.isfinite(tran))
        if t == 0:
            np.testing.assert_allclose(tran, 0.0, atol=1e-6)


def test_cli_export_latency_and_live_server(world, tmp_path, capsys,
                                           monkeypatch):
    r"""``main([...])`` in-process on the CPU: ``export`` from a JAX pickle
    of float32 arrays, ``latency`` (finite keys), ``live-server --bundle``
    (the exported bundle, loaded, reaches the server), and a bfloat16
    pickle refused with a clear message."""
    jp = world[2]
    pkl = str(tmp_path / "w.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.array, jp), f)
    out = str(tmp_path / "bundle")
    main(["export", "--weights", pkl, "--out", out, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out": out, "device": "cpu", "chunk_mode": None}

    main(["latency", "--weights", pkl, "--frames", "4", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == {"p50_ms", "p95_ms", "p99_ms", "mean_ms", "fps"}
    assert all(np.isfinite(v) and v > 0 for v in stats.values())

    import robustcap_tpu_torch.streaming as streaming
    seen = {}
    monkeypatch.setattr(streaming, "run_live_demo",
                        lambda **kw: seen.update(kw))
    main(["live-server", "--bundle", out, "--device", "cpu"])
    assert isinstance(seen["net"], ServingBundle)
    assert seen["net"].cfg == SigMPConfig()

    bf16 = str(tmp_path / "bf16.pkl")
    with open(bf16, "wb") as f:
        pickle.dump(jax.tree.map(np.array, jrnn.cast_params(
            jp, jax.numpy.bfloat16)), f)
    with pytest.raises(ValueError, match="ml_dtypes"):
        main(["export", "--weights", bf16, "--out", out + "2",
              "--device", "cpu"])


@pytest.fixture(scope="module")
def tail_bundles(world, tmp_path_factory):
    r"""Bundles exported with ``pallas_tail`` and 5-frame chunks: the port's
    (step-loop chunks) and the JAX package's (an XLA scan), loaded."""
    jm, tm, jp, tp = world
    root = tmp_path_factory.mktemp("bundles")
    path = str(root / "tail")
    export_serving_bundle(tp, tm, SigMPConfig(pallas_tail=True), path,
                          chunk_len=5, device="cpu")
    jserving.export_serving_bundle(jp, jm, JaxConfig(pallas_tail=True),
                                   str(root / "tail_jax"), chunk_len=5)
    return (path, ServingBundle.load(path, device="cpu"),
            jserving.ServingBundle.load(str(root / "tail_jax")))


def _tail_calls(path):
    prog = torch.export.load(path)
    return sum(1 for n in prog.graph.nodes if n.op == "call_function"
               and "robustcap.geometry_tail" in str(n.target))


def test_tail_bundle_matches_jax_bundle(tail_bundles, serve_bundle):
    r"""The step program holds the tail operator twice (the speculative and
    the final tail), the serve bundle's none; ``forward_online`` over six
    mixed-confidence frames from a first frame, then two 5-frame
    ``forward_chunk`` calls, each frame within 1e-5 of the JAX bundle's."""
    path, bundle, jbundle = tail_bundles
    assert bundle.manifest["chunk_mode"] == "step_loop"
    assert bundle.cfg.pallas_tail
    assert _tail_calls(os.path.join(path, "step.pt2")) == 2
    assert _tail_calls(os.path.join(serve_bundle[0], "step.pt2")) == 0
    j2, ac, orc = make_inputs(11, CONF + CONF[:5])
    bundle.reset_states()
    jbundle.reset_states()
    for t in range(6):
        got = bundle.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
        want = jbundle.forward_online(j2[t], ac[t], orc[t],
                                      first_frame=t == 0)
        for g, w in zip(got, want):
            _close(g, w, ATOL_PORT)
    for sl in (slice(6, 11), slice(11, 16)):
        got = bundle.forward_chunk(j2[sl], ac[sl], orc[sl])
        want = jbundle.forward_chunk(j2[sl], ac[sl], orc[sl])
        assert tuple(got[0].shape) == (5, 24, 3, 3)
        for g, w in zip(got, want):
            _close(g, w, ATOL_PORT)

