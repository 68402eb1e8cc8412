r"""The port stands alone: it imports neither ``jax`` nor the JAX package,
not even while it runs its bf16/int8 paths; its entry points default to the
card and refuse to fall back to the CPU; and what a path does not take
raises instead of running another path."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import robustcap_tpu_torch
from robustcap_tpu_torch.config import SigMPConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "robustcap_tpu_torch")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        robustcap_tpu_torch.__path__, "robustcap_tpu_torch."))


# Drives what the port added for the bf16/int8 weights in the same process:
# quantization, the int8 step, and the serve path in its three modes; then
# the batched step and the offline evaluation on a fixture corpus, and
# SMPLify's refinement of it; then a serving bundle exported and loaded, the
# multiplexer and the live server; then training: the loop with dropout, a
# trainer with its features, the AMASS camera synthesis and the merge; then
# the data-parallel step and loop on a one-rank mesh, and the corpus
# drivers on raw fixture trees; then live capture: calibration and the
# IMU-camera combiner on the native datapath, and the IMU bridge playing a
# synthetic source over UDP.
_DRIVE = """
import torch
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.nn import rnn
from robustcap_tpu_torch.ops import serve_scan
from robustcap_tpu_torch.ops.geometry_tail import tail_constants
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
specs = {"rnn2": (72, 69, 8, 0.4, True), "rnn3": (141, 3, 8, 0.4, False),
         "rnn4": (171, 69, 12, 0.4, False), "rnn6": (240, 3, 10, 0.4, False),
         "rnn7": (141, 144, 8, 0.1, False), "rnn8": (141, 2, 8, 0.4, False)}
p = sig_mp.init_params(torch.Generator().manual_seed(0), specs, device="cpu")
model = ParametricModel(data=synthetic_smpl_data(num_verts=100), device="cpu")
q = rnn.quantize_params(p)
cfg8 = SigMPConfig(int8_compute=True)
frame = sig_mp.make_frame(torch.rand(33, 3), torch.randn(6, 3),
                          torch.eye(3).expand(6, 3, 3), device="cpu")
carry, out = sig_mp.make_step(model, cfg8)(rnn.prepare_scan_params(q, True),
                                           sig_mp.init_carry(q), frame)
assert torch.isfinite(out[0]).all()
frames = sig_mp._sequence_frames(torch.rand(2, 33, 3), torch.randn(2, 6, 3),
                                 torch.eye(3).expand(2, 6, 3, 3), None,
                                 False, None, torch.device("cpu"))
for w, int8 in ((p, False), (rnn.cast_params(p, torch.bfloat16), False),
                (q, True)):
    prepped = serve_scan.prepare_serve_params(w, int8_gates=int8)
    pose = serve_scan.serve_scan(prepped, tail_constants(model),
                                 SigMPConfig(int8_compute=int8), frames,
                                 sig_mp.init_carry(w))[0]
    assert torch.isfinite(pose).all(), prepped["mode"]
import warnings
from robustcap_tpu_torch.eval import (build_aist_sequences,
                                      evaluate_sequences, run_sequences,
                                      stack_frames)
from robustcap_tpu_torch.preprocess import build_fixture_dataset
seqs = build_aist_sequences(build_fixture_dataset(model, n_seq=1, T=6,
                                                  n_cam=2, seed=1))
pose, tran = sig_mp.forward_offline_batched(p, model, cfg8,
                                            stack_frames(seqs, 8),
                                            device="cpu")
assert tuple(pose.shape) == (2, 8, 24, 3, 3)
assert len(run_sequences(q, model, cfg8, seqs, device="cpu")) == 2
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    out = evaluate_sequences(seqs, p, model, pad_to_multiple=4, device="cpu")
assert out["mpjpe"] == out["mpjpe"], out
from robustcap_tpu_torch.smplify import refine_sequences_batched
refined = refine_sequences_batched(
    [(s.pose_gt, s.tran_gt) for s in seqs], seqs, model=model,
    pad_to_multiple=8, group_size=2, device="cpu")
assert refined[0][0].shape == (6, 24, 3, 3)
import os
import tempfile
import numpy as np
from robustcap_tpu_torch.serving import ServingBundle, export_serving_bundle
from robustcap_tpu_torch.streaming import LiveServer, StreamingMultiplexer
with tempfile.TemporaryDirectory() as d:
    export_serving_bundle(p, model, SigMPConfig(pallas_serve=True), d,
                          chunk_len=2, device="cpu")
    bundle = ServingBundle.load(d, device="cpu")
x = frames
pose, _ = bundle.forward_online(x["j2dc"][0], x["accc"][0], x["oric"][0],
                                first_frame=True)
pose, _ = bundle.forward_chunk(x["j2dc"], x["accc"], x["oric"])
assert tuple(pose.shape) == (2, 24, 3, 3)
mux = StreamingMultiplexer(q, model, cfg8, capacity=2, device="cpu")
mux.open_slot()
pose, _ = mux.step(x["j2dc"], x["accc"], x["oric"],
                   first_frame=np.array([True, False]))
assert np.isfinite(pose).all()
pose_aa, _ = LiveServer(p, model, device="cpu").process(
    x["j2dc"][0].numpy(), x["oric"][0].numpy(), x["accc"][0].numpy(),
    np.eye(3, dtype=np.float32))
assert pose_aa.shape == (24, 3)
from robustcap_tpu_torch.train import (SeqDataset, features, make_forward_fn,
                                       masked_mse, merge_weights, save_pytree,
                                       train, train_rnn8)
corpus = build_fixture_dataset(model, n_seq=2, T=8, n_cam=1, seed=2)
with tempfile.TemporaryDirectory() as d:
    ds = SeqDataset([np.ones((6, 3), np.float32)] * 2,
                    [np.ones((6, 2), np.float32)] * 2)
    train(rnn.init_rnn_params(torch.Generator().manual_seed(0), 3, 2, 4),
          make_forward_fn(0.1), masked_mse, ds, ds, d, num_epoch=1,
          device="cpu")
    train_rnn8(corpus, corpus, save_dir=d + "/run8", num_epoch=1,
               device="cpu")
    for name in specs:
        os.makedirs(f"{d}/{name}")
        save_pytree(p[name], f"{d}/{name}/best_weights.pkl")
    assert set(merge_weights(d, device="cpu")) == set(specs)
base = features.amass_mp_base(corpus)
aug, _ = features.amass_camera_augment(
    torch.Generator().manual_seed(0), torch.from_numpy(base[0][0]),
    torch.from_numpy(base[1][0]), torch.ones(16), target="rnn6")
assert torch.isfinite(aug).all()
from robustcap_tpu_torch.parallel import (initialize_distributed,
                                          make_dp_train_step, make_mesh)
from robustcap_tpu_torch.train.loop import _tensor_leaves
assert not initialize_distributed(device="cpu").enabled
mesh = make_mesh("cpu")
tree = rnn.init_rnn_params(torch.Generator().manual_seed(0), 3, 2, 4)
step = make_dp_train_step(make_forward_fn(0.1), masked_mse, torch.optim.Adam(
    [t.requires_grad_() for t in _tensor_leaves(tree)], lr=1e-3), mesh)
assert float(step(tree, np.ones((6, 2, 3), np.float32),
                  np.ones((6, 2, 2), np.float32), np.array([6, 4]), None,
                  torch.Generator().manual_seed(1))) >= 0
with tempfile.TemporaryDirectory() as d:
    train(tree, make_forward_fn(0.1), masked_mse, ds, ds, d, num_epoch=1,
          batch_size=2, mesh=mesh)
from robustcap_tpu_torch.config import AmassSplits
from robustcap_tpu_torch.preprocess import (amass_sequence_to_work, corpus,
                                            fixtures_raw, preprocess_amass,
                                            random_camera)
assert random_camera(torch.Generator().manual_seed(0)).shape == (3, 3)
with tempfile.TemporaryDirectory() as d:
    fixtures_raw.build_raw_aist(d + "/aist", model, n_seq=1, T=12, n_cam=2)
    corpus.preprocess_aist(d + "/aist", d + "/w", model=model, n_cameras=2,
                           device="cpu")
    fixtures_raw.build_raw_pw3d(d + "/pw", model, n_seq=1, T60=12)
    corpus.preprocess_3dpw(d + "/pw", d + "/w", model=model, device="cpu")
    assert preprocess_amass(model, d, d + "/w", {"train": AmassSplits.train},
                            kinds=("train",), device="cpu") == {
        "train": {k: [] for k in ("pose", "tran", "joint3d", "imu_ori",
                                  "imu_acc", "sync_3d_mp")}}
entry = amass_sequence_to_work(model, np.zeros((24, 72), np.float32),
                               np.zeros((24, 3), np.float32), 120.0,
                               device="cpu")
assert entry["imu_acc"].shape == (12, 6, 3)
import socket
from robustcap_tpu_torch.config import LiveConfig
from robustcap_tpu_torch.sensors import SyntheticImuSource, run_imu_bridge
from robustcap_tpu_torch.streaming import (ImuCamStream, native_available,
                                           parse_imu_packet,
                                           tpose_calibration)
assert native_available()
q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (6, 10, 1))
stream = ImuCamStream(tpose_calibration(q[0], q, device="cpu"),
                      device="cpu")
src = SyntheticImuSource(np.tile(np.eye(3, dtype=np.float32), (4, 6, 1, 1)),
                         np.ones((4, 6, 3), np.float32), device="cpu")
with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10)
    assert run_imu_bridge(source=src, live=LiveConfig(fps=200),
                          dest=rx.getsockname(), max_packets=2) == 2
    for _ in range(2):
        t, qs, accs = parse_imu_packet(rx.recv(4096))
        for i in range(6):
            stream.push(i, t, qs[i], accs[i])
_, R_CB, acc_C = stream.tick()
assert R_CB.shape == (6, 3, 3) and np.isfinite(acc_C).all()
"""


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['robustcap_tpu_torch'] + _submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        + _DRIVE +
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'robustcap_tpu'"
        " or m.startswith('robustcap_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_in_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    for name in ("smplify/__init__.py", "smplify/prior.py",
                 "smplify/losses.py", "smplify/runner.py", "ops/lbfgs.py",
                 "train/__init__.py", "train/data.py", "train/features.py",
                 "train/losses.py", "train/loop.py", "train/trainers.py",
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/distributed.py", "preprocess/aist.py",
                 "preprocess/corpus.py", "preprocess/datasets.py",
                 "preprocess/detectors.py", "preprocess/fixtures_raw.py",
                 "preprocess/occlusion.py", "preprocess/smooth_bbox.py",
                 "utils/__init__.py", "utils/filter.py", "utils/io.py",
                 "utils/print_utils.py", "smpl/armature.py",
                 "streaming/native.py", "streaming/sync.py",
                 "streaming/unity.py", "streaming/detector.py",
                 "sensors/__init__.py", "sensors/xdc_codec.py",
                 "sensors/xsens.py", "sensors/mvnx.py", "sensors/noitom.py",
                 "sensors/calibration.py", "sensors/capture.py",
                 "sensors/bridge.py"):
        assert os.path.join(PKG, name) in files, name
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "robustcap_tpu"), \
                f"{os.path.relpath(path, ROOT)} imports {mod}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from robustcap_tpu_torch.convert import params_from_numpy
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from test_torch_tail import SMALL_SPECS
    data = synthetic_smpl_data(num_verts=100)
    model = ParametricModel(data=data, device="cpu")
    params = sig_mp.init_params(torch.Generator().manual_seed(0),
                                SMALL_SPECS, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParametricModel(data=data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sig_mp.StreamingNet(params, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sig_mp.forward_offline(params, model, SigMPConfig(),
                               torch.zeros(2, 33, 3), torch.zeros(2, 6, 3),
                               torch.eye(3).expand(2, 6, 3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sig_mp.init_params(torch.Generator().manual_seed(0), SMALL_SPECS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": [[1.0]]}, "cuda")
    from robustcap_tpu_torch.eval import (EvalSequence, evaluate_sequences,
                                          run_sequences)
    frames = {"j2dc": torch.zeros(1, 2, 33, 3),
              "accc": torch.zeros(1, 2, 6, 3),
              "oric": torch.eye(3).expand(1, 2, 6, 3, 3),
              "first_tran": torch.zeros(1, 2, 3),
              "gravityc": torch.zeros(1, 2, 3),
              "first_frame": torch.zeros(1, 2, dtype=torch.bool),
              "first_tran_valid": torch.zeros(1, 2, dtype=torch.bool)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sig_mp.forward_offline_batched(params, model, SigMPConfig(), frames)
    z = torch.zeros(2, 33, 3).numpy()
    seq = EvalSequence("s", z, z, z[:, :6], np.zeros((2, 6, 3, 3)),
                       np.zeros((2, 24, 3, 3)), z[:, 0], z[:, 0],
                       np.eye(3), None, True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sequences(params, model, SigMPConfig(), [seq])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_sequences([seq], params, model)
    from robustcap_tpu_torch.serving import (ServingBundle,
                                             export_serving_bundle)
    from robustcap_tpu_torch.smpl import default_body_model
    from robustcap_tpu_torch.streaming import (LiveServer,
                                               StreamingMultiplexer,
                                               measure_streaming_latency)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_body_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_serving_bundle(params, model, SigMPConfig(), "unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingBundle.load("unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingMultiplexer(params, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveServer(params, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_streaming_latency(params, model)
    from robustcap_tpu_torch.smplify import (MaxMixturePrior,
                                             TemporalSMPLify,
                                             refine_sequences_batched,
                                             smplify_runner)
    pose = np.broadcast_to(np.eye(3), (2, 24, 3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaxMixturePrior("unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TemporalSMPLify(np.eye(3), np.zeros((2, 6, 3, 3)), model=model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refine_sequences_batched([(pose, np.zeros((2, 3)))], [seq],
                                 model=model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smplify_runner(pose, np.zeros((2, 3)), z, np.zeros((2, 6, 3, 3)),
                       2, np.eye(3), model=model)
    from robustcap_tpu_torch.__main__ import main
    from robustcap_tpu_torch.nn.rnn import (cycle_rnn_params_from_torch,
                                            pure_rnn_params_from_torch)
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.train import (SeqDataset, batch_inference,
                                           load_checkpoint, load_pytree,
                                           make_forward_fn, masked_mse,
                                           merge_weights, save_pytree, train,
                                           trainers)
    monkeypatch.undo()
    corpus = build_fixture_dataset(model, n_seq=1, T=6, n_cam=1, seed=2)
    aist = tmp_path / "aist"
    os.makedirs(aist)
    for kind in ("train", "val"):
        torch.save(corpus, aist / f"{kind}.pt")
    save_pytree(params["rnn3"], str(tmp_path / "w.pkl"))
    for name in params:
        os.makedirs(tmp_path / name)
        save_pytree(params[name], str(tmp_path / name / "best_weights.pkl"))
    _no_cuda(monkeypatch)
    ds = SeqDataset([np.ones((4, 141), np.float32)],
                    [np.ones((4, 3), np.float32)])
    for call in (
            lambda: train(params["rnn3"], make_forward_fn(0.0), masked_mse,
                          ds, ds, str(tmp_path / "run")),
            lambda: batch_inference(params["rnn3"], make_forward_fn(0.0), ds),
            lambda: trainers.train_rnn3(corpus, corpus,
                                        save_dir=str(tmp_path / "r3")),
            lambda: trainers.train_rnn7(corpus, corpus,
                                        save_dir=str(tmp_path / "r7")),
            lambda: trainers.train_rnn8(corpus, corpus,
                                        save_dir=str(tmp_path / "r8")),
            lambda: merge_weights(str(tmp_path)),
            lambda: load_pytree(str(tmp_path / "w.pkl")),
            lambda: load_checkpoint(str(tmp_path / "w.pkl")),
            lambda: pure_rnn_params_from_torch({}),
            lambda: cycle_rnn_params_from_torch({}),
            lambda: main(["train", "--rnn", "3", "--aist", str(aist)]),
            lambda: main(["quantize", "--weights", str(tmp_path / "w.pkl"),
                          "--out", str(tmp_path / "q.pkl")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from robustcap_tpu_torch.parallel import (initialize_distributed,
                                              make_global_mesh, make_mesh)
    from robustcap_tpu_torch.preprocess import (amass_sequence_to_work,
                                                corpus, preprocess_amass)
    for call in (
            make_mesh, make_global_mesh,
            lambda: initialize_distributed("127.0.0.1:1", 1, 0),
            lambda: amass_sequence_to_work(model, np.zeros((24, 72)),
                                           np.zeros((24, 3))),
            lambda: preprocess_amass(model, str(tmp_path), str(tmp_path),
                                     {"train": []}),
            lambda: corpus.preprocess_aist(str(tmp_path), str(tmp_path)),
            lambda: corpus.write_not_aligned(str(tmp_path)),
            lambda: corpus.preprocess_totalcapture_pre(str(tmp_path)),
            lambda: corpus.preprocess_totalcapture(str(tmp_path),
                                                   str(tmp_path)),
            lambda: corpus.preprocess_3dpw(str(tmp_path), str(tmp_path)),
            lambda: main(["preprocess", "--dataset", "pw3d", "--raw",
                          str(tmp_path), "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not torch.distributed.is_initialized()
    from robustcap_tpu_torch.sensors import SyntheticImuSource
    from robustcap_tpu_torch.streaming import (CalibrationResult,
                                               ImuCamStream, MotionViewer,
                                               tpose_calibration)
    from robustcap_tpu_torch.utils import LowPassFilterRotation
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (6, 4, 1))
    eye = np.eye(3, dtype=np.float32)
    calib = CalibrationResult(eye, np.tile(eye, (6, 1, 1)), eye, eye)
    for call in (
            lambda: tpose_calibration(q[0], q),
            lambda: ImuCamStream(calib),
            lambda: SyntheticImuSource(np.tile(eye, (2, 6, 1, 1)),
                                       np.zeros((2, 6, 3))),
            lambda: MotionViewer(),
            lambda: LowPassFilterRotation()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# Public top-level names of the JAX package still without a counterpart in
# the port, by JAX module (``None``: the whole module). Every one belongs to
# a later slice: dynamics (A13c), display (A13d: ``viz/``,
# ``eval/visualize.py`` and its re-exports), the ``articulate``-shaped
# facade (A13e).
_WAITING = {
    "dynamics/__init__.py": None,
    "dynamics/rigid_body.py": None,
    "viz/__init__.py": None,
    "viz/keypoints.py": None,
    "viz/render.py": None,
    "viz/viewers.py": None,
    "eval/visualize.py": None,
    "eval/__init__.py": {"run_single_view", "view_aist", "view_aist_unity"},
    "compat.py": None,
}
# Names the port holds under another module or name by design: the Pallas
# kernels' modules map to the CUDA kernels' wrappers (``PERF.md`` section 6),
# checkpoint conversion lives in ``convert.py`` (it imports the model), and
# orbax (a JAX library) gives way to ``torch.save``.
_COUNTERPARTS = {
    "ops/pallas_lstm.py": {
        "rnn_scan_pallas": "ops.lstm_scan.rnn_scan_chunked",
        "rnn_scan_pallas_chunked": "ops.lstm_scan.rnn_scan_chunked",
        "lstm_stack_vmem_bytes": "ops.lstm_scan.lstm_plan"},
    "ops/pallas_tail.py": {
        "geometry_tail": "ops.geometry_tail.geometry_tail",
        "tail_constants": "ops.geometry_tail.tail_constants",
        "tail_math": "ops.geometry_tail.tail_plain"},
    "ops/pallas_serve.py": {
        "prepare_serve_params": "ops.serve_scan.prepare_serve_params",
        "serve_scan": "ops.serve_scan.serve_scan",
        "serve_vmem_plan": "ops.serve_scan.serve_plan"},
    "models/sig_mp.py": {
        "load_torch_checkpoint": "convert.load_torch_checkpoint",
        "params_from_torch_state_dict":
            "convert.params_from_torch_state_dict"},
    "train/loop.py": {"save_checkpoint_orbax": "train.loop.save_checkpoint",
                      "load_checkpoint_orbax": "train.loop.load_checkpoint"},
    "train/__init__.py": {"save_checkpoint_orbax": "train.save_checkpoint",
                          "load_checkpoint_orbax": "train.load_checkpoint"},
}


def _public_names(path):
    r"""A module's public top-level names: its functions, classes and
    assignments, and in a package's ``__init__.py`` what it imports from
    its submodules."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif (isinstance(node, ast.ImportFrom) and node.level == 1
              and os.path.basename(path) == "__init__.py"):
            names.update(a.asname or a.name for a in node.names
                         if a.name != "*")
    return {n for n in names if not n.startswith("_")}


def test_port_holds_every_public_name_of_the_jax_package():
    import importlib
    jax_root = os.path.join(ROOT, "robustcap_tpu")
    missing, checked = {}, 0
    for dirpath, _, files in os.walk(jax_root):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jax_root)
            waiting = _WAITING.get(rel, set())
            if waiting is None:
                assert not os.path.exists(os.path.join(PKG, rel)), \
                    f"{rel} is ported: take it off the waiting list"
                continue
            moved = _COUNTERPARTS.get(rel, {})
            for other in moved.values():
                mod, attr = other.rsplit(".", 1)
                assert hasattr(importlib.import_module(
                    f"robustcap_tpu_torch.{mod}"), attr), other
            mod = "robustcap_tpu_torch." + rel[:-3].replace(os.sep, ".")
            mod = mod[:-len(".__init__")] if mod.endswith(".__init__") \
                else mod
            port = (importlib.import_module(mod)
                    if os.path.exists(os.path.join(PKG, rel)) else None)
            for n in sorted(_public_names(os.path.join(dirpath, name))):
                checked += 1
                if n in waiting:
                    assert port is None or not hasattr(port, n), \
                        f"{rel}: {n} is ported: take it off the list"
                elif n not in moved and (port is None
                                         or not hasattr(port, n)):
                    missing.setdefault(rel, []).append(n)
    assert checked > 300
    assert not missing, missing


def test_cli_lists_preprocess(capsys):
    from robustcap_tpu_torch.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "preprocess" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["preprocess", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for choice in ("aist", "aist_pre", "tc_pre", "totalcapture_pre", "tc",
                   "totalcapture", "pw3d", "pw3d_occ", "amass"):
        assert choice in out


@pytest.mark.parametrize("field", ["pallas_serve", "int8_compute"])
def test_unported_options_raise(field):
    r"""What the serve path does not take raises instead of running another
    path: the reprojection refinement (as in the JAX serve kernel), and a
    ``cfg.int8_compute`` that disagrees with the prepared weight mode."""
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.nn.rnn import quantize_params
    from robustcap_tpu_torch.ops import serve_scan
    from robustcap_tpu_torch.ops.geometry_tail import tail_constants
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from test_torch_tail import SMALL_SPECS
    model = ParametricModel(data=synthetic_smpl_data(num_verts=100),
                            device="cpu")
    params = sig_mp.init_params(torch.Generator().manual_seed(0),
                                SMALL_SPECS, device="cpu")
    if field == "pallas_serve":
        cfg = SigMPConfig(pallas_serve=True, use_reproj_opt=True)
        with pytest.raises(ValueError, match="standard serving"):
            sig_mp.StreamingNet(params, model, cfg, device="cpu")
        with pytest.raises(ValueError, match="standard serving"):
            sig_mp.forward_offline(params, model, cfg, torch.zeros(2, 33, 3),
                                   torch.zeros(2, 6, 3),
                                   torch.eye(3).expand(2, 6, 3, 3),
                                   device="cpu")
        return
    frames = sig_mp._sequence_frames(
        torch.rand(2, 33, 3), torch.zeros(2, 6, 3),
        torch.eye(3).expand(2, 6, 3, 3), None, False, None,
        torch.device("cpu"))
    for weights, int8_gates, cfg in (
            (params, False, SigMPConfig(int8_compute=True)),
            (quantize_params(params), False, SigMPConfig(int8_compute=True)),
            (quantize_params(params), True, SigMPConfig())):
        prepped = serve_scan.prepare_serve_params(weights,
                                                  int8_gates=int8_gates)
        with pytest.raises(ValueError, match="int8_gates"):
            serve_scan.serve_scan(prepped, tail_constants(model), cfg,
                                  frames, sig_mp.init_carry(weights))


def test_tail_wrapper_has_no_other_path():
    from robustcap_tpu_torch.ops.geometry_tail import geometry_tail
    with pytest.raises(ValueError, match="no geometry-tail path"):
        geometry_tail(None, SigMPConfig(), torch.zeros(144, device="meta"),
                      None, None, None, None, None, None, None, None)


def test_serve_wrapper_has_no_other_path():
    from robustcap_tpu_torch.ops.serve_scan import serve_scan
    with pytest.raises(ValueError, match="no serve path"):
        serve_scan(None, None, SigMPConfig(),
                   {"j2dc": torch.zeros(4, 33, 3, device="meta")}, None)


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    r"""An edited shared header gives a kernel a new library path, so a
    stale build is never loaded."""
    from robustcap_tpu_torch.ops import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first


def test_chip_smoke_refuses_without_a_card(tmp_path):
    r"""Without a card ``chip_smoke.py`` exits nonzero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the script would run")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
