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
# the batched step and the offline evaluation on a fixture corpus.
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
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "robustcap_tpu"), \
                f"{os.path.relpath(path, ROOT)} imports {mod}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(monkeypatch):
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
