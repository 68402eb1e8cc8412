r"""The port stands alone: it imports neither ``jax`` nor the JAX package,
its entry points default to the card and refuse to fall back to the CPU,
and the parts not ported yet raise instead of running another path."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import robustcap_tpu_torch
from robustcap_tpu_torch.config import SigMPConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "robustcap_tpu_torch")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        robustcap_tpu_torch.__path__, "robustcap_tpu_torch."))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['robustcap_tpu_torch'] + _submodules()!r}:\n"
        "    importlib.import_module(name)\n"
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


@pytest.mark.parametrize("field", ["pallas_serve", "int8_compute"])
def test_unported_options_raise(field):
    r"""``int8_compute`` is not ported yet; ``pallas_serve`` is, and refuses
    what the JAX serve path refuses (the reprojection refinement), and the
    int8 gates it does not have yet."""
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from test_torch_tail import SMALL_SPECS
    model = ParametricModel(data=synthetic_smpl_data(num_verts=100),
                            device="cpu")
    params = sig_mp.init_params(torch.Generator().manual_seed(0),
                                SMALL_SPECS, device="cpu")
    refusals = [(SigMPConfig(**{field: True}), NotImplementedError,
                 "later slice")]
    if field == "pallas_serve":
        refusals = [
            (SigMPConfig(pallas_serve=True, use_reproj_opt=True), ValueError,
             "standard serving configuration"),
            (SigMPConfig(pallas_serve=True, int8_compute=True),
             NotImplementedError, "later slice")]
    for cfg, error, match in refusals:
        with pytest.raises(error, match=match):
            sig_mp.StreamingNet(params, model, cfg, device="cpu")
        with pytest.raises(error, match=match):
            sig_mp.forward_offline(params, model, cfg, torch.zeros(2, 33, 3),
                                   torch.zeros(2, 6, 3),
                                   torch.eye(3).expand(2, 6, 3, 3),
                                   device="cpu")


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
