r"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

PB = os.path.join(ROOT, "portbench")


def _modules():
    out = []
    for d, _, files in os.walk(PB):
        if os.path.basename(d) == "tests":
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_name_check(monkeypatch):
    import types
    from portbench.run import loaded_forbidden
    fake = types.ModuleType("fake")
    monkeypatch.setitem(sys.modules, "robustcap_tpu_torch.fake_sub", fake)
    assert "robustcap_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "robustcap_tpu.fake_sub", fake)
    assert "robustcap_tpu" in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_sub", fake)
    assert "jaxlib" in loaded_forbidden()


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: os.path.relpath(p, PB))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "robustcap_tpu"}
    if f"{os.sep}reference{os.sep}" in path:
        assert "robustcap_tpu_torch" not in tops


def test_a_drive_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "run._environment()\n"
        "from small import small_context\n"
        "import time\n"
        "import json\n"
        "spec = json.load(open(%r))\n"
        "for cell in [w['name'] for w in spec['workloads']]:\n"
        "    res, forbidden, _, _ = run.run(small_context(cell, seconds=0.2),\n"
        "                                time.perf_counter(), device='cpu')\n"
        "    assert res['correct'], res\n"
        "    assert forbidden == [], forbidden\n"
        "assert run.loaded_forbidden() == []\n"
        "print('ok')\n") % (ROOT, os.path.join(PB, "tests"),
                             os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-2000:]


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload",
         "f32.sequences", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
