r"""Host builds of the port's CUDA kernels for the CPU tests.

:func:`build` compiles ``robustcap_tpu_torch/csrc/<name>.cu`` with
``g++ -std=c++20`` against the stand-in headers of this directory
(``cuda_runtime.h``: a launch runs every CUDA thread of the grid as a fiber
on the launching thread, 3 SMs; x86-64 only; ``serve_async.cuh`` replaces the kernels' copies, clocks and
grid-barrier counter); :func:`use` loads that build in place of the card's
for one test, with the few calls the wrappers make of the CUDA runtime's
streams and devices stubbed, so that a wrapper's ``_launch`` runs the
kernel's own source on CPU tensors.
"""

import contextlib
import ctypes
import glob
import os
import platform
import shutil
import subprocess
import types

import pytest
import torch

from robustcap_tpu_torch.ops import _build

STANDIN = os.path.dirname(os.path.abspath(__file__))


def build(name, out_dir):
    r"""The host build of ``csrc/<name>.cu`` in ``out_dir``, loaded; skips
    the test without ``g++`` or off x86-64."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip(f"the host build of {name}.cu needs g++")
    if platform.machine() != "x86_64":
        pytest.skip(f"the host build of {name}.cu switches stacks in x86-64 "
                    "assembly")
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
        shutil.copy(path, out_dir)
    shutil.copy(os.path.join(STANDIN, "serve_async.cuh"), out_dir)
    out = os.path.join(str(out_dir), f"{name}_standin.so")
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-w",
                    "-I", STANDIN, "-x", "c++",
                    os.path.join(str(out_dir), f"{name}.cu"), "-o", out],
                   check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(out)


def use(monkeypatch, name, lib):
    r"""``ops.<name>._launch`` goes to the host build ``lib``."""
    monkeypatch.setitem(_build._LOADED, name, lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
