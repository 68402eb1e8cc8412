r"""RobustCap in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``robustcap_tpu`` (which stays the reference it is
tested against). This package imports ``torch``, never ``jax``, and nothing
of ``robustcap_tpu``. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version instead.

Ported so far: the single-stream SigMP path (``models.sig_mp``:
``forward_offline`` and ``StreamingNet``) with the LSTM-scan kernel
(``ops.lstm_scan``), the geometry-tail kernel (``ops.geometry_tail``) and the
serve kernel (``ops.serve_scan``, the operator ``robustcap::serve_scan``);
the batched path (``forward_offline_batched``) and the offline evaluation
(``eval``); serving and streaming: exported serving bundles (``serving``),
CUDA-graph replay of the per-frame step (``graphs``), the multiplexer, the
live server, the latency harness and the wire formats (``streaming``), and
the ``export``, ``latency`` and ``live-server`` commands
(``python -m robustcap_tpu_torch``); SMPLify, training, data parallelism and
corpus preprocessing; and live capture: the native IMU datapath, IMU-camera
sync, the detector process, the Unity viewer, the sensor drivers
(``sensors``) and the ``imu-bridge`` command; the rigid-body dynamics
(``dynamics``), display (``viz``, the body model's ``save_*``/``view_*``,
``eval.visualize``) and the ``articulate``-shaped facade (``compat``):
every public name of the JAX package has a counterpart here.
"""

__version__ = "0.1.0"

from . import math  # noqa: E402,F401

__all__ = ["math", "__version__"]
