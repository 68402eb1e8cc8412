r"""Streaming latency harness: per-frame p50/p95/p99 of the live step.

Port of ``robustcap_tpu/streaming/latency.py``: the streaming step
(``StreamingNet.forward_online``) over a synthetic sensor stream, each
frame timed on the host clock up to its translation read back to the host,
with an optional ``torch.profiler`` Chrome trace of the timed frames.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SigMPConfig
from ..models import sig_mp

__all__ = ["measure_streaming_latency"]


def measure_streaming_latency(params, model,
                              cfg: Optional[SigMPConfig] = None,
                              n_frames: int = 600, warmup: int = 30,
                              trace_dir: Optional[str] = None,
                              seed: int = 0,
                              device="cuda") -> Dict[str, float]:
    r"""Returns ``{p50_ms, p95_ms, p99_ms, mean_ms, fps}`` over
    ``n_frames`` after ``warmup`` frames, on the JAX harness's inputs from
    ``seed``. Each frame is timed until its translation is on the host.
    ``trace_dir``: write the timed frames' ``torch.profiler`` trace there
    as ``trace.json`` (CPU and, on the card, CUDA activity)."""
    cfg = cfg or SigMPConfig.live_mode()
    net = sig_mp.StreamingNet(params, model, cfg, device=device)
    rng = np.random.RandomState(seed)
    j2dc = (rng.randn(n_frames + warmup, 33, 3) * 0.1).astype(np.float32)
    j2dc[..., 2] = rng.uniform(0.3, 1.0, (n_frames + warmup, 1))
    accc = rng.randn(n_frames + warmup, 6, 3).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32), (6, 1, 1))

    net.forward_online(j2dc[0], accc[0], eye, first_frame=True)
    for t in range(1, warmup):
        _, tr = net.forward_online(j2dc[t], accc[t], eye)
    tr.cpu()

    prof = None
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if net.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    lat = np.empty(n_frames)
    for i in range(n_frames):
        t = warmup + i
        s = time.perf_counter()
        _, tr = net.forward_online(j2dc[t], accc[t], eye)
        tr.cpu()
        lat[i] = time.perf_counter() - s
    if prof is not None:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    return {
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "mean_ms": float(lat.mean() * 1e3),
        "fps": float(1.0 / lat.mean()),
    }
