r"""The system under test, ``robustcap_tpu_torch``, built from what the
benchmark made: the network's weights as the configuration serves them,
and its body model from the procedural body's arrays. The modules under
``entries/`` take the entry points they time from here and from the port.
"""

from __future__ import annotations

import dataclasses

import torch

from . import inputs

__all__ = ["DTYPES", "weights", "body_model", "sigmp_config", "flags",
           "reference"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def weights(ctx, dev):
    r"""The bank in the configuration's serving type."""
    return inputs.make_weights(ctx.config["stacks"], ctx.seed, dev,
                               DTYPES[ctx.config["dtype"]])


def body_model(ctx, body, dev):
    r"""The port's ``ParametricModel`` over the body's arrays."""
    from robustcap_tpu_torch.smpl.model import ParametricModel, SmplData
    h = inputs.host(body)
    from portbench.reference.body import SMPL_PARENT
    data = SmplData(j_regressor=h["j_regressor"],
                    skinning_weights=h["skinning"], posedirs=h["posedirs"],
                    shapedirs=h["shapedirs"], v_template=h["v_template"],
                    joints=h["joints"], faces=h["faces"],
                    parent=SMPL_PARENT)
    return ParametricModel(
        data=data, use_pose_blendshape=ctx.config["body"]["pose_blendshape"],
        device=dev)


def sigmp_config(traffic):
    r"""The port's ``SigMPConfig`` of the traffic's mode (``offline``: the
    published defaults; ``live``: the live demo's) with its kernel
    flags."""
    from robustcap_tpu_torch.config import SigMPConfig
    base = (SigMPConfig.live_mode() if traffic["mode"] == "live"
            else SigMPConfig.offline())
    return dataclasses.replace(base, **traffic.get("flags", {}))


def flags(traffic):
    r"""The reference's mode flags for the traffic's mode."""
    from .reference import sigmp
    return sigmp.LIVE if traffic["mode"] == "live" else sigmp.OFFLINE


def reference(ctx, body):
    r"""The reference's mode flags and body constants."""
    from .reference import body as ref_body
    return flags(ctx.traffic), ref_body.constants(
        body, ctx.config["body"]["pose_blendshape"])
