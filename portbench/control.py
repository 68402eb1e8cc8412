r"""The control of each cell's comparison: the reference put in the
program's place, one step of precision below what the configuration
states, read by the same comparison on the same kind of sample as a run.

* A float32 configuration: the reference with TF32 products (float32 with
  TF32 off is what it states).
* A bfloat16 configuration: the program's own int8 path, the serve
  kernel's int8-gate mode (``cfg.int8_compute``, the bank's matrices as
  int8 records), through the same offline entry.

It needs no measured window: it draws the sample from the traffic's pool
by the seed, with the longest sequence in it, as a run would.
"""

from __future__ import annotations

import dataclasses

from . import generate, inputs, program
from .check import gaps, merge, pick, reference_outputs

__all__ = ["control_numbers"]


def _int8_program(ctx, inputs_, ids, dev):
    from robustcap_tpu_torch.models.sig_mp import forward_offline
    from robustcap_tpu_torch.nn.rnn import quantize_params
    pool = inputs_["pool"]
    model = program.body_model(ctx, inputs_["body"], dev)
    cfg = dataclasses.replace(program.sigmp_config(ctx.traffic),
                              int8_compute=True)
    q = quantize_params(inputs_["bank"])
    out = []
    for i in ids:
        first_tran, first_frame = pool.seeding(i)
        pose, tran = forward_offline(
            q, model, cfg, *pool.frames(i), first_tran=first_tran,
            first_frame=first_frame, gravityc=ctx.traffic["gravity"],
            device=dev)
        out.append((pose.cpu().numpy(), tran.cpu().numpy()))
    return out


def control_numbers(ctx, dev):
    r"""The comparison's numbers for the control of ``ctx``'s cell and
    seed."""
    t = ctx.traffic
    pool = generate.make_pool(t, t.get("pool", t.get("rows")), ctx.seed,
                              dev)
    made = {"bank": program.weights(ctx, dev), "pool": pool,
            "body": inputs.make_body(ctx.seed, dev,
                                     ctx.config["body"]["vertices"])}
    ids = pick(ctx, range(len(pool)), pool.lengths)
    ref_pose, ref_tran = reference_outputs(ctx, made, ids, dev)
    n = [pool.lengths[i] for i in ids]
    if ctx.config["dtype"] == "float32":
        pose, tran = reference_outputs(ctx, made, ids, dev, tf32=True)
        outs = [(pose[r, :n[r]], tran[r, :n[r]]) for r in range(len(ids))]
    else:
        outs = _int8_program(ctx, made, ids, dev)
    return merge([gaps(p, tr, ref_pose[r, :n[r]], ref_tran[r, :n[r]])
                  for r, (p, tr) in enumerate(outs)])
