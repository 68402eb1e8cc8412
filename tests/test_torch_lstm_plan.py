r"""The LSTM-scan kernel's host side: the stack prepared once
(``prepare_lstm_scan``: dequantized, cast to float32 and packed with
``serve_scan.pack_stack``) and the plan that gives every block of the launch
its fixed run of units of each layer (``lstm_plan``).

No kernel runs here. Checked at the full width (H 512 on the H100's 132 SMs)
and at small widths on other grids: every unit of both layers belongs to
exactly one block, each block's resident weights and areas fit an H100
block's 227 KB, unpacking the packed copy gives back the float32 stack bit
for bit, and ``rnn_scan_chunked`` gives the same bits for the prepared stack
as for the raw params in float32, bf16 and int8 trees.
"""

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.nn.rnn import (cast_params, init_rnn_params,
                                        quantize_params)
from robustcap_tpu_torch.ops import lstm_scan as L
from robustcap_tpu_torch.ops import serve_scan as S
from test_torch_tail import CPU

SMEM = 232448   # an H100 block's dynamic shared memory (227 KB)


@pytest.fixture(scope="module")
def full():
    params = sig_mp.init_params(torch.Generator().manual_seed(0), device=CPU)
    return {n: L.prepare_lstm_scan(params[n]) for n in ("rnn2", "rnn3")}


def check_plan(stack, plan, nb, smem):
    H = stack["H"]
    starts = plan["starts"]
    assert starts.shape == (2, nb + 1)
    for l in range(2):
        counts = np.diff(starts[l])
        # each unit of the layer in exactly one block's run
        assert starts[l, 0] == 0 and starts[l, -1] == H
        assert (counts >= 0).all() and counts.max() - counts.min() <= 1
    c0, c1 = np.diff(starts[0]), np.diff(starts[1])
    assert (c0 + c1).max() <= L._THREADS
    hp, rec = stack["packed"][3][1], stack["packed"][2]
    # a layer-0 unit's w_hh rows and biases, a layer-1 unit's whole record
    assert (plan["resident"] == c0 * (4 * hp * 4 + 16) + c1 * rec[2]).all()
    lay = plan["layout"]
    names = ("bar", "hv", "part", "tile", "res")
    offs = [lay[k] for k in names]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    assert lay["res"] % 128 == 0
    assert lay["res"] + int(plan["resident"].max()) == lay["total"] <= smem
    assert lay["tile"] - lay["part"] >= 16 * int((c0 + 2 * c1).max())


@pytest.mark.parametrize("name", ["rnn2", "rnn3"])
def test_full_width_plan_fits_the_h100(full, name):
    ops = full[name]
    plan = L.lstm_plan(ops.stack, 132, SMEM)
    check_plan(ops.stack, plan, 132, SMEM)
    # 512 units of each layer over 132 blocks: 3 or 4 a block; 4 + 4 keep
    # 4 x 8208 + 4 x 16400 bytes resident
    assert int(plan["resident"].max()) == 4 * 8208 + 4 * 16400
    assert plan["layout"]["total"] < 120 * 1024


@pytest.mark.parametrize("nb", [1, 3, 7, 64, 600])
@pytest.mark.parametrize("shape", [(72, 69, 24), (141, 3, 20), (10, 5, 40)])
def test_plan_owns_every_unit_once(shape, nb):
    n_in, n_out, hidden = shape
    p = init_rnn_params(torch.Generator().manual_seed(hidden), n_in, n_out,
                        hidden)
    ops = L.prepare_lstm_scan(p)
    check_plan(ops.stack, L.lstm_plan(ops.stack, nb, SMEM), nb, SMEM)


def test_plan_refuses_what_the_kernel_cannot_take(full):
    stack = full["rnn2"].stack
    # 1024 units cannot each have an owner thread in one block
    with pytest.raises(ValueError, match="units a block"):
        L.lstm_plan(stack, 1, SMEM)
    need = L.lstm_plan(stack, 132, SMEM)["layout"]["total"]
    L.lstm_plan(stack, 132, need)
    with pytest.raises(ValueError, match="shared memory"):
        L.lstm_plan(stack, 132, need - 1)


@pytest.mark.parametrize("name", ["rnn2", "rnn3"])
def test_pack_then_unpack_returns_the_stack(full, name):
    s = full[name].stack
    back = S.unpack_stack(s)
    for k in ("w1", "b1", "w2", "b2"):
        assert torch.equal(back[k], s[k]), k
    for k in ("w_ih", "w_hh", "bias"):
        for l in range(2):
            assert torch.equal(back[k][l], s[k][l]), (k, l)
    p = full[name].params
    for l, layer in enumerate(p["layers"]):
        assert torch.equal(s["bias"][l], layer["b_ih"] + layer["b_hh"])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_prepared_and_raw_params_give_the_same_scan(kind):
    p = init_rnn_params(torch.Generator().manual_seed(5), 72, 69, 32)
    if kind == "bf16":
        p = cast_params(p, torch.bfloat16)
    elif kind == "int8":
        p = quantize_params(p)
    ops = L.prepare_lstm_scan(p)
    assert all(t.dtype == torch.float32 for t in
               (ops.stack["w1"], *ops.stack["w_ih"], *ops.stack["w_hh"]))
    xs = torch.randn(9, 72, generator=torch.Generator().manual_seed(6))
    state = tuple(0.5 * torch.randn(2, 32, generator=torch.Generator()
                                    .manual_seed(7 + i)) for i in range(2))
    for st in (None, state):
        raw = L.rnn_scan_chunked(p, xs, st, max_chunk=4)
        prep = L.rnn_scan_chunked(ops, xs, st, max_chunk=4)
        assert torch.equal(raw[0], prep[0])
        assert all(torch.equal(a, b) for a, b in zip(raw[1], prep[1]))


def test_prepared_scan_has_no_other_path():
    ops = L.prepare_lstm_scan(init_rnn_params(torch.Generator().manual_seed(8),
                                              10, 3, 8))
    with pytest.raises(ValueError, match="no LSTM-scan path"):
        L.rnn_scan_chunked(ops, torch.zeros(4, 10, device="meta"))
    with pytest.raises(ValueError, match="on the card"):
        L.rnn_scan_chunked(ops, torch.zeros(4, 10),
                           timestamps=torch.zeros(L.ts_slots(4),
                                                  dtype=torch.int64))
    with pytest.raises(ValueError, match="2-layer"):
        L.prepare_lstm_scan(dict(ops.params,
                                 layers=ops.params["layers"][:1]))
