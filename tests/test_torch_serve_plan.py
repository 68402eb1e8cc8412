r"""The serve kernel's host side: the plan that gives every block of the
launch its fixed runs of records (``serve_plan``), and the packed copy of
the weights those runs are cut from (``pack_stack``/``unpack_stack``).

No kernel runs here: the plan and the packing are plain PyTorch and numpy,
and the kernel (``csrc/serve_scan.cu``) reads exactly what they lay out.
Checked at the full ``RNN_SPECS`` widths and at the small test widths, for
the H100's 132 SMs and other grids, in the three weight modes: every record
of every phase kind belongs to exactly one block, the runs are balanced,
the ring and the resident runs fit the shared memory the plan was given,
the plan does not change from one call to the next, and unpacking the
packed copy gives back the torch-layout tensors bit for bit.
"""

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.nn import rnn
from robustcap_tpu_torch.nn.rnn import cast_params, quantize_params
from robustcap_tpu_torch.ops import serve_scan as S
from test_torch_tail import CPU, SMALL_SPECS

SMEM = 232448   # an H100 block's dynamic shared memory (227 KB)
MODES = ("f32", "bf16", "int8")
# widths where rows need padding to whole 16-byte chunks in every mode
ODD_SPECS = {"rnn2": (72, 69, 8, 0.4, True), "rnn3": (141, 3, 8, 0.4, False),
             "rnn4": (171, 69, 40, 0.4, False),
             "rnn6": (240, 3, 24, 0.4, False),
             "rnn7": (141, 144, 8, 0.1, False),
             "rnn8": (141, 2, 8, 0.4, False)}


def prepare(params, mode):
    if mode == "bf16":
        return S.prepare_serve_params(cast_params(params, torch.bfloat16))
    return S.prepare_serve_params(params, int8_gates=mode == "int8")


@pytest.fixture(scope="module")
def full():
    params = sig_mp.init_params(torch.Generator().manual_seed(0),
                                device=CPU)
    return {mode: prepare(params, mode) for mode in MODES}


@pytest.fixture(scope="module")
def small():
    params = sig_mp.init_params(torch.Generator().manual_seed(1),
                                SMALL_SPECS, device=CPU)
    return {mode: prepare(params, mode) for mode in MODES}


def records(prepped, si, k):
    st = prepped["stacks"][S._STACKS[si]]
    return st["out"] if k == 3 else st["H"]


def check_plan(prepped, plan, n_sms, smem):
    starts = plan["starts"]
    assert starts.shape == (6, 4, n_sms + 1)
    for si in range(6):
        for k in range(4):
            counts = np.diff(starts[si, k])
            # each record of the kind in exactly one block's run
            assert starts[si, k, 0] == 0
            assert starts[si, k, -1] == records(prepped, si, k)
            assert (counts >= 0).all()
            assert counts.max() - counts.min() <= 1
    # the stacks that share a phase balance: no block has more than an
    # even share of the phase, rounded up
    groups = ((0,), (1, 4, 5), (2,), (4, 5, 3), (0, 2), (4, 5, 3, 1))
    for g in groups:
        for k in range(4):
            per_block = sum(np.diff(starts[si, k]) for si in g)
            total = sum(records(prepped, si, k) for si in g)
            assert per_block.max() <= -(-total // n_sms)
    lay = plan["layout"]
    names = ("bars", "state", "xin", "act", "actq", "parts", "red", "own",
             "tail", "tconst", "res", "ring")
    offsets = [lay[n] for n in names]
    assert offsets == sorted(offsets)
    assert all(o % 16 == 0 for o in offsets)
    assert lay["ring_bytes"] % 16 == 0
    assert lay["total"] == lay["ring"] + lay["ring_bytes"] <= smem
    assert lay["ring"] >= lay["res"] + plan["res_bytes"]
    rec = plan["rec"]
    most = np.diff(starts, axis=2).max(axis=2)
    streamed = []
    for si in range(6):
        for k in range(4):
            assert rec[si][k] % 16 == 0
            run = int(most[si, k]) * rec[si][k]
            if plan["resident"][si][k]:
                assert plan["res_off"][si][k] % 16 == 0
                assert plan["res_off"][si][k] + run <= plan["res_bytes"]
            else:
                streamed.append(rec[si][k])
                # a piece is cap records, at most a _PIECES-th of the ring
                # (or one record where a record is larger), so that that
                # many pieces are in flight
                cap = plan["cap"][si][k]
                assert 1 <= cap
                assert cap * rec[si][k] <= lay["ring_bytes"] // S._PIECES \
                    or cap == 1
    assert lay["ring_bytes"] >= 2 * max(streamed, default=0)
    # resident runs do not overlap
    spans = sorted((plan["res_off"][si][k],
                    plan["res_off"][si][k] + int(most[si, k]) * rec[si][k])
                   for si in range(6) for k in range(4)
                   if plan["resident"][si][k])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_sms", [132, 114, 7])
def test_plan_full_width(full, mode, n_sms):
    plan = S.serve_plan(full[mode], n_sms, SMEM)
    check_plan(full[mode], plan, n_sms, SMEM)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_sms", [132, 5, 3, 1])
def test_plan_small_width(small, mode, n_sms):
    plan = S.serve_plan(small[mode], n_sms, SMEM)
    check_plan(small[mode], plan, n_sms, SMEM)


@pytest.mark.parametrize("smem", [28000, 60000])
@pytest.mark.parametrize("mode", MODES)
def test_plan_small_budget(small, mode, smem):
    # pieces stream through a ring smaller than one stack's run
    plan = S.serve_plan(small[mode], 2, smem)
    check_plan(small[mode], plan, 2, smem)


def test_residency_on_the_h100(full):
    # the ring keeps at least a mode's least size (larger rings measured
    # faster on the H100 than more residency): int8 keeps rnn7 and rnn8
    # whole beside a ~96 KB ring, bf16 only small runs beside a ~160 KB
    # ring, and float32 streams everything
    order = S._STACKS
    plans = {m: S.serve_plan(full[m], 132, SMEM) for m in MODES}
    for name in ("rnn7", "rnn8"):
        assert all(plans["int8"]["resident"][order.index(name)])
    for plan in (plans["int8"], plans["bf16"]):
        for name in ("rnn4", "rnn6"):
            assert not any(plan["resident"][order.index(name)])
    assert plans["int8"]["layout"]["ring_bytes"] >= 96 * 1024
    assert plans["bf16"]["layout"]["ring_bytes"] >= 160 * 1024
    assert not any(any(r) for r in plans["f32"]["resident"])


def test_plan_refuses_a_ring_too_small(full):
    with pytest.raises(ValueError, match="ring"):
        S.serve_plan(full["f32"], 132, 60000)


@pytest.mark.parametrize("mode", MODES)
def test_plan_is_deterministic(small, full, mode):
    for prepped, n in ((small[mode], 3), (full[mode], 132)):
        a, b = S.serve_plan(prepped, n, SMEM), S.serve_plan(prepped, n, SMEM)
        assert np.array_equal(a["starts"], b["starts"])
        assert {k: v for k, v in a.items() if k != "starts"} == \
            {k: v for k, v in b.items() if k != "starts"}


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("specs", [SMALL_SPECS, ODD_SPECS],
                         ids=["small", "odd"])
@pytest.mark.parametrize("mode", MODES)
def test_unpack_gives_back_the_weights(specs, mode):
    params = sig_mp.init_params(torch.Generator().manual_seed(2), specs,
                                device=CPU)
    prepped = prepare(params, mode)
    for name, st in prepped["stacks"].items():
        back = S.unpack_stack(st, prepped["mode"])
        for key in ("w1", "b1", "w2", "b2"):
            assert_same(back[key], st[key])
        keys = ("w_ih", "w_hh", "bias") + (
            ("w_ih_s", "w_hh_s") if mode == "int8" else ())
        for key in keys:
            for l in range(2):
                assert_same(back[key][l], st[key][l])
        assert ("w_ih_s" in back) == (mode == "int8")
        buf, offsets, rec, lens = st["packed"]
        assert buf.dtype == torch.uint8
        assert all(o % 16 == 0 for o in offsets)
        assert all(r % 16 == 0 for r in rec)


def test_int8_records_hold_the_row_scales():
    params = sig_mp.init_params(torch.Generator().manual_seed(3),
                                SMALL_SPECS, device=CPU)
    q = quantize_params(params)
    st = S.prepare_serve_params(q, int8_gates=True)["stacks"]["rnn4"]
    H = st["H"]
    buf, offsets, rec, lens = st["packed"]
    # unit 5 of layer 1: 8 rows of lens[2] int8, 4 biases, 8 scales
    r = buf[offsets[2] + 5 * rec[2]:offsets[2] + 6 * rec[2]]
    tail = r[8 * lens[2]:].contiguous().view(torch.float32)
    gates = [g * H + 5 for g in range(4)]
    assert torch.equal(tail[:4], st["bias"][1][gates])
    assert torch.equal(tail[4:8], st["w_ih_s"][1][gates])
    assert torch.equal(tail[8:], st["w_hh_s"][1][gates])
    rows = r[:8 * lens[2]].view(torch.int8).view(8, lens[2])[:, :H]
    assert torch.equal(rows[:4], st["w_ih"][1][gates])
    assert torch.equal(rows[4:], st["w_hh"][1][gates])


def test_timestamps_only_on_the_card(small):
    with pytest.raises(ValueError, match="timestamps"):
        S.serve_scan(small["f32"], None, sig_mp.SigMPConfig(),
                     {"j2dc": torch.zeros(1, 33, 3)}, None,
                     timestamps=torch.zeros(1, S.TS_SLOTS,
                                            dtype=torch.int64))


def state_dict(H=8, n_in=5, n_out=3):
    g = torch.Generator().manual_seed(4)
    sd = {"linear1.weight": torch.randn(H, n_in, generator=g),
          "linear1.bias": torch.randn(H, generator=g),
          "linear2.weight": torch.randn(n_out, H, generator=g),
          "linear2.bias": torch.randn(n_out, generator=g)}
    for k in range(2):
        sd[f"rnn.weight_ih_l{k}"] = torch.randn(4 * H, H, generator=g)
        sd[f"rnn.weight_hh_l{k}"] = torch.randn(4 * H, H, generator=g)
        sd[f"rnn.bias_ih_l{k}"] = torch.randn(4 * H, generator=g)
        sd[f"rnn.bias_hh_l{k}"] = torch.randn(4 * H, generator=g)
    return sd


def test_rnn_params_from_torch_defaults_to_the_card(monkeypatch):
    # like every other entry point: the default is the card, which raises
    # on a host without one; the CPU is asked for by name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rnn.rnn_params_from_torch(state_dict())
    params = rnn.rnn_params_from_torch(state_dict(), device="cpu")
    leaves = [params["linear1"]["w"], params["linear2"]["b"],
              *[l[k] for l in params["layers"] for k in l]]
    assert len(params["layers"]) == 2
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in leaves)
    assert torch.equal(params["layers"][1]["w_hh"],
                       state_dict()["rnn.weight_hh_l1"])
