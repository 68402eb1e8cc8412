r"""The port's LSTM stacks (``nn/rnn.py``) and the plain version of the
LSTM-scan kernel (``ops/lstm_scan.py``) against the JAX package.

Inputs and weights are made once with numpy or JAX and handed to both.
Tolerance 2e-5 absolute, as ``tests/test_pallas_lstm.py`` uses: float32
matrix products summed in another order, compounded over at most 13 frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu.nn import rnn as jrnn
from robustcap_tpu.ops.pallas_lstm import (rnn_scan_pallas,
                                           rnn_scan_pallas_chunked)
from robustcap_tpu_torch.convert import (load_torch_checkpoint,
                                         params_from_numpy,
                                         params_from_torch_state_dict)
from robustcap_tpu_torch.nn import rnn as trnn
from robustcap_tpu_torch.ops.lstm_scan import rnn_scan_chunked
from test_torch_tail import SMALL_SPECS, assert_tree_close

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 2e-5


def _close(want, got, atol=ATOL):
    assert_tree_close(want, got, atol)


def _pair(key, n_in, n_out, hidden, with_init=False):
    jp = jrnn.init_rnn_params(jax.random.PRNGKey(key), n_in, n_out, hidden,
                              2, with_init)
    return jp, params_from_numpy(jax.tree.map(np.array, jp), "cpu")


def _state(rng, hidden):
    h = rng.randn(2, hidden).astype(np.float32) * 0.5
    c = rng.randn(2, hidden).astype(np.float32) * 0.5
    return (h, c), (torch.tensor(h), torch.tensor(c))


def test_lstm_cell_and_step():
    jp, tp = _pair(0, 30, 7, 24)
    rng = np.random.RandomState(0)
    x = rng.randn(30).astype(np.float32)
    jst, tst = _state(rng, 24)
    layer_j, layer_t = jp["layers"][0], tp["layers"][0]
    y = rng.randn(24).astype(np.float32)
    _close(jrnn.lstm_cell(layer_j, jnp.asarray(y), jnp.asarray(jst[0][0]),
                          jnp.asarray(jst[1][0])),
           trnn.lstm_cell(layer_t, torch.tensor(y), tst[0][0], tst[1][0]))
    _close(jrnn.rnn_step(jp, jnp.asarray(x), jst),
           trnn.rnn_step(tp, torch.tensor(x), tst))


def test_lstm_gate_order_matches_torch_lstm():
    r"""The cell's gate order (i, f, g, o) and layout are torch's own."""
    _, tp = _pair(1, 12, 5, 16)
    lstm = torch.nn.LSTM(16, 16, num_layers=2)
    with torch.no_grad():
        for k, layer in enumerate(tp["layers"]):
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                torch_name = {"w_ih": "weight_ih", "w_hh": "weight_hh",
                              "b_ih": "bias_ih", "b_hh": "bias_hh"}[name]
                getattr(lstm, f"{torch_name}_l{k}").copy_(layer[name])
    rng = np.random.RandomState(1)
    ys = torch.tensor(rng.randn(6, 16).astype(np.float32))
    h, c = torch.zeros(2, 16), torch.zeros(2, 16)
    outs = []
    for t in range(6):
        inp, new_h, new_c = ys[t], [], []
        for k, layer in enumerate(tp["layers"]):
            hn, cn = trnn.lstm_cell(layer, inp, h[k], c[k])
            new_h.append(hn)
            new_c.append(cn)
            inp = hn
        h, c = torch.stack(new_h), torch.stack(new_c)
        outs.append(inp)
    with torch.no_grad():
        want, (hw, cw) = lstm(ys[:, None])
    np.testing.assert_allclose(torch.stack(outs).numpy(), want[:, 0].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), hw[:, 0].numpy(), atol=1e-6)


def test_group_and_pair_step():
    ja, ta = _pair(2, 20, 9, 16)
    jb, tb = _pair(3, 20, 2, 16)
    jc, tc = _pair(4, 20, 3, 12)     # different geometry
    rng = np.random.RandomState(2)
    x = rng.randn(20).astype(np.float32)
    states = [_state(rng, h) for h in (16, 16, 12)]
    want = jrnn.rnn_group_step((ja, jb, jc), jnp.asarray(x),
                               tuple(s[0] for s in states))
    got = trnn.rnn_group_step((ta, tb, tc), torch.tensor(x),
                              tuple(s[1] for s in states))
    _close(want, got)
    _close(jrnn.rnn_pair_step(ja, jb, jnp.asarray(x), states[0][0],
                              states[1][0]),
           trnn.rnn_pair_step(ta, tb, torch.tensor(x), states[0][1],
                              states[1][1]))


def test_rnn_scan_and_init_net():
    jp, tp = _pair(5, 72, 69, 32, with_init=True)
    rng = np.random.RandomState(3)
    xs = rng.randn(11, 72).astype(np.float32)
    _close(jrnn.rnn_scan(jp, jnp.asarray(xs)),
           trnn.rnn_scan(tp, torch.tensor(xs)))
    label = rng.randn(3, 69).astype(np.float32)
    _close(jrnn.init_net_apply(jp, jnp.asarray(label)),
           trnn.init_net_apply(tp, torch.tensor(label)))
    _close(jrnn.init_state(jp, (3,)), trnn.init_state(tp, (3,)), atol=0)


def test_plain_scan_matches_pallas_kernel():
    jp, tp = _pair(6, 72, 69, 64)
    xs = np.random.RandomState(4).randn(12, 72).astype(np.float32)
    want = rnn_scan_pallas(jp, jnp.asarray(xs), interpret=True)
    ys, (h, c) = rnn_scan_chunked(tp, torch.tensor(xs))
    _close(want[0], ys)
    _close((want[1][0][:2], want[1][1][:2]), (h, c))


@pytest.mark.parametrize("seeded", [False, True])
def test_chunked_scan_matches_pallas_chunked(seeded):
    jp, tp = _pair(7, 141, 3, 48)
    rng = np.random.RandomState(5)
    xs = rng.randn(13, 141).astype(np.float32)
    jst, tst = _state(rng, 48) if seeded else (None, None)
    want = rnn_scan_pallas_chunked(jp, jnp.asarray(xs), jst, max_chunk=5,
                                   interpret=True)
    got = rnn_scan_chunked(tp, torch.tensor(xs), tst, max_chunk=5)
    _close(want, got)
    # chunking changes nothing: one chunk of 13 gives the same values
    whole = rnn_scan_chunked(tp, torch.tensor(xs), tst, max_chunk=256)
    _close(whole, got, atol=0)


def test_scan_wrapper_has_no_other_path():
    _, tp = _pair(8, 10, 3, 8)
    with pytest.raises(ValueError, match="no LSTM-scan path"):
        rnn_scan_chunked(tp, torch.zeros(4, 10, device="meta"))
    with pytest.raises(ValueError, match="2-layer"):
        rnn_scan_chunked(dict(tp, layers=tp["layers"][:1]),
                         torch.zeros(4, 10))


def _torch_state_dict(jp, prefix):
    r"""A reference-layout state dict of one module from JAX params."""
    sd = {f"{prefix}linear1.weight": jp["linear1"]["w"],
          f"{prefix}linear1.bias": jp["linear1"]["b"],
          f"{prefix}linear2.weight": jp["linear2"]["w"],
          f"{prefix}linear2.bias": jp["linear2"]["b"]}
    for k, layer in enumerate(jp["layers"]):
        sd[f"{prefix}rnn.weight_ih_l{k}"] = layer["w_ih"]
        sd[f"{prefix}rnn.weight_hh_l{k}"] = layer["w_hh"]
        sd[f"{prefix}rnn.bias_ih_l{k}"] = layer["b_ih"]
        sd[f"{prefix}rnn.bias_hh_l{k}"] = layer["b_hh"]
    for i, lin in zip((0, 2, 4), jp.get("init_net", [])):
        sd[f"{prefix}init_net.{i}.weight"] = lin["w"]
        sd[f"{prefix}init_net.{i}.bias"] = lin["b"]
    return {k: np.array(v) for k, v in sd.items()}


def test_torch_checkpoint_conversion(tmp_path):
    from robustcap_tpu.models import sig_mp as jsig
    jp = jsig.init_params(jax.random.PRNGKey(9), SMALL_SPECS)
    sd = {}
    for name in SMALL_SPECS:
        sd.update(_torch_state_dict(jp[name], f"{name}."))
    want = jsig.params_from_torch_state_dict(sd)
    got = params_from_torch_state_dict(sd, device="cpu")
    _close(want, got, atol=0)
    path = tmp_path / "best_weights.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    _close(want, load_torch_checkpoint(path, device="cpu"), atol=0)

