r"""The LSTM-scan kernel's own source, ``csrc/lstm_scan.cu``, run on the host.

g++ builds it against the stand-in headers of ``tests/cuda_standin/``: a
cooperative launch runs every CUDA thread of the grid (3 blocks of 512) as a
fiber, ``grid.sync`` is a barrier over all of them, and the
stand-in ``serve_async.cuh`` turns the bulk copies of the resident weights
into ``memcpy`` calls that complete their mbarrier. ``lstm_scan._launch``
drives that build on CPU tensors as it drives the kernel on the card, with
the plan made for 3
blocks: each block owns 5 or 6 units of each layer, so the wavefront's
exchange of h crosses blocks every step.

Held against the plain version (``rnn_scan_plain``) and the JAX kernel
(``rnn_scan_pallas_chunked`` in interpret mode) at small widths, from zero
and from a seeded state; 3 + 5 chained frames give the bits of 8; block 0's
timestamps come in order. The PTX, the speed and the card's memory
ordering are checked only on the card (``chip_smoke.py``).

Tolerance: 1e-4 absolute, as ``chip_smoke.py`` holds the kernel at full
width: float32 sums in another order, compounded over 8 frames through
(h, c).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu.ops.pallas_lstm import rnn_scan_pallas_chunked
from robustcap_tpu_torch.ops import lstm_scan as L
from cuda_standin import standin
from test_torch_rnn import _pair, _state
from test_torch_tail import assert_tree_close

ATOL = 1e-4
T = 8


@pytest.fixture(scope="module")
def standin_lib(tmp_path_factory):
    return standin.build("lstm_scan",
                         tmp_path_factory.mktemp("lstm_standin"))


@pytest.fixture
def on_standin(monkeypatch, standin_lib):
    standin.use(monkeypatch, "lstm_scan", standin_lib)


def launch_chunks(ops, xs, state, sizes):
    outs = []
    for s, n in zip(np.cumsum([0] + sizes[:-1]), sizes):
        ys, state = L._launch(ops, xs[s:s + n], state)
        outs.append(ys)
    return torch.cat(outs), state


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("shape", [(72, 69, 24), (141, 3, 20)],
                         ids=["rnn2", "rnn3"])
def test_standin_scan_matches_plain_and_jax(on_standin, shape, seeded):
    n_in, n_out, hidden = shape
    jp, tp = _pair(11 + hidden, n_in, n_out, hidden)
    rng = np.random.RandomState(hidden)
    xs = rng.randn(T, n_in).astype(np.float32)
    if seeded:
        jst, tst = _state(rng, hidden)
    else:
        jst = None
        tst = tuple(torch.zeros(2, hidden) for _ in range(2))
    ops = L.prepare_lstm_scan(tp)

    got = L._launch(ops, torch.tensor(xs), tst)
    assert_tree_close(L.rnn_scan_plain(ops.params, torch.tensor(xs), tst),
                      got, ATOL)
    want = rnn_scan_pallas_chunked(jp, jnp.asarray(xs), jst, max_chunk=T,
                                   interpret=True)
    assert_tree_close(want, got, ATOL)

    chained = launch_chunks(ops, torch.tensor(xs), tst, [3, 5])
    assert torch.equal(chained[0], got[0])
    assert all(torch.equal(a, b) for a, b in zip(chained[1], got[1]))


def test_standin_timestamps(on_standin):
    r"""Block 0's stamps (``ts_slots``): every slot written, in the order of
    the slots: the pre-pass, the weights landing, each step's work and
    barrier, linear2."""
    _, tp = _pair(3, 72, 69, 16)
    ops = L.prepare_lstm_scan(tp)
    xs = torch.tensor(np.random.RandomState(0).randn(T, 72),
                      dtype=torch.float32)
    ts = torch.zeros(L.ts_slots(T), dtype=torch.int64)
    L._launch(ops, xs, L.init_state(ops.params, (), torch.float32), ts)
    stamps = ts.numpy()
    assert (stamps > 0).all()
    assert (np.diff(stamps) >= 0).all()
    plan = L._device_plan(ops, xs.device)[0]
    assert plan["blocks"] == 3
