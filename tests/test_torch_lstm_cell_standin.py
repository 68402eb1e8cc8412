r"""The batched LSTM-cell kernel's own source, ``csrc/lstm_cell_batched.cu``,
run on the host, and the operator ``robustcap::lstm_cell``.

g++ builds the kernel against the stand-in headers of ``tests/cuda_standin/``:
a launch runs every CUDA thread of the grid as a fiber, and the stand-in
``serve_async.cuh`` turns each staged row's bulk copy into a ``memcpy`` that
completes its stage's mbarrier. ``lstm_cell._launch`` drives that build on
CPU tensors as it drives the kernel on the card, with the card's plan (128
blocks at the main path's widths: 4, 8 and 10 units a block at H = 512,
1024 and 1280; 8 to 64 rows a block).

Held against the plain version (``nn.rnn.lstm_cell``'s arithmetic) both
ways the operator's CUDA implementation runs a layer, the kernel and, above
``ROWS_DIRECT`` rows, ``torch.lstm_cell`` with its rows copied in (here on
the CPU), at the main path's widths and B = 1, 3 and 64; the write into one
row of an ``[L, B, H]`` state, the other rows left as they were; a row of a
64-row launch bit for bit the same row launched alone. ``opcheck`` runs on
the operator's CPU implementation. The PTX, the speed and the card's memory
ordering are checked only on the card (``chip_smoke.py``).

Tolerance: 1e-5 absolute on ``h`` and ``c``: float32 sums of up to 2560
products (|z| of a few units) in another order than the CPU's, a few ulp of
the gates' inputs; the largest gap seen is ~1.3e-6.
"""

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.ops import lstm_cell as LC
from cuda_standin import standin

ATOL = 1e-5
WIDTHS = (512, 1024, 1280)
ROWS = (1, 3, 64)


@pytest.fixture(scope="module")
def standin_lib(tmp_path_factory):
    return standin.build("lstm_cell_batched",
                         tmp_path_factory.mktemp("lstm_cell_standin"))


@pytest.fixture
def on_standin(monkeypatch, standin_lib):
    standin.use(monkeypatch, "lstm_cell_batched", standin_lib)


def layer_case(B, H, seed, L=2):
    r"""One layer's operands at hidden size ``H`` (input ``H``, as every
    layer of the port's stacks), U(+-1/sqrt(H)) weights, and output states
    ``[L, B, H]`` filled with a sentinel."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) / H ** 0.5

    ops = dict(x=torch.randn(B, H, generator=g),
               h=torch.randn(B, H, generator=g),
               c=torch.randn(B, H, generator=g), w_ih=u(4 * H, H),
               w_hh=u(4 * H, H), b_ih=u(4 * H), b_hh=u(4 * H))
    outs = (torch.full((L, B, H), 7.0), torch.full((L, B, H), -7.0))
    return ops, outs


def launch(ops, outs, layer, library=False):
    run = LC._lstm_cell_library if library else LC._launch
    run(**ops, h_out=outs[0], c_out=outs[1], layer=layer)


_RUNS = {}


def run_case(B, H, library):
    r"""``(operands, outputs)`` of one call into row 1, kept for the
    module (a full-width 64-row launch takes seconds on the host)."""
    key = (B, H, library)
    if key not in _RUNS:
        ops, outs = layer_case(B, H, seed=H + B)
        launch(ops, outs, 1, library)
        _RUNS[key] = ops, outs
    return _RUNS[key]


@pytest.mark.parametrize("library", [False, True],
                         ids=["products", "library"])
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("H", WIDTHS)
def test_standin_matches_plain(on_standin, H, B, library):
    ops, (h_out, c_out) = run_case(B, H, library)
    h_want, c_want = LC.lstm_cell_plain(**ops)
    np.testing.assert_allclose(h_out[1].numpy(), h_want.numpy(), atol=ATOL)
    np.testing.assert_allclose(c_out[1].numpy(), c_want.numpy(), atol=ATOL)
    assert (h_out[0] == 7.0).all() and (c_out[0] == -7.0).all()


@pytest.mark.parametrize("B, run, launches", [
    (70, LC._launch, 1), (LC.ROWS_DIRECT, LC._lstm_cell_cuda, 1),
    (LC.ROWS_DIRECT + 6, LC._lstm_cell_cuda, 0)],
    ids=["kernel", "products", "library"])
def test_standin_writes_one_row(on_standin, B, run, launches):
    r"""Each layer of a 3-row state written in turn, at a width whose tiles
    straddle x and h (K_in = H = 20 in one 40-deep tile): after each call
    its row holds the plain version's values and every row not yet written
    its sentinel. The kernel alone at 70 rows (two row tiles, the second
    6 rows of 64); the operator's CUDA implementation, one launch a call up
    to ``ROWS_DIRECT`` rows and ``torch.lstm_cell`` above it."""
    ops, outs = layer_case(B, 20, seed=5, L=3)
    want = LC.lstm_cell_plain(**ops)
    for layer in range(3):
        before = LC.LAUNCHES
        run(**ops, h_out=outs[0], c_out=outs[1], layer=layer)
        assert LC.LAUNCHES - before == launches
        for out, w, sentinel in zip(outs, want, (7.0, -7.0)):
            np.testing.assert_allclose(out[layer].numpy(), w.numpy(),
                                       atol=ATOL)
            assert (out[layer + 1:] == sentinel).all()


@pytest.mark.parametrize("H", WIDTHS)
def test_standin_row_bits_do_not_depend_on_batch(on_standin, H):
    r"""Rows 0, 37 and 63 of a 64-row launch (64 rows a block) bit for bit
    the same row launched alone (8 rows a block, 7 of them idle): each
    output is summed in an order fixed by H."""
    ops, (h64, c64) = run_case(64, H, False)
    for row in (0, 37, 63):
        one = {k: (v[row:row + 1].clone() if k in ("x", "h", "c") else v)
               for k, v in ops.items()}
        outs = (torch.zeros(2, 1, H), torch.zeros(2, 1, H))
        launch(one, outs, 1)
        assert torch.equal(outs[0][1, 0], h64[1, row])
        assert torch.equal(outs[1][1, 0], c64[1, row])


@pytest.mark.parametrize("B", [5, 70], ids=["products", "library"])
def test_standin_stack_step_takes_strided_state(on_standin, monkeypatch, B):
    r"""``rnn_step_cells`` with the operator's CUDA implementation over the
    host build (the kernel up to ``ROWS_DIRECT`` rows, ``torch.lstm_cell``
    above) from a strided state, as the IMU
    re-init's ``init_net_apply`` leaves one: the rows reach the kernel
    contiguous and the new state comes back contiguous, within ``ATOL`` of
    ``rnn_step``."""
    from robustcap_tpu_torch.nn.rnn import init_rnn_params, rnn_step
    monkeypatch.setattr(torch.ops.robustcap, "lstm_cell", LC._lstm_cell_cuda)
    g = torch.Generator().manual_seed(B)
    p = init_rnn_params(g, 72, 69, 24)
    x = torch.randn(B, 72, generator=g)
    hc = torch.randn(B, 2, 2, 24, generator=g)
    state = tuple(torch.movedim(hc[:, k], 1, 0) for k in range(2))
    assert not state[0][0].is_contiguous()
    got = LC.rnn_step_cells(p, x, state)
    want = rnn_step(p, x, state)
    assert got[1][0].is_contiguous() and got[1][1].is_contiguous()
    for g_, w in zip((got[0],) + got[1], (want[0],) + want[1]):
        np.testing.assert_allclose(g_.numpy(), w.numpy(), atol=ATOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_lstm_cell_opcheck(layer):
    r"""``torch.library.opcheck`` on ``robustcap::lstm_cell`` (CPU
    implementation) at B=3, H=24: the schema's two written outputs and
    nothing else written, the fake, tracing; the call writes the plain
    version's values into its row."""
    ops, outs = layer_case(3, 24, seed=layer)
    args = tuple(ops.values()) + outs + (layer,)
    result = torch.library.opcheck(torch.ops.robustcap.lstm_cell.default,
                                     args)
    assert set(result.values()) == {"SUCCESS"}, result
    torch.ops.robustcap.lstm_cell(*args)
    h_want, c_want = LC.lstm_cell_plain(**ops)
    assert torch.equal(outs[0][layer], h_want)
    assert torch.equal(outs[1][layer], c_want)


def test_plan_by_width():
    r"""128 blocks at the main path's widths; the fewest rows a block that
    cover B; a width the kernel does not take raises."""
    assert [LC.lstm_cell_plan(64, H)[0] for H in WIDTHS] == [4, 8, 10]
    assert [LC.lstm_cell_plan(B, 512)[1] for B in (1, 8, 9, 33, 64, 2048)] \
        == [1, 1, 2, 8, 8, 8]
    with pytest.raises(ValueError, match="multiple of 4"):
        LC.lstm_cell_plan(64, 30)
