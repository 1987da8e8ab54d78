"""The port's ragged-batch LSTM core against the JAX package, on the CPU.

The plain versions of the masked CUDA kernels (what their wrappers run on
a CPU tensor) are held to the Pallas kernel they replace,
`lstm_layer_masked_pallas`, run in interpret mode as tests/test_pallas.py
runs it, and to the JAX package's masked `_lstm_scan`; `_reverse_by_length`
and `rnn_apply` with `lengths` are held to theirs. Inputs are made with
numpy from a seed and handed to both packages.

Tolerances: 1e-6 for one masked layer (the same float32 arithmetic in the
same order, up to the matmul's summation order), exact for the reversal
(a gather), 2e-5 for the RNN block (two layers plus linears, the pin
tests/test_torch_lstm.py uses).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.nn import LSTMConfig as JaxLSTMConfig
from mobileposer_tpu.nn import init_rnn
from mobileposer_tpu.nn import rnn_apply as jax_rnn_apply
from mobileposer_tpu.nn.lstm import _lstm_scan as jax_lstm_scan
from mobileposer_tpu.nn.lstm import _reverse_by_length as jax_reverse
from mobileposer_tpu.ops.lstm_pallas import lstm_layer_masked_pallas
from mobileposer_tpu_torch.nn.convert import rnn_block_from_jax
from mobileposer_tpu_torch.nn.lstm import (LSTMConfig, _reverse_by_length,
                                           rnn_apply)
from mobileposer_tpu_torch.ops import lstm_cuda

T, H = 13, 8
LENGTHS = np.array([13, 5, 1, 9, 0], np.int32)     # a full row and an empty one
B = len(LENGTHS)


def _direction(rng):
    """x_proj [T,B,4H], w_hh [H,4H], nonzero h0/c0 [B,H] (float32)."""
    bound = 1.0 / math.sqrt(H)
    return (rng.randn(T, B, 4 * H).astype(np.float32),
            rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32))


def _mask(lengths, T):
    return (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)


def _flat(out):
    return [np.asarray(x) for o in out
            for x in (o if isinstance(o, tuple) else (o,))]


def test_masked_layer_plain_matches_pallas_and_scan():
    x_proj, w_hh, h0, c0 = _direction(np.random.RandomState(0))
    mask = _mask(LENGTHS, T)
    jargs = tuple(map(jnp.asarray, (x_proj, w_hh, h0, c0, mask)))
    want_pallas = lstm_layer_masked_pallas(*jargs, interpret=True)
    want_scan = jax_lstm_scan(*jargs)
    got = lstm_cuda.lstm_layer_masked(
        *map(torch.from_numpy, (x_proj, w_hh, h0, c0, mask)))
    for want in (want_pallas, want_scan):
        for g, w in zip(_flat(got), _flat(want)):
            np.testing.assert_allclose(g, w, atol=1e-6)
    ys, (h_t, c_t) = got
    assert np.all(ys.numpy()[mask == 0] == 0.0)      # exact zeros
    # the empty row keeps its initial carry
    np.testing.assert_array_equal(h_t[4].numpy(), h0[4])
    np.testing.assert_array_equal(c_t[4].numpy(), c0[4])


def test_bilstm_masked_plain_matches_two_pallas_directions():
    """Both directions share the mask: the backward input is reversed by
    length, so each row's valid frames lead in both."""
    rng = np.random.RandomState(1)
    (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = _direction(rng), _direction(rng)
    mask = _mask(LENGTHS, T)
    got = lstm_cuda.bilstm_layer_masked(*map(torch.from_numpy, (
        xf, xb, wf, wb, h0f, c0f, h0b, c0b, mask)))
    want_f = lstm_layer_masked_pallas(*map(jnp.asarray, (xf, wf, h0f, c0f,
                                                         mask)),
                                      interpret=True)
    want_b = lstm_layer_masked_pallas(*map(jnp.asarray, (xb, wb, h0b, c0b,
                                                         mask)),
                                      interpret=True)
    ys_f, ys_b, hc_f, hc_b = got
    for g, w in zip(_flat((ys_f, hc_f)) + _flat((ys_b, hc_b)),
                    _flat(want_f) + _flat(want_b)):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_reverse_by_length_matches_jax_and_is_an_involution():
    x = np.random.RandomState(2).randn(T, B, 3).astype(np.float32)
    xt, lt = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    got = _reverse_by_length(xt, lt)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_reverse(jnp.asarray(x),
                                            jnp.asarray(LENGTHS))))
    np.testing.assert_array_equal(_reverse_by_length(got, lt).numpy(), x)
    # the padded tail stays in place; without lengths it is a flip
    np.testing.assert_array_equal(got.numpy()[5:, 1], x[5:, 1])
    np.testing.assert_array_equal(_reverse_by_length(xt, None).numpy(),
                                  x[::-1])


@pytest.mark.parametrize("bidirectional", [True, False])
def test_rnn_apply_with_lengths_matches_jax(bidirectional):
    jcfg = JaxLSTMConfig(12, 7, 16, bidirectional=bidirectional)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_rnn(jax.random.PRNGKey(3), jcfg))
    cfg = LSTMConfig(12, 7, 16, bidirectional=bidirectional)
    block = rnn_block_from_jax(tree, cfg, "cpu")
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, 12).astype(np.float32)
    n = cfg.n_layers * (2 if bidirectional else 1)
    h0c0 = tuple((rng.randn(n, B, 16) * 0.3).astype(np.float32)
                 for _ in range(2))
    y_j, (h_j, c_j) = jax_rnn_apply(tree, jcfg, jnp.asarray(x),
                                    jnp.asarray(LENGTHS),
                                    h0c0=tuple(map(jnp.asarray, h0c0)))
    y_t, (h_t, c_t) = rnn_apply(block, cfg, torch.from_numpy(x),
                                torch.from_numpy(LENGTHS),
                                h0c0=tuple(map(torch.from_numpy, h0c0)))
    for g, w in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_masked_wrappers_reject_bad_masks_and_lengths():
    x_proj, w_hh, h0, c0 = map(torch.from_numpy,
                               _direction(np.random.RandomState(5)))
    mask = torch.from_numpy(_mask(LENGTHS, T))
    with pytest.raises(ValueError, match="mask must be float32"):
        lstm_cuda.lstm_layer_masked(x_proj, w_hh, h0, c0, mask.double())
    with pytest.raises(ValueError, match="mask must be"):
        lstm_cuda.lstm_layer_masked(x_proj, w_hh, h0, c0, mask[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.bilstm_layer_masked(x_proj, x_proj, w_hh, w_hh, h0, c0,
                                      h0, c0, mask.t().contiguous().t())
    cfg = LSTMConfig(12, 7, 16)
    block = rnn_block_from_jax(
        jax.tree_util.tree_map(np.asarray, init_rnn(
            jax.random.PRNGKey(6), JaxLSTMConfig(12, 7, 16))), cfg, "cpu")
    x = torch.zeros(2, 5, 12)
    with pytest.raises(ValueError, match=r"lengths must lie in \[0, 5\]"):
        rnn_apply(block, cfg, x, torch.tensor([5, 6]))
    with pytest.raises(ValueError, match="lengths must be integers"):
        rnn_apply(block, cfg, x, torch.tensor([5.0, 3.0]))
    assert all(n == 0 for n in lstm_cuda.launches.values())
