"""The port's LSTM core against the JAX package, on the CPU.

The plain versions of the two CUDA kernels (what their wrappers run on a
CPU tensor) are held to the Pallas kernels they replace, run in interpret
mode as tests/test_pallas.py runs them; the multi-layer forward and the
RNN block are held to the JAX `rnn_apply` / `lstm_forward`. Inputs are made
with numpy from a seed and handed to both packages.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.nn import LSTMConfig as JaxLSTMConfig
from mobileposer_tpu.nn import init_rnn
from mobileposer_tpu.nn import lstm_forward as jax_lstm_forward
from mobileposer_tpu.nn import rnn_apply as jax_rnn_apply
from mobileposer_tpu.ops.lstm_pallas import (bilstm_layer_pallas,
                                             lstm_layer_pallas)
from mobileposer_tpu_torch.nn.convert import rnn_block_from_jax
from mobileposer_tpu_torch.nn.lstm import LSTMConfig, lstm_forward, rnn_apply
from mobileposer_tpu_torch.ops import lstm_cuda

T, B, H = 9, 4, 16


def _direction(rng):
    """x_proj [T,B,4H], w_hh [H,4H], nonzero h0/c0 [B,H] (float32)."""
    bound = 1.0 / math.sqrt(H)
    return (rng.randn(T, B, 4 * H).astype(np.float32),
            rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32))


def _flat(out):
    return [np.asarray(x) for o in out
            for x in (o if isinstance(o, tuple) else (o,))]


def test_lstm_layer_plain_matches_pallas():
    x_proj, w_hh, h0, c0 = _direction(np.random.RandomState(0))
    want = lstm_layer_pallas(jnp.asarray(x_proj), jnp.asarray(w_hh),
                             jnp.asarray(h0), jnp.asarray(c0), interpret=True)
    got = lstm_cuda.lstm_layer(*map(torch.from_numpy, (x_proj, w_hh, h0, c0)))
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_bilstm_layer_plain_matches_pallas():
    rng = np.random.RandomState(1)
    (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = _direction(rng), _direction(rng)
    args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b)
    want = bilstm_layer_pallas(*map(jnp.asarray, args), interpret=True)
    got = lstm_cuda.bilstm_layer(*map(torch.from_numpy, args))
    assert len(_flat(got)) == len(_flat(want)) == 6
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g, w, atol=1e-5)


def _block(cfg_args, bidirectional, seed):
    jcfg = JaxLSTMConfig(*cfg_args, bidirectional=bidirectional)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_rnn(jax.random.PRNGKey(seed), jcfg))
    cfg = LSTMConfig(*cfg_args, bidirectional=bidirectional)
    return jcfg, tree, cfg, rnn_block_from_jax(tree, cfg, "cpu")


def _h0c0(rng, cfg, batch):
    n = cfg.n_layers * (2 if cfg.bidirectional else 1)
    return tuple((rng.randn(n, batch, cfg.n_hidden) * 0.3).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_rnn_apply_matches_jax(bidirectional):
    jcfg, tree, cfg, block = _block((12, 7, 16), bidirectional, seed=2)
    rng = np.random.RandomState(3)
    x = rng.randn(3, 11, 12).astype(np.float32)
    h0c0 = _h0c0(rng, cfg, 3)
    y_j, (h_j, c_j) = jax_rnn_apply(tree, jcfg, jnp.asarray(x),
                                    h0c0=tuple(map(jnp.asarray, h0c0)))
    y_t, (h_t, c_t) = rnn_apply(block, cfg, torch.from_numpy(x),
                                h0c0=tuple(map(torch.from_numpy, h0c0)))
    for g, w in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm_forward_time_major_matches_jax(bidirectional):
    jcfg, tree, cfg, block = _block((16, 5, 16), bidirectional, seed=4)
    rng = np.random.RandomState(5)
    x = rng.randn(10, 2, 16).astype(np.float32)          # [T, B, D]
    h0c0 = _h0c0(rng, cfg, 2)
    y_j, (h_j, c_j) = jax_lstm_forward(
        tree["lstm"], jnp.asarray(x), h0c0=tuple(map(jnp.asarray, h0c0)),
        bidirectional=bidirectional, time_major=True)
    y_t, (h_t, c_t) = lstm_forward(
        block.lstm, torch.from_numpy(x),
        h0c0=tuple(map(torch.from_numpy, h0c0)),
        bidirectional=bidirectional, time_major=True)
    assert y_t.shape == (10, 2, 16 * (2 if bidirectional else 1))
    for g, w in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_rnn_apply_chunked_carried_state():
    """Chunks with the carry threaded equal one full-length pass."""
    jcfg, tree, cfg, block = _block((12, 7, 16), False, seed=6)
    x = np.random.RandomState(7).randn(1, 20, 12).astype(np.float32)
    y_full, _ = jax_rnn_apply(tree, jcfg, jnp.asarray(x))
    hc = None
    chunks = []
    for t0 in range(0, 20, 5):
        y, hc = rnn_apply(block, cfg, torch.from_numpy(x[:, t0:t0 + 5]),
                          h0c0=hc)
        chunks.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(chunks, 1), np.asarray(y_full),
                               atol=2e-5)


def test_wrappers_reject_what_the_kernel_does_not_take():
    x_proj, w_hh, h0, c0 = map(torch.from_numpy,
                               _direction(np.random.RandomState(8)))
    with pytest.raises(ValueError, match="float32"):
        lstm_cuda.lstm_layer(x_proj.double(), w_hh, h0, c0)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_layer(x_proj, w_hh, h0.t().contiguous().t(), c0)
    with pytest.raises(ValueError, match="w_hh"):
        lstm_cuda.lstm_layer(x_proj, w_hh[:-1], h0, c0)
    with pytest.raises(ValueError, match="shapes differ"):
        lstm_cuda.bilstm_layer(x_proj, x_proj[:-1].contiguous(), w_hh, w_hh,
                               h0, c0, h0, c0)
    assert set(lstm_cuda.launches.values()) == {0}


def test_out_of_slice_options_raise():
    _, _, cfg, block = _block((12, 7, 16), True, seed=9)
    x = torch.zeros(2, 5, 12)
    # 'fused' is in the slice: outside `forward` it computes what 'auto' does
    y_fused, _ = rnn_apply(block, cfg, x + 0.1, backend="fused")
    y_auto, _ = rnn_apply(block, cfg, x + 0.1, backend="auto")
    torch.testing.assert_close(y_fused, y_auto, rtol=0, atol=0)
    # bf16 residuals are in the slice too: they leave the outputs as they
    # are (only what the backward reads is rounded)
    lengths = torch.tensor([5, 3])
    y_res, hc_res = rnn_apply(block, cfg, x + 0.1, lengths=lengths,
                              backend="auto_train_bf16res")
    y_train, hc_train = rnn_apply(block, cfg, x + 0.1, lengths=lengths,
                                  backend="auto_train")
    torch.testing.assert_close(y_res, y_train, rtol=0, atol=0)
    torch.testing.assert_close(hc_res, hc_train, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="not ported"):
        rnn_apply(block, cfg, x, lengths=lengths, backend="xla")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rnn_apply(block, cfg, x.double())
