"""LSTM blocks and weight conversion."""

from mobileposer_tpu_torch.nn.lstm import (  # noqa: F401
    LSTMConfig,
    RNNBlock,
    cast_params,
    lstm_cell_step,
    lstm_forward,
    rnn_apply,
    rnn_zero_state,
)
