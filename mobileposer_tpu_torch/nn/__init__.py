"""LSTM blocks, the RNN with a learned initial state, and weight
conversion."""

from mobileposer_tpu_torch.nn.lstm import (  # noqa: F401
    LSTMConfig,
    RNNBlock,
    cast_params,
    lstm_cell_step,
    lstm_forward,
    rnn_apply,
    rnn_zero_state,
)
from mobileposer_tpu_torch.nn.rnn_with_init import (  # noqa: F401
    RNNWithInit,
    RNNWithInitConfig,
    init_rnn_with_init,
    rnn_with_init_apply,
)
