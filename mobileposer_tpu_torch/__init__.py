"""MobilePoser on PyTorch and CUDA for NVIDIA Hopper (H100).

A port of `mobileposer_tpu` that runs the exact multi-stream streaming
path (`models.net.MobilePoserNet.forward_online_sequence_batched`), the
pose evaluation (`cli.evaluate`, `evaluation.evaluate_pose`: offline
ragged batches and the ONLINE protocol) and single-device training
(`cli.train`, `train.TrainingManager`) with hand-written CUDA kernels for
the LSTM layer scans and their training forward and backward
(`ops/csrc/`). It imports neither JAX nor the
JAX package; the layout mirrors `mobileposer_tpu` module for module so
each counterpart is easy to find.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version, which is what the parity tests compare against the JAX package.
"""
