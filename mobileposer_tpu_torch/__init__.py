"""MobilePoser on PyTorch and CUDA for NVIDIA Hopper (H100).

A port of `mobileposer_tpu` that runs the exact multi-stream streaming
path (`models.net.MobilePoserNet.forward_online_sequence_batched`) and
carry-mode streaming (`models.streaming`), the multi-stream pose server
(`cli.serve`, `stream.PoseServer`), the pose evaluation (`cli.evaluate`,
`evaluation.evaluate_pose`: offline ragged batches and the ONLINE
protocol) and training (`cli.train`, `train.TrainingManager`), on one
card or data-parallel over several (`parallel/`: sharded evaluation,
streaming and serving in one process, training one process per card),
with hand-written CUDA kernels for the LSTM layer scans and their
training forward and backward (`ops/csrc/`). It imports neither JAX nor the
JAX package; the layout mirrors `mobileposer_tpu` module for module so
each counterpart is easy to find.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version, which is what the parity tests compare against the JAX package.
"""
