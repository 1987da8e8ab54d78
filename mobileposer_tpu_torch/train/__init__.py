"""Training layer: train steps on the CUDA training kernels, checkpoints."""

from mobileposer_tpu_torch.train.trainer import (  # noqa: F401
    Checkpointer,
    MODULE_NAMES,
    TrainState,
    TrainingManager,
    combine_weights,
    get_best_checkpoint,
    get_checkpoint_path,
    init_train_state,
    load_combined_weights,
    make_eval_step,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    restore_training_state,
    save_training_state,
)
