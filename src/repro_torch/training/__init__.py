"""Training substrate (PyTorch): optimizer, step builder,
checkpointing, FT. Port of ``src/repro/training``."""
from .checkpoint import (AsyncCheckpointer, latest_step, prune_checkpoints,
                         restore_checkpoint, save_checkpoint)
from .compression import compress_with_feedback, compressed_psum
from .data import DataConfig, SyntheticLM
from .fault_tolerance import (Heartbeat, NodeFailure, StragglerDetector,
                              run_with_recovery)
from .optimizer import AdamWConfig, adamw_update, init_opt_state, schedule
from .train_step import init_train_state, make_train_step
