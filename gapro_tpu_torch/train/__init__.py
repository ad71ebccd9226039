from .state import TrainState, cosine_lr_after_step, create_train_state
from .step import make_train_step

__all__ = ["TrainState", "create_train_state", "cosine_lr_after_step", "make_train_step"]
