from .optim import Optimizer, build_optimizer
from .schedule import schedule_horizon, warmup_cosine_sq_schedule
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_multistep, make_train_step

__all__ = ["Optimizer", "TrainState", "build_optimizer", "create_train_state",
           "make_eval_step", "make_train_multistep", "make_train_step", "schedule_horizon",
           "warmup_cosine_sq_schedule"]
