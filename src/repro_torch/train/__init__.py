"""Training: the optimizer (`train.optimizer`) and the train step
(`train.step.build_train_step`)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import StepOptions, build_train_step, init_state

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "StepOptions",
           "build_train_step", "init_state"]
