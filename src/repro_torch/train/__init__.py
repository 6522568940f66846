"""Training: the optimizer (`train.optimizer`) and the step builders
(`train.step`: the train step, and the prefill and serve steps)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import (StepOptions, build_prefill_step,
                                    build_serve_step, build_train_step,
                                    init_state, make_inputs)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "StepOptions",
           "build_train_step", "build_prefill_step", "build_serve_step",
           "make_inputs", "init_state"]
