"""Training: the optimizer (`train.optimizer`) and the train step
(`train.step.build_train_step`)."""
