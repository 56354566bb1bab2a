from repro_torch.train.loop import StragglerMonitor, TrainLoop, make_train_step, value_and_grad  # noqa: F401
