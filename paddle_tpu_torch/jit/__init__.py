from .train_step import TrainStep  # noqa: F401
