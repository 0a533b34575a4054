from .train_step import EvalStep, TrainStep  # noqa: F401
