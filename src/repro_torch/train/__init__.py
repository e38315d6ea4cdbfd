"""The training step: state, init and the step builder."""

from repro_torch.train.step import (TrainState, init_state, loss_and_grads,
                                    make_train_step)

__all__ = ["TrainState", "init_state", "loss_and_grads", "make_train_step"]
