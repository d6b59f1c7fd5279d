"""The HAPFL transformer training step (counterpart of ``repro.train``)."""
from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                    make_hapfl_train_step, make_train_state)
