from repro_torch.optim.optimizers import Optimizer, adamw, sgd
