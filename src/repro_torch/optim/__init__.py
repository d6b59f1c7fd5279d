from repro_torch.optim.optimizers import (Optimizer, adamw, clip_by_global_norm,
                                          clip_scale, constant_schedule,
                                          cosine_schedule, global_norm, sgd)
