from repro_torch.checkpoint.ckpt import (load_checkpoint, load_checkpoint_flat,
                                         save_checkpoint)
