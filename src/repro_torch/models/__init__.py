from repro_torch.models.api import (init_model, forward, prefill, decode_step,
                                    make_decode_cache, dummy_batch)
from repro_torch.models.cnn import (CNNConfig, apply_cnn, apply_cnn_fast,
                                    cnn_pool, init_cnn)
