from repro_torch.models.cnn import (CNNConfig, apply_cnn, apply_cnn_fast,
                                    cnn_pool, init_cnn)
