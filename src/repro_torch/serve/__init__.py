from repro_torch.serve.engine import (decode_batch, make_prefill_step,
                                      make_decode_step, ServeEngine)
