from repro_torch.serve.engine import (make_prefill_step, make_decode_step,
                                      ServeEngine)
