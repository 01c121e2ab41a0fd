from repro_torch.optim.adamw import (adamw_init, adamw_update, global_norm,
                                     clip_by_global_norm)
