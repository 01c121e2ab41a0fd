from repro_torch.optim.adamw import (adamw_init, adamw_update, global_norm,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
