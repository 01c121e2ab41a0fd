from repro_torch.checkpoint.checkpointer import (save_checkpoint,
                                                 load_checkpoint, latest_step,
                                                 latest_steps,
                                                 serialize_state,
                                                 deserialize_state,
                                                 AsyncCheckpointer)
