from repro_torch.training.optimizer import (
    OptSettings,
    adamw_init,
    adamw_update,
    opt_state_shapes,
)
