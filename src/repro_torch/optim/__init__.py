from repro_torch.optim.optimizers import opt_init, opt_update, apply_updates
from repro_torch.optim.schedule import warmup_cosine
