from repro_torch.training.state import (abstract_state, init_state,
                                        make_bucket_plan)
from repro_torch.training.step import make_train_step
