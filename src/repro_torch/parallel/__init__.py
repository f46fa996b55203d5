from repro_torch.parallel.sharding import (AxisRules, batch_axes, batch_size,
                                           batch_spec, make_rules)
