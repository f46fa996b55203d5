from repro_torch.kernels.zones_pairs.ops import (pair_count_masked,
                                                 pair_hist_masked)
