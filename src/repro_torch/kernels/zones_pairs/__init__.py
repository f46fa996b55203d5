from repro_torch.kernels.zones_pairs.ops import (pair_count, pair_count_masked,
                                                 pair_hist, pair_hist_masked)
