from repro_torch.serving.engine import (Request, ServeEngine,
                                        make_decode_step, make_prefill_step,
                                        rank_part)
from repro_torch.serving.mr_service import MRQueryService, MRRequest
