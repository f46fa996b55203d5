# The paper's primary contribution: balance-aware execution. The Amdahl /
# roofline analysis (amdahl.py, balance.py), priced on the card's own rates,
# the cost model that plans from it (op_census.py, cost_model.py), the
# block quantizer behind the int8 codec and the compressed all-reduce
# (compression.py), and the hierarchical all-reduce over a mesh
# (collectives.py).
from repro_torch.core.amdahl import (
    DATA_SHEET, DeviceSpec, RooflineTerms, cuda_spec, device_spec,
    model_flops_decode, model_flops_prefill, model_flops_train,
)
from repro_torch.core.balance import balance_report, suggest
from repro_torch.core.compression import (
    compress_roundtrip, compressed_psum_1d, dequantize_block, ef_compress,
    psum_1d, quantize_block,
)
from repro_torch.core.collectives import flat_psum, hierarchical_psum_1d
from repro_torch.core.op_census import (
    Collective, OpCensus, census, collective_summary, parse_collectives,
    stage_census,
)
from repro_torch.core.cost_model import (
    BackendProfile, CostModel, StageCost, agree_cost_model,
    backend_fingerprint, calibration_enabled, get_cost_model,
    reset_cost_model,
)
