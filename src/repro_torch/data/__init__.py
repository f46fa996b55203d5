from repro_torch.data.pipeline import (
    ArraySplits, MemmapCatalogSplits, MemmapTokens, Pipeline, PipelineConfig,
    Prefetcher, SplitSource, SyntheticCatalogSplits, SyntheticTokens,
    TokenBlockSplits,
)
from repro_torch.data import sky
