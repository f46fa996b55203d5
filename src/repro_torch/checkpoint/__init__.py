from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.checkpoint.integrity import (DEFAULT_CHUNK, chunk_checksums,
                                              verify)
