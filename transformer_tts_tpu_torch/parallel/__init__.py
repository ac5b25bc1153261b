"""Data-parallel training and sequence-parallel attention over
``torch.distributed`` process groups (the port of
transformer_tts_tpu/parallel/)."""

from transformer_tts_tpu_torch.parallel.mesh import (  # noqa: F401
    check_local_batch, data_parallel, init_distributed, process_count,
    process_index, set_norm_group)
from transformer_tts_tpu_torch.parallel.sp import (  # noqa: F401
    sequence_parallel_attention)
