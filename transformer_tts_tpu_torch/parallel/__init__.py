"""Data, tensor and sequence parallelism over ``torch.distributed``
process groups (the port of transformer_tts_tpu/parallel/)."""

from transformer_tts_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows, check_local_batch, data_coordinate, data_group,
    data_parallel, hierarchical_hook, init_distributed, make_mesh,
    make_multislice_mesh, process_count, process_index, set_norm_group)
from transformer_tts_tpu_torch.parallel.sp import (  # noqa: F401
    sequence_parallel_attention)
from transformer_tts_tpu_torch.parallel.tp import (  # noqa: F401
    gather_state_dict, param_shardings, tensor_parallel)
