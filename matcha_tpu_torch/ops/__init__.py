"""The port's ops, as ``matcha_tpu.ops`` exports them: MAS (the CUDA
kernel's wrapper and the host search) and the sequence math. Importing
the package builds nothing."""

from matcha_tpu_torch.ops.mas import maximum_path, maximum_path_numpy  # noqa: F401
from matcha_tpu_torch.ops.seq import (  # noqa: F401
    denormalize,
    duration_loss,
    fix_len_compatibility,
    generate_path,
    normalize,
    sequence_mask,
)
