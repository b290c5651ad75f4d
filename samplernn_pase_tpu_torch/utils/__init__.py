"""Host-side helpers: the skip marker of the measured entry points,
profiling and debug checks, mirroring ``samplernn_pase_tpu.utils``."""

from samplernn_pase_tpu_torch.utils.debug import checked  # noqa: F401
