"""Host-side helpers: the skip marker of the measured entry points and
profiling, mirroring ``samplernn_pase_tpu.utils``."""
