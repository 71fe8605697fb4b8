"""CPU crypto reference paths (the TPU kernels are differential-tested against these)."""
