"""Host-side utilities: error channel, C++-compatible formatting, profiling,
checkpoints."""
