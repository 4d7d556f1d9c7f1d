"""Host-side IO: mpileup parsing -> dense numpy arrays."""
