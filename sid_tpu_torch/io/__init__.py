"""Host-side IO: mpileup parsing -> dense numpy arrays, and chunked
streaming input."""
