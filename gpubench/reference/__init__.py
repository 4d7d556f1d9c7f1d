"""The plain reference that decides ``correct``: sid's counting and calls in
NumPy. It imports nothing of the port (``sid_tpu_torch``) nor of JAX."""
