"""Host-side native runtime of the port (the ``ps/`` package of the JAX package)."""
