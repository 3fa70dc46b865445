"""The plain reference the benchmark holds the port to: plain torch and
numpy, frozen from the port's plain path when the benchmark was defined.
It imports nothing of ``ntsc_crt_tpu_torch``, ``ntsc_crt_tpu`` or JAX, and
works out every table and state it needs itself."""
