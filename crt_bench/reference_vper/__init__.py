"""The plain reference of the encoders with a carrier table a vertical
phase class (SNES, TEMPLATE, PV1K): plain torch in int32, a copy of the
port's plain ``modulate_vper`` as it stood when the PV1K cell was defined.
The decoder, the noise, the vsync search, the line scan and the row
placement are those of the frozen reference (``crt_bench/reference``),
which takes 5-sample chroma.  It imports nothing of ``ntsc_crt_tpu_torch``,
``ntsc_crt_tpu`` or JAX."""
