"""The plain reference of the bloom build (CRT_DO_BLOOM): plain torch, a
copy of the port's plain bloom path as it stood when the bloom cell was
defined.  The stages the bloom build leaves as they are (the encoder with
its smaller picture, the noise, the vsync search, the line scan, the
stacked row placement) are those of the frozen reference
(``crt_bench/reference``); the stages bloom adds are here.  It imports
nothing of ``ntsc_crt_tpu_torch``, ``ntsc_crt_tpu`` or JAX."""
