"""Device ms a step of the work launched inside the port's
ntsc.modulate.skeleton spans: the vper encoder's skeleton laid over the
whole field and its burst stored on every video row."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.modulate.skeleton")
