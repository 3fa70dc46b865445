"""K6 place_rows_uniform in its bloom mode's share of its roofline, in %."""

from crt_bench.readers_bloom import roofline_pct


def read(tr):
    return roofline_pct(tr, "place_rows_bloom")
