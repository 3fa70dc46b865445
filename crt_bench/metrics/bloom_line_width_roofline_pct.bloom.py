"""bloom_line_width's share of its roofline, in %."""

from crt_bench.readers_bloom import roofline_pct


def read(tr):
    return roofline_pct(tr, "bloom_line_width")
