"""K2 decode_rows's share of its roofline, in %."""

from crt_bench.readers import roofline_pct


def read(tr):
    return roofline_pct(tr, "decode_rows")
