from portbench.readers import roofline_pct


def read(trace):
    return roofline_pct(trace, "segment_sum.cu", "k4_least_s")
