from portbench.readers import roofline_pct


def read(trace):
    return roofline_pct(trace, "gru_fused.cu", "gru_least_s")
