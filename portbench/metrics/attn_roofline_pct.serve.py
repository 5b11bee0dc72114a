from portbench.readers import roofline_pct


def read(trace):
    return roofline_pct(trace, "attention_fused.cu", "attn_least_s")
