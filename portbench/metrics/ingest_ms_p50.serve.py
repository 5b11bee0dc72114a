from portbench.readers import span_p50_ms


def read(trace):
    return span_p50_ms(trace, "ingest")
