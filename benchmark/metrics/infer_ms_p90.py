"""The 90th percentile of every frame's time in the window, from its call
to its argmax label map on the host (host clock)."""
import statistics


def read(res):
    lat = res["window"].latencies_ms
    if res["trace"] is not None or len(lat) < 10:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
