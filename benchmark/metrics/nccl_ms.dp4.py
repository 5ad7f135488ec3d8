"""Device milliseconds of NCCL kernels a profiled call on rank 0's card:
the outputs' all-gather over the data axis (and the harness's one-element
broadcast of whether the window is open)."""


def read(layer):
    t = layer.get("trace")
    if not t or not t["class_s"].get("nccl"):
        return None
    return 1e3 * t["class_s"]["nccl"] / layer["traced_calls"]
