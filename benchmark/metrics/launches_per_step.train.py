"""Device kernels a profiled train step (memcpys and memsets not counted):
a count, which repeats exactly while the step's code stays the same."""


def read(layer):
    t = layer.get("trace")
    if not t or not t["kernels"]:
        return None
    return t["kernels"] / layer["traced_calls"]
