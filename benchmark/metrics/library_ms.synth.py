"""Device milliseconds a profiled synthesis call of every kernel that is
none of the port's hand kernels and no memcpy, memset or NCCL kernel:
Griffin-Lim's products and elementwise work, the encoder's and post-net's
dense layers, the extractor's framing."""


def read(layer):
    t = layer.get("trace")
    if not t or not t["class_s"].get("library"):
        return None
    return 1e3 * t["class_s"]["library"] / layer["traced_calls"]
