"""Device milliseconds of device-to-host copies a profiled synthesis call:
the results on their way to the caller (``Synthesizer.to_host``) and the
style wavs' mels (``DeviceFeatureExtractor``)."""


def read(layer):
    t = layer.get("trace")
    if not t or not t["class_s"].get("memcpy_DtoH"):
        return None
    return 1e3 * t["class_s"]["memcpy_DtoH"] / layer["traced_calls"]
