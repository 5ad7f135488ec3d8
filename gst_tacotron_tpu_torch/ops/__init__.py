"""Hopper kernels of the port, one module each, with their plain PyTorch twins.

  gru.py     K1  gru_scan              <- gst_tacotron_tpu/ops/gru_pallas.py
  refenc.py  K2  refenc_stack          <- gst_tacotron_tpu/ops/refenc_pallas.py
  stft.py    K3  stft_features         <- gst_tacotron_tpu/ops/stft_pallas.py
             K3′ stft_features_fused   <- the same file, frequency-split form
             K3″ stft_features_frames  <- the same file, pre-framed form
  decode.py  K4  decode_scan           <- gst_tacotron_tpu/ops/decode_pallas.py
  wavernn.py K5  wavernn_sample        <- gst_tacotron_tpu/ops/wavernn_pallas.py

``philox.py`` is the kernels' random stream for their plain versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors. No kernel has a backward: on the card a
wrapper raises when grad mode is on and an input requires grad
(``build.refuse_grad``), so training takes the plain versions, which stay
differentiable.
"""


def all_kernels():
    """Every CUDA kernel of the port, in K1..K5 order (K3′, K3″ after K3)."""
    from . import decode, gru, refenc, stft, wavernn

    return [gru.KERNEL, refenc.KERNEL, stft.KERNEL, stft.FUSED_KERNEL, stft.FRAMES_KERNEL,
            decode.KERNEL, wavernn.KERNEL]


def launch_counts():
    """Launches of every kernel by name, and of each named branch as
    ``name:branch`` (K4's ``decode_scan:location_sensitive``)."""
    counts = {}
    for k in all_kernels():
        counts[k.name] = k.launches
        counts.update({f"{k.name}:{b}": n for b, n in k.branch_launches.items()})
    return counts


def reset_launch_counts() -> None:
    for k in all_kernels():
        k.launches = 0
        k.branch_launches = dict.fromkeys(k.branch_launches, 0)
