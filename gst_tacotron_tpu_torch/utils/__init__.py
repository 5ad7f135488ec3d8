"""Utilities of the port (counterpart of ``gst_tacotron_tpu/utils``)."""
