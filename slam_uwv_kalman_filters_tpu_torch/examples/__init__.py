"""Runnable examples of the port (``python -m slam_uwv_kalman_filters_tpu_torch.examples.<name>``)."""
