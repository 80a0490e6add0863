"""paddle_tpu_torch.tools — measurement scripts run on the card."""
