"""Models of the port: the recsys zoo (repro_torch.models.recsys)."""
