"""Models of the port: the recsys zoo (repro_torch.models.recsys) and the
dense decoder-only LMs (repro_torch.models.transformer, over layers and
attention)."""
