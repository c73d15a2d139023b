"""Optimizers over parameter dicts (fp32 Adam for the FedAdam server)."""
