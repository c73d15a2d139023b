"""The federated cohort round engine, ported to PyTorch (barrier rounds):
partition, scheduler, server_opt and engine."""
