"""Train-step builders and the pod collective (port of ``repro.runtime``)."""
