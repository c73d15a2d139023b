"""``python -m repro_torch.fed [--device cpu|cuda]`` -- the tiny end-to-end
cohort smoke (8 clients, 2 rounds, Dirichlet partition), as
``python -m repro.fed``."""

from repro_torch.fed.engine import _smoke_main

if __name__ == "__main__":
    _smoke_main()
