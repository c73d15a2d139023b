"""The model zoo (port of ``repro.models``): the dense transformer family,
its building blocks, the family dispatch and the sharding rules."""
