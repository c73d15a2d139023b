"""Model configurations (port of ``repro.configs``): the ``ModelConfig``
dataclass, the architecture registry and one module a published model,
copied as data from the reference."""
