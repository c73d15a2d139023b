"""The model zoo (port of ``repro.models``): the transformer, SSM, hybrid
and audio families, their building blocks, the family dispatch
(``model``), the sharding rules and the backward-interleaved segment
producer (``segment_tap``)."""
