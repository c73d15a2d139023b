"""Launchers (port of ``repro.launch``): the mesh and the train launcher."""
