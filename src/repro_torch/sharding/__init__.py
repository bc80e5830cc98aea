"""Logical-axis sharding rules on a torch ``DeviceMesh`` (the port of
``repro.sharding``)."""
