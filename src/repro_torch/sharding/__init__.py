"""Sharding rules and placement over a ``DeviceMesh`` (twin of
``repro/sharding/``)."""
