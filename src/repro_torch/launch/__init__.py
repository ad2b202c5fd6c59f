"""Meshes, process groups and the launchers (twin of ``repro/launch/``).

Importing this package touches no device and starts no process group: the
functions of ``mesh`` do that when called, and ``serve`` and ``train`` run
under ``python -m``."""
